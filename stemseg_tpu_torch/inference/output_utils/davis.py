"""DAVIS output writer: indexed-palette PNGs in the official eval layout.

Tracks are ranked by lifetime and capped at ``max_tracks``; per frame the
kept instance masks are lifted to the original image dims and condensed
into one uint8 index map where LATER kept instances overwrite earlier ones,
written as ``results/<seq>/00000.png`` with the Pascal-VOC palette. With
``save_visualization`` each frame (re-read from the sequence) is also
written as ``vis/<seq>/00000.jpg`` with every track's mask blended in its
palette colour, as the JAX writer does.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from stemseg_tpu_torch.inference.chainer import OUTLIER_LABEL
from stemseg_tpu_torch.inference.output_utils.common import (
    masks_to_original_dims,
    select_instances_to_keep,
    to_device,
)
from stemseg_tpu_torch.utils.device import resolve_device
from stemseg_tpu_torch.utils.profiling import span
from stemseg_tpu_torch.utils.vis import create_color_map, overlay_mask_on_image


class DavisOutputGenerator:
    def __init__(self, output_dir: str, upscaled_inputs: bool = False,
                 save_visualization: bool = False, device="cuda"):
        """:param upscaled_inputs: labels come at the network input scale
        :param save_visualization: also write the frames with the tracks
            overlaid
        :param device: where the mask resize chain runs"""
        self.results_output_dir = os.path.join(output_dir, "results")
        self.vis_output_dir = os.path.join(output_dir, "vis")
        self.upscaled_inputs = upscaled_inputs
        self.save_visualization = save_visualization
        self.device = resolve_device(device)

    def process_sequence(self, sequence, track_labels: np.ndarray,
                         instance_pt_counts: Dict[int, int],
                         instance_lifetimes: Dict[int, int],
                         category_masks, mask_scale: int, max_tracks: int,
                         min_dim: int, max_dim: int) -> List[int]:
        """:param sequence: object with ``id``, ``image_dims`` (h, w) and, for
            ``save_visualization``, ``load_images()``
        :param track_labels: dense [T, h, w] int32 global labels (-1 outlier)
        :param category_masks: unused for DAVIS
        :return: the kept track ids, PNG index n + 1 for the n-th
        """
        from PIL import Image

        if max_tracks >= 256:
            raise ValueError("DAVIS PNGs index at most 255 tracks")
        with span("writer.sequence", ident=sequence.id):
            image_dims = tuple(sequence.image_dims)
            kept = select_instances_to_keep(instance_lifetimes, OUTLIER_LABEL, max_tracks)
            cmap = create_color_map().flatten()
            labels_dev = to_device(track_labels, self.device)
            kept_dev = torch.tensor(kept, dtype=labels_dev.dtype,
                                    device=self.device).view(-1, 1, 1)
            seq_results_dir = os.path.join(self.results_output_dir, str(sequence.id))
            os.makedirs(seq_results_dir, exist_ok=True)
            index_maps = []
            for t in range(track_labels.shape[0]):
                with span("writer.resize"):  # the frame's device work and its fetch
                    full = masks_to_original_dims(
                        labels_dev[t][None] == kept_dev, mask_scale, image_dims,
                        min_dim, max_dim, self.upscaled_inputs).cpu().numpy() if kept else None
                with span("writer.encode"):  # its host work
                    condensed = np.zeros(image_dims, np.uint8)
                    for n in range(len(kept)):  # later kept ids overwrite
                        condensed[full[n]] = n + 1
                    img = Image.fromarray(condensed)
                    img.putpalette(cmap)
                    img.save(os.path.join(seq_results_dir, f"{t:05d}.png"))
                if self.save_visualization:
                    index_maps.append(condensed)
            if self.save_visualization:
                self._save_visualizations(sequence, index_maps)
            return kept

    def _save_visualizations(self, sequence, index_maps: List[np.ndarray]):
        import cv2

        seq_vis_dir = os.path.join(self.vis_output_dir, str(sequence.id))
        os.makedirs(seq_vis_dir, exist_ok=True)
        cmap = create_color_map()
        for t, (image, index_map) in enumerate(zip(sequence.load_images(), index_maps)):
            for n in sorted(set(np.unique(index_map)) - {0}):
                image = overlay_mask_on_image(image, index_map == n, mask_color=cmap[n])
            cv2.imwrite(os.path.join(seq_vis_dir, f"{t:05d}.jpg"), image)

    def save(self):
        """Nothing to gather: the PNGs are written per sequence."""
