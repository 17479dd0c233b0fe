"""DAVIS output writer: indexed-palette PNGs in the official eval layout.

Tracks are ranked by lifetime and capped at ``max_tracks``; per frame the
kept instance masks are lifted to the original image dims and condensed
into one uint8 index map where LATER kept instances overwrite earlier ones,
written as ``results/<seq>/00000.png`` with the Pascal-VOC palette. With
``save_visualization`` each frame (re-read from the sequence) is also
written as ``vis/<seq>/00000.jpg`` with every track's mask blended in its
palette colour, as the JAX writer does.

``process_sequence`` works in two steps. First, frame by frame, the
calling thread enqueues the mask resize and the condense (``condense``) on
``device`` and copies the uint8 map into its slot of one host buffer for
the sequence (page-locked and ``non_blocking``, a CUDA event recorded
after it, on a CUDA device), with no synchronisation. Then a pool of
encoder threads writes the PNGs: a worker waits for its frame's event and
saves the map with PIL's default settings, as a serial writer would, so
the bytes do not change; PIL's encoder releases the GIL, so the frames
encode in parallel. The pool has one thread per CPU the process may use,
at most ``ENCODERS``. The call waits for every frame's file before it
returns (or, once the rest are written, raises the first failed frame's
exception, in frame order).

Spans, on the calling thread (a profiler session records only its own):
``writer.resize``, one a frame, is the frame's enqueue; ``writer.encode``,
one a frame, taken in frame order after every frame is enqueued, is the
wait for that frame's file. The counter ``writer.pooled_frames`` counts the
frames written by the pool.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
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
from stemseg_tpu_torch.utils.profiling import count, span
from stemseg_tpu_torch.utils.vis import create_color_map, overlay_mask_on_image

# the most PNG encoder threads a sequence takes: on an 8-core H100 host 4 to 12
# wrote a DAVIS sequence equally fast, 1 and 2 slower (PERF.md, Findings)
ENCODERS = 8


def condense(masks: torch.Tensor) -> torch.Tensor:
    """``[K, H, W]`` bool, 0 < K < 256 -> ``[H, W]`` uint8 index map: n + 1
    where the n-th mask is the last one set, 0 where none is (the max of
    ``(n + 1) * mask[n]``, since n + 1 grows with n)."""
    ids = torch.arange(1, masks.shape[0] + 1, dtype=torch.uint8, device=masks.device)
    return (masks * ids.view(-1, 1, 1)).amax(dim=0)


def _write_png(path: str, index_map: np.ndarray, cmap: np.ndarray, ready) -> None:
    """One frame's PNG, once ``ready`` (its copy's CUDA event, or None) has
    completed."""
    from PIL import Image

    if ready is not None:
        ready.synchronize()
    img = Image.fromarray(index_map)
    img.putpalette(cmap)
    img.save(path)


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
            on_card = labels_dev.device.type == "cuda"
            n_frames = track_labels.shape[0]
            index_maps = torch.empty((n_frames, *image_dims), dtype=torch.uint8,
                                     pin_memory=on_card)
            ready = []  # each frame's copy event (None: the map is on the host already)
            for t in range(n_frames):
                with span("writer.resize"):  # the frame's enqueue
                    event = None
                    if kept:
                        full = masks_to_original_dims(
                            labels_dev[t][None] == kept_dev, mask_scale, image_dims,
                            min_dim, max_dim, self.upscaled_inputs)
                        index_maps[t].copy_(condense(full), non_blocking=on_card)
                        del full  # stream-ordered reuse: its blocks go to the next frame
                        if on_card:
                            event = torch.cuda.Event()
                            event.record(torch.cuda.current_stream(labels_dev.device))
                    else:
                        index_maps[t].zero_()
                    ready.append(event)
            # the encoders start once every frame is enqueued: their GIL hand-offs
            # would slow the enqueue's many short torch calls
            maps = index_maps.numpy()
            workers = min(len(os.sched_getaffinity(0)), ENCODERS)
            with ThreadPoolExecutor(workers, thread_name_prefix="davis-png") as pool:
                written = [pool.submit(_write_png,
                                       os.path.join(seq_results_dir, f"{t:05d}.png"),
                                       maps[t], cmap, ready[t]) for t in range(n_frames)]
                for future in written:
                    with span("writer.encode"):  # the wait for the frame's file
                        future.result()
            count("writer.pooled_frames", n_frames)
            if self.save_visualization:
                self._save_visualizations(sequence, maps)
            return kept

    def _save_visualizations(self, sequence, index_maps: np.ndarray):
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
