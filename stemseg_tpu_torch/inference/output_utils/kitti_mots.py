"""KITTI-MOTS output writer: the official MOTS txt format, then the NMS
filters of ``kitti_mots_postprocessing`` in ``save()``.

Per sequence the ``max_tracks`` tracks with the most pixels are kept,
ordered by ascending lifetime and numbered 1..N. Per frame their masks are
lifted to the original image dims and flattened: where masks overlap, the
pixel goes to the largest ORIGINAL track id (what the reference computes;
its comment speaks of lifetime order). A track's class is the
pixel-majority vote of the argmax semseg over the whole track among the
car (1) and pedestrian (2) classes, car on a tie. Each detection is a line
``frame class*1000+id class height width rle`` of ``results/<id:04d>.txt``.
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
from stemseg_tpu_torch.utils import rle as rle_codec
from stemseg_tpu_torch.utils.device import resolve_device
from stemseg_tpu_torch.utils.profiling import span

CATEGORIES = (1, 2)  # car, pedestrian


class KittiMOTSOutputGenerator:
    def __init__(self, output_dir: str, upscaled_inputs: bool = False,
                 save_visualization: bool = False, device="cuda"):
        """:param upscaled_inputs: labels come at the network input scale
        :param save_visualization: taken from the CLI's ``--save_vis``; this
            writer writes no visualisation (nor does the JAX package's)
        :param device: where the mask resize chain and the class vote run"""
        self.device = resolve_device(device)
        self.results_output_dir = os.path.join(output_dir, "results")
        self.upscaled_inputs = upscaled_inputs

    def process_sequence(self, sequence, track_labels: np.ndarray,
                         instance_pt_counts: Dict[int, int],
                         instance_lifetimes: Dict[int, int],
                         category_masks, mask_scale: int, max_tracks: int,
                         min_dim: int, max_dim: int) -> List[int]:
        """:param category_masks: ``[T, h, w]`` argmax semseg class ids, a
            tensor or an array
        :return: the kept track ids; the n-th is written as track n + 1
        """
        with span("writer.sequence", ident=sequence.id):
            image_dims = tuple(sequence.image_dims)
            kept = select_instances_to_keep(instance_pt_counts, OUTLIER_LABEL, max_tracks)
            if not kept:
                raise ValueError(f"Zero instances detected in sequence: {sequence.id}")
            kept = sorted(kept, key=lambda i: instance_lifetimes[i])

            labels_dev = to_device(track_labels, self.device)
            classes = to_device(category_masks, self.device).long()
            kept_dev = torch.tensor(kept, dtype=torch.int64, device=self.device).view(-1, 1, 1)
            n_cls = max(CATEGORIES) + 1
            votes = torch.zeros((len(kept), n_cls), dtype=torch.int64, device=self.device)
            detections: List[List[Dict]] = [[] for _ in kept]
            for t in range(track_labels.shape[0]):
                with span("writer.resize"):  # the frame's device work and its fetches
                    onehot = labels_dev[t][None] == kept_dev  # [K, h, w]
                    flat = onehot.reshape(len(kept), -1)
                    active = flat.any(dim=1).cpu().numpy()
                    if active.any():
                        cls_onehot = (classes[t].reshape(-1, 1) == torch.arange(
                            n_cls, device=self.device)).float()
                        votes += (flat.float() @ cls_onehot).long()  # exact below 2^24 pixels
                        full = masks_to_original_dims(onehot, mask_scale, image_dims, min_dim,
                                                      max_dim, self.upscaled_inputs)
                        id_map = (full.long() * kept_dev).amax(dim=0).cpu().numpy()
                with span("writer.encode"):  # its host work
                    for k in np.flatnonzero(active):
                        enc = rle_codec.encode((id_map == kept[k]).astype(np.uint8))
                        detections[k].append({"frame_id": t,
                                              "mask": enc["counts"].decode("utf-8")})

            votes = votes.cpu().numpy()
            path = os.path.join(self.results_output_dir, f"{int(sequence.id):04d}.txt")
            os.makedirs(self.results_output_dir, exist_ok=True)
            with open(path, "w") as fh:
                for k, dets in enumerate(detections):
                    category = max(CATEGORIES, key=lambda c: votes[k, c])
                    for d in dets:
                        fh.write(f"{d['frame_id']} {category * 1000 + k + 1} {category} "
                                 f"{image_dims[0]} {image_dims[1]} {d['mask']}\n")
            return kept

    def save(self):
        from stemseg_tpu_torch.inference.output_utils.kitti_mots_postprocessing import (
            postprocess_results,
        )

        with span("writer.save"):
            print("Applying NMS to results...")
            postprocess_results(self.results_output_dir)
