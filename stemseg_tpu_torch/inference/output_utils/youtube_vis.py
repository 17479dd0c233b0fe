"""YouTube-VIS output writer: the submission's ``results.json`` and its zip.

Per sequence the ``max_tracks`` longest-lived tracks are kept. Each gets
one RLE mask per frame at the original image dims, a score (its pixel
count over the largest kept track's) and a class: the per-track sum of the
multiclass logits over its pixels, divided by its area, background channel
dropped, softmax, argmax + 1. The masks, areas and logit sums are computed
on ``device``; the RLE strings and the json on the host.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence
from zipfile import ZIP_DEFLATED, ZipFile

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


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - np.max(x))
    return e / e.sum()


class YoutubeVISOutputGenerator:
    def __init__(self, output_dir: str, upscaled_inputs: bool = False,
                 save_visualization: bool = False, device="cuda",
                 sequence_order: Optional[Sequence[str]] = None):
        """:param upscaled_inputs: labels come at the network input scale
        :param save_visualization: taken from the CLI's ``--save_vis``; this
            writer writes no visualisation (nor does the JAX package's)
        :param device: where the mask resize chain and the class vote run
        :param sequence_order: sequence ids in the order ``results.json``
            lists their instances, whatever order the sequences ran in (the
            CLI's ``--data_parallel`` runs them grouped by frame size); None:
            the order they were processed, as the JAX package's writer"""
        self.device = resolve_device(device)
        os.makedirs(output_dir, exist_ok=True)
        self.output_dir = output_dir
        self.upscaled_inputs = upscaled_inputs
        self.instances: List[Dict] = []
        self.sequence_rank = {sid: i for i, sid in enumerate(sequence_order or ())}

    def process_sequence(self, sequence, track_labels: np.ndarray,
                         instance_pt_counts: Dict[int, int],
                         instance_lifetimes: Dict[int, int],
                         category_masks, mask_scale: int, max_tracks: int,
                         min_dim: int, max_dim: int) -> List[int]:
        """:param category_masks: ``[T, h, w, C]`` multiclass logits (channel
            0 the background class), a tensor or an array
        :return: the kept track ids, in the order of ``instances``
        """
        if max_tracks >= 256:
            raise ValueError("at most 255 tracks a sequence")
        with span("writer.sequence", ident=sequence.id):
            image_dims = tuple(sequence.image_dims)
            kept = select_instances_to_keep(instance_lifetimes, OUTLIER_LABEL, max_tracks)
            if not kept:
                print(f"No instances detected for sequence {sequence.id}")
                return []
            max_pts = float(max(instance_pt_counts[i] for i in kept))
            labels_dev = to_device(track_labels, self.device)
            logits = to_device(category_masks, self.device)
            kept_dev = torch.tensor(kept, dtype=labels_dev.dtype,
                                    device=self.device).view(-1, 1, 1)
            logit_sums = torch.zeros((len(kept), logits.shape[-1] - 1), dtype=torch.float32,
                                     device=self.device)
            areas = torch.zeros(len(kept), dtype=torch.int64, device=self.device)
            rle_masks: List[List[Dict]] = [[] for _ in kept]
            for t in range(track_labels.shape[0]):
                with span("writer.resize"):  # the frame's device work and its fetch
                    onehot = labels_dev[t][None] == kept_dev  # [K, h, w]
                    flat = onehot.reshape(len(kept), -1)
                    areas += flat.sum(dim=1)
                    logit_sums += flat.float() @ logits[t][..., 1:].reshape(
                        flat.shape[1], -1).float()
                    full = masks_to_original_dims(onehot, mask_scale, image_dims, min_dim,
                                                  max_dim, self.upscaled_inputs).cpu().numpy()
                with span("writer.encode"):  # its host work
                    for k in range(len(kept)):
                        enc = rle_codec.encode(full[k].astype(np.uint8))
                        enc["counts"] = enc["counts"].decode("utf-8")
                        rle_masks[k].append(enc)

            logit_sums, areas = logit_sums.cpu().numpy(), areas.cpu().numpy()
            for k, iid in enumerate(kept):
                probs = _softmax(logit_sums[k] / max(float(areas[k]), 1.0))
                self.instances.append({
                    "video_id": sequence.id,
                    "score": instance_pt_counts[iid] / max_pts,
                    "category_id": int(np.argmax(probs)) + 1,
                    "segmentations": rle_masks[k],
                })
            return kept

    def save(self):
        with span("writer.save"):
            json_path = os.path.join(self.output_dir, "results.json")
            last = len(self.sequence_rank)
            instances = sorted(self.instances,  # stable: a sequence's tracks keep their order
                               key=lambda inst: self.sequence_rank.get(inst["video_id"], last))
            with open(json_path, "w") as fh:
                json.dump(instances, fh)
            with ZipFile(os.path.join(self.output_dir, "results.zip"), "w",
                         ZIP_DEFLATED) as zf:
                zf.write(json_path, arcname="results.json")
