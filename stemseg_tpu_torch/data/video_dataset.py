"""Base class of the video training datasets, the JAX package's
``data/video_dataset.py``: subsequence sampling, resize and normalisation
on the host (numpy / cv2). The video loaders never augment (in the JAX
package and the reference alike), so the flip, augmentation and reversal
of the JAX base class, which only that setting reaches, are not ported. A
sample is channels-last:

``{"images": [T, H, W, 3] float32 normalised (resized, unpadded),
   "masks": [N, T, H, W] uint8, "ignore_masks": [T, H, W] uint8,
   "category_ids": [N] int32, "orig_dims": (w, h), "meta": dict}``

Randomness: subsequence sampling draws from the ``random.Random`` handed to
``create_training_subsequences``; ``get(index, rng, np_rng)`` hands ``rng``
to the subclass (single-instance duplication) and takes ``np_rng`` only to
share the image clip loaders' signature.
"""

from __future__ import annotations

import math
import random
from typing import Dict

import numpy as np

from stemseg_tpu_torch.data.parsers import parse_generic_video_dataset
from stemseg_tpu_torch.data.transforms import (
    resize_images,
    resize_mask,
    scale_and_normalize_images,
)
from stemseg_tpu_torch.structures.geometry import compute_resize_params


class VideoDataset:
    def __init__(self, base_dir: str, vds_json: str, input_cfg):
        self.sequences, self.meta_info = parse_generic_video_dataset(base_dir, vds_json)
        self.clip_length = input_cfg.num_frames
        self.input_cfg = input_cfg

    def filter_zero_instance_frames(self):
        for seq in self.sequences:
            seq.filter_zero_instance_frames()
        self.sequences = [s for s in self.sequences if len(s) > 0]

    def create_training_subsequences(self, num_subsequences: int, frame_gap_lower: int,
                                     frame_gap_upper: int, rng: random.Random):
        """``num_subsequences`` clips of ``clip_length`` frames, linspace-sampled
        over a span drawn from [gap_lower, gap_upper]; each sequence's quota is
        proportional to its length, the excess randomly dropped."""
        frame_range = list(range(frame_gap_lower, frame_gap_upper + 1))
        sequences = [s for s in self.sequences if len(s) > frame_range[0] + 1]
        if not sequences:
            raise ValueError(f"no sequence longer than {frame_range[0] + 1} frames to sample "
                             f"subsequences from")

        total_frames = sum(len(s) for s in sequences)
        samples_per_seq = [max(1, int(math.ceil((len(s) / total_frames) * num_subsequences)))
                           for s in sequences]

        subsequence_idxes = []
        for sequence, num_samples in zip(sequences, samples_per_seq):
            for _ in range(num_samples):
                span = min(rng.choice(frame_range), len(sequence) - 1)
                max_start = len(sequence) - span - 1
                start = 0 if max_start == 0 else rng.randint(0, max_start)
                idxes = np.round(np.linspace(start, start + span,
                                             self.clip_length)).astype(np.int32).tolist()
                if len(set(idxes)) != len(idxes):
                    raise ValueError(f"a span of {span} frames holds no {self.clip_length} "
                                     f"distinct frames")
                subsequence_idxes.append((sequence.id, idxes))

        subsequence_idxes = rng.sample(subsequence_idxes, num_subsequences)
        rng.shuffle(subsequence_idxes)

        by_id = {s.id: s for s in sequences}
        return [by_id[vid].extract_subsequence(idxes) for vid, idxes in subsequence_idxes]

    def parse_sample_at(self, idx, rng: random.Random):
        """Subclass hook: (images list[T] of HxWx3 uint8, masks list[T] of
        list[N] of HxW uint8, category_ids list[N], meta dict with
        'ignore_masks' list[T] of HxW uint8)."""
        raise NotImplementedError

    def get(self, index: int, rng: random.Random, np_rng: np.random.RandomState) -> Dict:
        images, masks, category_ids, meta = self.parse_sample_at(index, rng)
        ignore_masks = meta.pop("ignore_masks")
        image_height, image_width = images[0].shape[:2]

        icfg = self.input_cfg
        new_w, new_h, _ = compute_resize_params((image_width, image_height),
                                                icfg.min_dim, icfg.max_dim)
        images = resize_images(np.stack(images).astype(np.float32), (new_h, new_w))
        images = scale_and_normalize_images(images, icfg.image_mean, icfg.image_std,
                                            not icfg.bgr_input, icfg.normalize_to_unit_scale)

        n_inst = len(masks[0])
        masks_np = np.zeros((n_inst, self.clip_length, new_h, new_w), np.uint8)
        for t in range(self.clip_length):
            for n in range(n_inst):
                masks_np[n, t] = resize_mask(masks[t][n], (new_h, new_w))
        ignore_np = np.stack([resize_mask(m, (new_h, new_w)) for m in ignore_masks])

        return {
            "images": np.ascontiguousarray(images, np.float32),
            "masks": masks_np,
            "ignore_masks": ignore_np,
            "category_ids": np.asarray(category_ids, np.int32),
            "orig_dims": (image_width, image_height),
            "meta": meta,
        }
