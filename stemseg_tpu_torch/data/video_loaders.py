"""Video training datasets, the JAX package's ``data/video_loaders.py``:
DAVIS, YouTube-VIS and KITTI-MOTS. Each samples its subsequences once, from
the construction ``rng``, with ``VideoDataset.create_training_subsequences``.
"""

from __future__ import annotations

import random
from typing import List

import numpy as np

from stemseg_tpu_torch.data.instance_duplicator import InstanceDuplicator
from stemseg_tpu_torch.data.video_dataset import VideoDataset


def _duplicate_single_instance(images, masks, rng):
    """``InstanceDuplicator`` on a one-instance clip; returns the frames and
    T-major masks (two instances) or None when it declines."""
    aug_images, aug_masks = InstanceDuplicator()(images, [m[0] for m in masks], rng)
    if aug_images is None:
        return None
    return aug_images, [list(pair) for pair in zip(*aug_masks)]


class DavisDataLoader(VideoDataset):
    """DAVIS'17 clips: category-agnostic (every instance is 'object'),
    single-instance duplication, background as the ignore region."""

    def __init__(self, base_dir, vds_json_file, input_cfg, samples_to_create: int,
                 rng: random.Random, frame_gap_lower: int, frame_gap_upper: int):
        super().__init__(base_dir, vds_json_file, input_cfg)
        self.filter_zero_instance_frames()
        self.samples = self.create_training_subsequences(
            samples_to_create, frame_gap_lower, frame_gap_upper, rng)

    def parse_sample_at(self, idx, rng):
        sample = self.samples[idx]
        images = sample.load_images()
        masks = sample.load_masks()  # list(T, list(N))

        if len(sample.instance_ids) == 1:
            images, masks = _duplicate_single_instance(images, masks, rng) or (images, masks)

        ignore_masks = [(~np.any(np.stack(mt), axis=0)).astype(np.uint8) for mt in masks]
        return images, masks, [1] * len(masks[0]), {
            "ignore_masks": ignore_masks, "seq_name": sample.id}

    def __len__(self):
        return len(self.samples)


class YoutubeVISDataLoader(VideoDataset):
    """YouTube-VIS clips: category-agnostic (DAVIS mode) or 40 classes;
    single-instance duplication as the mode's config says."""

    def __init__(self, base_dir, vds_json_file, input_cfg, samples_to_create: int,
                 rng: random.Random, frame_gap_lower: int, frame_gap_upper: int,
                 category_agnostic: bool, single_instance_duplication: bool):
        super().__init__(base_dir, vds_json_file, input_cfg)
        self.filter_zero_instance_frames()
        self.category_agnostic = category_agnostic
        if samples_to_create <= 0:
            raise ValueError(f"samples_to_create is {samples_to_create}")
        self.samples = self.create_training_subsequences(
            samples_to_create, frame_gap_lower, frame_gap_upper, rng)
        self.single_instance_duplication = single_instance_duplication

    def parse_sample_at(self, idx, rng):
        sample = self.samples[idx]
        images = sample.load_images()
        masks = sample.load_masks()
        if self.category_agnostic:
            categories = [1] * len(sample.instance_ids)
        else:
            categories = list(sample.category_labels)

        if len(sample.instance_ids) == 1 and self.single_instance_duplication:
            duplicated = _duplicate_single_instance(images, masks, rng)
            if duplicated is not None:
                images, masks = duplicated
                categories.append(categories[-1])

        h, w = images[0].shape[:2]
        ignore_masks = [np.zeros((h, w), np.uint8) for _ in range(self.clip_length)]
        return images, masks, categories, {"ignore_masks": ignore_masks, "seq_name": sample.id}

    def __len__(self):
        return len(self.samples)


class MOTSDataLoader(VideoDataset):
    """KITTI-MOTS clips. A sequence is split where 6 or more frames in a row
    hold no car or pedestrian; category 3 annotations become the ignore
    mask."""

    IGNORE_MASK_CAT_ID = 3

    def __init__(self, base_dir, vds_json_file, input_cfg, samples_to_create: int,
                 rng: random.Random, frame_gap_lower: int, frame_gap_upper: int):
        super().__init__(base_dir, vds_json_file, input_cfg)

        split_sequences = []
        for seq in self.sequences:
            suffix, gap_len = 1, 0
            frame_idxes: List[int] = []
            for t in range(len(seq)):
                cats_t = {seq.instance_categories[iid] for iid in seq.segmentations[t]}
                if not cats_t - {self.IGNORE_MASK_CAT_ID}:
                    gap_len += 1
                    if gap_len == 6 and frame_idxes:
                        split_sequences.append(
                            seq.extract_subsequence(frame_idxes, f"{seq.id}_{suffix}"))
                        suffix += 1
                        frame_idxes = []
                else:
                    gap_len = 0
                    frame_idxes.append(t)
            if frame_idxes:
                split_sequences.append(seq.extract_subsequence(frame_idxes, f"{seq.id}_{suffix}"))
        self.sequences = split_sequences

        if samples_to_create <= 0:
            raise ValueError(f"samples_to_create is {samples_to_create}")
        self.samples = self.create_training_subsequences(
            samples_to_create, frame_gap_lower, frame_gap_upper, rng)

    def parse_sample_at(self, idx, rng):
        sample = self.samples[idx]
        images = sample.load_images()
        masks = sample.load_masks()
        categories = list(sample.category_labels)

        if self.IGNORE_MASK_CAT_ID in categories:
            ignore_idx = categories.index(self.IGNORE_MASK_CAT_ID)
            categories.remove(self.IGNORE_MASK_CAT_ID)
            ignore_masks = [mt[ignore_idx] for mt in masks]
            masks = [[m for i, m in enumerate(mt) if i != ignore_idx] for mt in masks]
        else:
            h, w = images[0].shape[:2]
            ignore_masks = [np.zeros((h, w), np.uint8) for _ in range(len(images))]

        if not masks[0]:
            raise ValueError(f"No instances exist in the masks (seq: {sample.id})")
        return images, masks, categories, {"ignore_masks": ignore_masks, "seq_name": sample.id}

    def __len__(self):
        return len(self.samples)
