"""Image -> clip training datasets, the JAX package's
``data/image_clip_loaders.py``: COCO, Pascal VOC and Mapillary. One still
image, optionally flipped, plus ``T - 1`` augmented copies, in a random
temporal order, make a pseudo video; pixels warped in from outside the
image are zeroed after normalisation. The category tables
(``data/metainfo/*.json``) say which categories each target benchmark keeps
and what it maps them to.

``get(index, rng, np_rng)`` draws only from the generators it is given, in
the JAX package's order (flip, each copy's augmentation, the temporal
shuffle). The sample has the ``VideoDataset`` layout.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict

import numpy as np

from stemseg_tpu_torch.data.augmenter import ImageToSeqAugmenter
from stemseg_tpu_torch.data.parsers import parse_generic_image_dataset
from stemseg_tpu_torch.data.transforms import (
    resize_images,
    resize_mask,
    scale_and_normalize_images,
)
from stemseg_tpu_torch.structures.geometry import compute_resize_params
from stemseg_tpu_torch.utils.constants import RepoPaths


def load_category_table(name: str) -> Dict[int, dict]:
    """``{source category id: attributes}`` from ``data/metainfo/<name>.json``."""
    with open(os.path.join(RepoPaths.dataset_meta_info_dir(), f"{name}.json")) as fh:
        return {int(k): v for k, v in json.load(fh).items()}


def _davis_or_ytvis_mapping(table, category_agnostic: bool):
    """(kept ids, id mapping): every kept category -> 1 for DAVIS, or to its
    YouTube-VIS id."""
    if category_agnostic:
        keep = [cid for cid, a in table.items() if a["keep_davis"]]
        return keep, {cid: 1 for cid in keep}
    keep = [cid for cid, a in table.items() if a["keep_ytvis"]]
    return keep, {cid: table[cid]["id_ytvis"] for cid in keep}


class ImageClipDataset:
    def __init__(self, base_dir: str, ids_json_file: str, input_cfg,
                 augmenter: ImageToSeqAugmenter):
        self.samples, self.meta_info = parse_generic_image_dataset(base_dir, ids_json_file)
        self.input_cfg = input_cfg
        self.num_frames = input_cfg.num_frames
        self.augmenter = augmenter

    def __len__(self):
        return len(self.samples)

    def load_instances(self, sample):
        """Subclass hook: (image, instance masks list[N], category ids
        list[N], ignore mask [H, W] uint8 or None)."""
        raise NotImplementedError

    def get(self, index: int, rng: random.Random, np_rng: np.random.RandomState) -> Dict:
        image, instance_masks, category_ids, ignore_mask = self.load_instances(
            self.samples[index])
        image_height, image_width = image.shape[:2]
        if ignore_mask is None:
            ignore_mask = np.zeros((image_height, image_width), np.uint8)

        if rng.random() < 0.5:
            image = np.flip(image, axis=1)
            instance_masks = [np.flip(m, axis=1) for m in instance_masks]
            ignore_mask = np.flip(ignore_mask, axis=1)
        image = np.ascontiguousarray(image)
        instance_masks = [np.ascontiguousarray(m) for m in instance_masks]
        ignore_mask = np.ascontiguousarray(ignore_mask)

        seq_images, seq_masks, seq_ignores = [image], [instance_masks], [ignore_mask]
        seq_invalid = [np.zeros((image_height, image_width), bool)]
        for _ in range(self.num_frames - 1):
            aug_im, aug_masks, invalid = self.augmenter(
                image, instance_masks + [ignore_mask], rng, np_rng)
            seq_images.append(aug_im)
            seq_masks.append(aug_masks[:-1])
            seq_ignores.append(aug_masks[-1])
            seq_invalid.append(invalid)

        perm = list(range(self.num_frames))
        rng.shuffle(perm)
        seq_images = [seq_images[i] for i in perm]
        seq_masks = [seq_masks[i] for i in perm]
        seq_ignores = [seq_ignores[i] for i in perm]
        seq_invalid = [seq_invalid[i] for i in perm]

        icfg = self.input_cfg
        images = scale_and_normalize_images(
            np.stack(seq_images).astype(np.float32), icfg.image_mean, icfg.image_std,
            not icfg.bgr_input, icfg.normalize_to_unit_scale)
        images = images * (1.0 - np.stack(seq_invalid)[..., None].astype(np.float32))

        new_w, new_h, _ = compute_resize_params((image_width, image_height),
                                                icfg.min_dim, icfg.max_dim)
        images = resize_images(images, (new_h, new_w))

        n_inst = len(seq_masks[0])
        masks_np = np.zeros((n_inst, self.num_frames, new_h, new_w), np.uint8)
        for t in range(self.num_frames):
            for n in range(n_inst):
                masks_np[n, t] = resize_mask(seq_masks[t][n], (new_h, new_w))
        ignore_np = np.stack([resize_mask(m, (new_h, new_w)) for m in seq_ignores])

        return {
            "images": np.ascontiguousarray(images, np.float32),
            "masks": masks_np,
            "ignore_masks": ignore_np,
            "category_ids": np.asarray(category_ids, np.int32),
            "orig_dims": (image_width, image_height),
            "meta": {},
        }


class CocoDataLoader(ImageClipDataset):
    def __init__(self, base_dir, ids_json_file, input_cfg, category_agnostic: bool):
        keep, self.category_id_mapping = _davis_or_ytvis_mapping(
            load_category_table("coco"), category_agnostic)
        super().__init__(base_dir, ids_json_file, input_cfg,
                         ImageToSeqAugmenter(12, motion_blur_prob=0.25))
        for s in self.samples:
            s.filter_categories(keep)
        self.samples = [s for s in self.samples if s.segmentations]

    def load_instances(self, sample):
        cats = [self.category_id_mapping[c] for c in sample.categories]
        return sample.load_image(), sample.load_masks(), cats, None


class PascalVOCDataLoader(ImageClipDataset):
    """Instances below ``MIN_INSTANCE_SIZE`` pixels are dropped; the
    annotation's ignore RLE is the ignore mask."""

    MIN_INSTANCE_SIZE = 50

    def __init__(self, base_dir, ids_json_file, input_cfg, category_agnostic: bool):
        keep, self.category_id_mapping = _davis_or_ytvis_mapping(
            load_category_table("pascal_voc"), category_agnostic)
        super().__init__(base_dir, ids_json_file, input_cfg,
                         ImageToSeqAugmenter(10, motion_blur_prob=0.25))

        filtered = []
        for s in self.samples:
            areas = s.mask_areas()
            keep_idx = [i for i in range(len(s.segmentations))
                        if areas[i] >= self.MIN_INSTANCE_SIZE and s.categories[i] in keep]
            s.segmentations = [s.segmentations[i] for i in keep_idx]
            s.categories = [s.categories[i] for i in keep_idx]
            if s.segmentations:
                filtered.append(s)
        self.samples = filtered

    def load_instances(self, sample):
        cats = [self.category_id_mapping[c] for c in sample.categories]
        return sample.load_image(), sample.load_masks(), cats, sample.load_ignore_mask()


class MapillaryDataLoader(ImageClipDataset):
    """Instances below ``MIN_INSTANCE_SIZE`` pixels are dropped; of the kept
    categories, those among the ``MAX_NBR_INSTANCES`` largest instances stay,
    mapped to the KITTI-MOTS ids, and the rest and the ignore categories form
    the ignore mask."""

    MIN_INSTANCE_SIZE = 30
    MAX_NBR_INSTANCES = 30

    def __init__(self, base_dir, ids_json_file, input_cfg):
        table = load_category_table("mapillary")
        self.cat_ids_to_keep = [cid for cid, a in table.items() if a["keep"]]
        self.cat_ids_to_ignore = [cid for cid, a in table.items() if a["ignore_mask"]]
        self.category_id_mapping = {cid: table[cid]["id_kittimots"]
                                    for cid in self.cat_ids_to_keep}
        super().__init__(base_dir, ids_json_file, input_cfg,
                         ImageToSeqAugmenter(10, motion_blur_prob=0.0))

        filtered = []
        for s in self.samples:
            areas = s.mask_areas()
            keep_idx = [i for i in range(len(s.segmentations))
                        if areas[i] >= self.MIN_INSTANCE_SIZE]
            s.segmentations = [s.segmentations[i] for i in keep_idx]
            s.categories = [s.categories[i] for i in keep_idx]
            if not any(c in self.cat_ids_to_keep for c in s.categories):
                continue
            wanted = self.cat_ids_to_keep + self.cat_ids_to_ignore
            keep_idx = [i for i in range(len(s.segmentations)) if s.categories[i] in wanted]
            s.segmentations = [s.segmentations[i] for i in keep_idx]
            s.categories = [s.categories[i] for i in keep_idx]
            filtered.append(s)
        self.samples = filtered

    def load_instances(self, sample):
        masks = sample.load_masks()
        areas = sample.mask_areas()
        order = sorted(range(len(masks)), key=lambda i: areas[i], reverse=True)
        kept_masks, kept_cats, ignore_masks = [], [], []
        for rank, i in enumerate(order):
            if rank < self.MAX_NBR_INSTANCES and sample.categories[i] in self.cat_ids_to_keep:
                kept_masks.append(masks[i])
                kept_cats.append(self.category_id_mapping[sample.categories[i]])
            else:
                ignore_masks.append(masks[i])

        if ignore_masks:
            ignore = np.any(np.stack(ignore_masks), axis=0).astype(np.uint8)
        else:
            ignore = np.zeros_like(masks[0]) if masks else None
        return sample.load_image(), kept_masks, kept_cats, ignore
