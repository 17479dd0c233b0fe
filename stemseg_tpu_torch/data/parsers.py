"""Parsers for the project-standard dataset JSONs, as in the JAX package's
``data/parsers.py``:

* video: ``{meta: {category_labels}, sequences: [{id, height, width,
  image_paths, categories: {iid: cat}, segmentations: [{iid: rle_str} per
  frame]}]}``; inference reads only the frames, training also the masks;
* image: ``{meta, images: [{image_path, height, width, categories,
  segmentations, ignore?}]}``.

Masks are COCO RLE strings, decoded by ``utils/rle.py``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from stemseg_tpu_torch.utils import rle


def _decode(counts: str, hw: Tuple[int, int]) -> np.ndarray:
    return rle.decode({"counts": counts.encode("utf-8"), "size": hw})


def parse_generic_video_dataset(base_dir: str, dataset_json: str):
    with open(dataset_json, "r") as fh:
        dataset = json.load(fh)
    meta_info = dataset["meta"]
    meta_info["category_labels"] = {
        int(k): v for k, v in meta_info["category_labels"].items()}

    if dataset["sequences"] and "segmentations" in dataset["sequences"][0]:
        for seq in dataset["sequences"]:
            seq["categories"] = {int(iid): cat for iid, cat in seq["categories"].items()}
            seq["segmentations"] = [{int(iid): seg for iid, seg in seg_t.items()}
                                    for seg_t in seq["segmentations"]]
            seg_iids = set().union(*[set(s) for s in seq["segmentations"]])
            if seg_iids != set(seq["categories"]):
                raise ValueError(f"{dataset_json}: sequence {seq['id']}: instance ids "
                                 f"{sorted(seg_iids)} in the masks, "
                                 f"{sorted(seq['categories'])} in the categories")

    seqs = [GenericVideoSequence(seq, base_dir) for seq in dataset["sequences"]]
    return seqs, meta_info


class GenericVideoSequence:
    def __init__(self, seq_dict: Dict, base_dir: str):
        self.base_dir = base_dir
        self.image_paths: List[str] = seq_dict["image_paths"]
        self.image_dims: Tuple[int, int] = (seq_dict["height"], seq_dict["width"])
        self.id = seq_dict["id"]
        self.segmentations = seq_dict.get("segmentations")
        self.instance_categories: Optional[Dict[int, int]] = seq_dict.get("categories")

    @property
    def instance_ids(self) -> List[int]:
        return list(self.instance_categories)

    @property
    def category_labels(self) -> List[int]:
        return [self.instance_categories[iid] for iid in self.instance_ids]

    def __len__(self):
        return len(self.image_paths)

    def frame_paths(self) -> List[str]:
        return [os.path.join(self.base_dir, p) for p in self.image_paths]

    def load_images(self) -> List[np.ndarray]:
        import cv2

        images = []
        for path in self.frame_paths():
            im = cv2.imread(path, cv2.IMREAD_COLOR)
            if im is None:
                raise ValueError(f"No image found at path: {path}")
            images.append(im)
        return images

    def load_masks(self) -> List[List[np.ndarray]]:
        """:return: list over frames of list over instances of [H, W] uint8"""
        return [[_decode(seg_t[iid], self.image_dims) if iid in seg_t
                 else np.zeros(self.image_dims, np.uint8)
                 for iid in self.instance_ids]
                for seg_t in self.segmentations]

    def filter_categories(self, cat_ids_to_keep):
        keep = sorted(iid for iid, cat in self.instance_categories.items()
                      if cat in cat_ids_to_keep)
        self.segmentations = [{iid: seg for iid, seg in seg_t.items() if iid in keep}
                              for seg_t in self.segmentations]
        self.instance_categories = {iid: self.instance_categories[iid] for iid in keep}

    def filter_zero_instance_frames(self):
        t_keep = [t for t in range(len(self)) if self.segmentations[t]]
        self.image_paths = [self.image_paths[t] for t in t_keep]
        self.segmentations = [self.segmentations[t] for t in t_keep]

    def extract_subsequence(self, frame_idxes, new_id="") -> "GenericVideoSequence":
        if not all(0 <= t < len(self) for t in frame_idxes):
            raise IndexError(f"sequence {self.id} of {len(self)} frames: {frame_idxes}")
        keep_iids = set().union(*[set(self.segmentations[t]) for t in frame_idxes])
        wanted = set(frame_idxes)
        return self.__class__({
            "id": new_id or self.id,
            "height": self.image_dims[0],
            "width": self.image_dims[1],
            "image_paths": [self.image_paths[t] for t in frame_idxes],
            "categories": {iid: self.instance_categories[iid] for iid in keep_iids},
            "segmentations": [{iid: seg_t[iid] for iid in seg_t if iid in keep_iids}
                              for t, seg_t in enumerate(self.segmentations) if t in wanted],
        }, self.base_dir)


def parse_generic_image_dataset(base_dir: str, dataset_json: str):
    with open(dataset_json, "r") as fh:
        dataset = json.load(fh)
    meta_info = dataset["meta"]
    meta_info["category_labels"] = {
        int(k): v for k, v in meta_info["category_labels"].items()}
    samples = [GenericImageSample(base_dir, s) for s in dataset["images"]]
    return samples, meta_info


class GenericImageSample:
    def __init__(self, base_dir: str, sample: Dict):
        self.height = sample["height"]
        self.width = sample["width"]
        self.path = os.path.join(base_dir, sample["image_path"])
        self.categories = [int(c) for c in sample["categories"]]
        self.segmentations = sample["segmentations"]
        self.ignore = sample.get("ignore")

    def mask_areas(self) -> List[int]:
        return [rle.area({"size": (self.height, self.width), "counts": seg.encode("utf-8")})
                for seg in self.segmentations]

    def load_image(self) -> np.ndarray:
        import cv2

        im = cv2.imread(self.path, cv2.IMREAD_COLOR)
        if im is None:
            raise ValueError(f"No image found at path: {self.path}")
        return im

    def load_ignore_mask(self) -> Optional[np.ndarray]:
        if self.ignore is None:
            return None
        return _decode(self.ignore, (self.height, self.width))

    def load_masks(self) -> List[np.ndarray]:
        return [_decode(seg, (self.height, self.width)) for seg in self.segmentations]

    def filter_categories(self, cat_ids_to_keep):
        kept = [(cat, seg) for cat, seg in zip(self.categories, self.segmentations)
                if cat in cat_ids_to_keep]
        self.categories = [c for c, _ in kept]
        self.segmentations = [s for _, s in kept]
