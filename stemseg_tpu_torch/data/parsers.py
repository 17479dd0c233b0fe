"""Parser for the project-standard video dataset JSON
(``{meta: {category_labels}, sequences: [{id, height, width, image_paths,
...}]}``), the half that inference needs: sequences and their frames. Mask
annotations are kept as they are and never decoded."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple


def parse_generic_video_dataset(base_dir: str, dataset_json: str):
    with open(dataset_json, "r") as fh:
        dataset = json.load(fh)
    meta_info = dataset["meta"]
    meta_info["category_labels"] = {
        int(k): v for k, v in meta_info["category_labels"].items()}
    seqs = [GenericVideoSequence(seq, base_dir) for seq in dataset["sequences"]]
    return seqs, meta_info


class GenericVideoSequence:
    def __init__(self, seq_dict: Dict, base_dir: str):
        self.base_dir = base_dir
        self.image_paths: List[str] = seq_dict["image_paths"]
        self.image_dims: Tuple[int, int] = (seq_dict["height"], seq_dict["width"])
        self.id = seq_dict["id"]

    def __len__(self):
        return len(self.image_paths)

    def frame_paths(self) -> List[str]:
        return [os.path.join(self.base_dir, p) for p in self.image_paths]
