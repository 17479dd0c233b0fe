"""The benchmark's files narrowed to a size a CPU test can run: R-50, thin
heads, small frames and few sequences. Everything else (keys, drivers,
readers, the comparison) is the cells' own."""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

from benchmark import common

THIN = {"input": {"min_dim": 64, "max_dim": 96},
        "model": {"backbone": {"type": "R-50-FPN"},
                  "resnets": {"res2_out_channels": 64, "stem_out_channels": 16,
                              "width_per_group": 16, "backbone_out_channels": 32},
                  "embeddings": {"inter_channels": [32, 32, 16, 16], "gn_num_groups": 8},
                  "seediness": {"inter_channels": [32, 32, 16, 16], "gn_num_groups": 8},
                  "semseg": {"inter_channels": [32, 32, 16, 16], "gn_num_groups": 8}}}


def _merge(dst: Dict, src: Dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def tiny(config: str, traffic_name: str, frames: int = 8,
         dataset: Optional[str] = None) -> Tuple[Dict, Dict]:
    """(configuration file, traffic file) by their names, narrowed.
    ``dataset``: an inference traffic run through another dataset's writer;
    ``ytvis`` alternates two raw sizes, so each sequence replaces the fused
    state."""
    conf = common.load_json(os.path.join(common.HERE, "configs", config + ".json"))
    traffic = common.load_json(os.path.join(common.HERE, "traffic", traffic_name + ".json"))
    for role in ("infer", "train"):
        _merge(conf[role], THIN)
        conf[role]["input"]["num_frames"] = frames
    if traffic["kind"] == "infer":
        sizes = [(48, 85), (72, 128)] if dataset == "ytvis" else [(48, 85)]
        seqs = traffic["sequences"][:5]
        traffic["sequences"] = [[s[0], frames + 2 + i, *sizes[i % len(sizes)]]
                                for i, s in enumerate(seqs)]
        traffic["warmup"] = [[f"warm{j}", frames + 3, *hw] for j, hw in enumerate(sizes)]
        traffic["check"]["sequences"] = 2
        traffic["dataset"] = dataset or traffic["dataset"]
    return conf, traffic
