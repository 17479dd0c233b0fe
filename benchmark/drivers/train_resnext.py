"""Traffic of kind ``train_resnext``: the ``train`` driver's flow on a
configuration whose backbone body is a ResNeXt (``model.resnets``
``num_groups``, ``width_per_group``, ``stride_in_1x1``), with the plain
reference ``reference/resnext.py`` bound where that flow looks the
reference model up: the weights' shapes (``drivers/train.py``), the
reference steps (``reference/train.py``) and the FLOP count
(``counts.training_flops``). The binding lasts for the call.

The readers' context also holds ``backbone_flops_per_clip``: the backbone
and FPN forward FLOPs of one clip's frames, counted on the reference on
the meta device.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator
from unittest import mock

from .. import counts
from ..reference import model as ref_model
from ..reference import resnext
from ..reference import train as ref_train
from . import train


@contextlib.contextmanager
def bound() -> Iterator[None]:
    """``resnext.Model`` in the places the train flow takes ``model.Model``
    from, until the block ends."""
    with mock.patch.object(ref_model, "Model", resnext.Model), \
            mock.patch.object(ref_train, "Model", resnext.Model):
        yield


def backbone_flops_per_clip(cfg: Dict) -> int:
    """Backbone + FPN forward FLOPs of one clip of ``num_frames`` frames at
    the padded training size, on the reference."""
    import torch

    icfg, scfg = cfg["input"], cfg["data"]["synthetic"]
    hw = (-(-(scfg["height"] or icfg["min_dim"]) // 32) * 32,
          -(-(scfg["width"] or icfg["max_dim"]) // 32) * 32)
    with torch.device("meta"):
        model = resnext.Model(cfg)
        clip = torch.empty((icfg["num_frames"], 3) + hw)
        with torch.no_grad():
            return counts._flops(lambda: model.backbone(clip))


def run(workload: str, conf: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
        t0: float, device: str = "cuda", dtype=None) -> Dict:
    """One run of the cell, as ``train.run``."""
    with bound():
        out = train.run(workload, conf, traffic, seed, seconds, trace, t0, device, dtype)
    if out["ctx"] is not None:
        out["ctx"]["backbone_flops_per_clip"] = backbone_flops_per_clip(conf["train"])
    return out


def rank_worker(args) -> None:
    """A rank of a multi-rank run (``train.rank_worker``), bound as ``run``."""
    with bound():
        train.rank_worker(args)
