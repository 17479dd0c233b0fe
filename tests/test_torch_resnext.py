"""The port's X-101-FPN (a ResNeXt body: a grouped 3x3 that carries the
stride) against the benchmark's plain reference
(``benchmark/reference/resnext.py``) on seeded random weights, in the
configuration ``stemseg-ytvis-x101`` (youtube_vis training) narrowed to 4
groups of 4 channels, 4 frames of 64x96, with the stride on the 3x3:

* the forward's embedding map and semseg logits;
* one optimizer step of ``TrainStep`` on a synthetic clip against the
  reference's step on the same clip: the loss, each trainable leaf's
  gradient and the update;
* the same port with the stride on the first 1x1 instead fails the forward
  comparison;
* the reference with one group and the stride on the 1x1 is
  ``benchmark/reference/model.py``'s model, to the bit.

No JAX: the reference is plain PyTorch.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import common  # noqa: E402
from benchmark.drivers.train_resnext import bound  # noqa: E402
from benchmark.reference import model as ref_model  # noqa: E402
from benchmark.reference import resnext  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from stemseg_tpu_torch.config import load_config  # noqa: E402
from stemseg_tpu_torch.models import build_model  # noqa: E402
from stemseg_tpu_torch.training.loader import loader_batch, to_device  # noqa: E402
from stemseg_tpu_torch.training.optim import (  # noqa: E402
    make_optimizer,
    trainable_parameters,
)
from stemseg_tpu_torch.training.step import TrainStep  # noqa: E402

torch.set_num_threads(2)

HEADS = {"inter_channels": [32, 32, 16, 16], "gn_num_groups": 8}
NARROW = {
    "input": {"min_dim": 64, "max_dim": 96, "num_frames": 4},
    "model": {"resnets": {"num_groups": 4, "width_per_group": 4, "stem_out_channels": 16,
                          "res2_out_channels": 32, "backbone_out_channels": 32},
              "embeddings": HEADS, "seediness": HEADS, "semseg": HEADS},
    # one clip an optimizer step: the step's gradient is the clip's
    "training": {"batch_size": 1},
}
# Float32 on the CPU on both sides. The port's heads compute the expand
# step and the pools as the reference does, but may round differently where
# a backend orders a sum otherwise (they read equal to the bit here); the
# port in bf16 misses by 4e-2 relative and 7e-3 absolute.
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
# The repository's loss tolerance against its references (the losses' sums
# in another order): float32 reads equal here. At this size a bf16 step's
# loss reads 1.8e-5 and passes; its gradient does not (below).
LOSS_RTOL = 2e-4
# A leaf's relative L2 gap, against its own norm or the median leaf's if
# larger (a leaf far below the median keeps only rounding). float32 reads
# 1e-6 on the gradient and 7e-5 on the update (the change of a weight is a
# thousandth of it, so its rounding is a thousand times larger relative);
# the bf16 step reads 0.26 on both.
GRAD_RTOL = 2e-3


def _merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


def narrow_tree(**resnets):
    tree = copy.deepcopy(common.load_json(os.path.join(
        common.HERE, "configs", "stemseg-ytvis-x101.json"))["train"])
    _merge(tree, NARROW)
    tree["model"]["resnets"].update(resnets)
    return tree


@pytest.fixture(scope="module")
def tree():
    t = narrow_tree()
    r = t["model"]["resnets"]
    assert t["model"]["backbone"]["type"] == "X-101-FPN"
    assert r["num_groups"] > 1 and r["stride_in_1x1"] is False
    return t


@pytest.fixture(scope="module")
def state(tree):
    with torch.device("meta"):
        shapes = resnext.Model(tree)
    return common.random_weights(shapes, 23, torch.device("cpu"))


def port_model(tree, state, for_training=False):
    model = build_model(load_config(tree), device="cpu", for_training=for_training)
    model.load_state_dict(state)
    return model


def clips(seed=3):
    return torch.randn(2, 4, 3, 64, 96, generator=torch.Generator().manual_seed(seed)) * 40


def test_body_is_grouped_with_the_stride_on_the_3x3(tree, state):
    model = port_model(tree, state)
    block = model.backbone.body.layer2[0]
    assert block.conv2.groups == 4 and block.conv2.stride == (2, 2)
    assert block.conv1.stride == (1, 1)
    assert len(model.backbone.body.layer3) == 23


@pytest.mark.parametrize("stride_in_1x1", [False, True], ids=["stride_on_3x3", "stride_on_1x1"])
def test_forward_against_the_reference(tree, state, stride_in_1x1):
    """The port in the configuration's convention agrees with the reference;
    with the stride moved to the 1x1 (same weights, same output sizes) it
    misses by far more than the tolerance."""
    ref = resnext.Model(tree)
    ref.load_state_dict(state)
    port = port_model(narrow_tree(stride_in_1x1=stride_in_1x1), state)
    x = clips()
    with torch.no_grad():
        emb_ref, sem_ref = ref(x)
        out = port(x)
    pairs = [(out["embeddings"], emb_ref), (out["semseg_masks"], sem_ref)]
    if not stride_in_1x1:
        for got, want in pairs:
            torch.testing.assert_close(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)
    else:
        gap = max(float(((got - want).abs() / (want.abs() + FWD_ATOL / FWD_RTOL)).max())
                  for got, want in pairs)
        assert gap > 100 * FWD_RTOL


def test_reference_with_one_group_and_the_stride_on_the_1x1_is_model_py():
    one = narrow_tree(num_groups=1, width_per_group=16, stride_in_1x1=True)
    plain = copy.deepcopy(one)
    plain["model"]["backbone"]["type"] = "R-101-FPN"
    copy_, orig = resnext.Model(one), ref_model.Model(plain)
    state = common.random_weights(orig, 29, torch.device("cpu"))
    copy_.load_state_dict(state)
    orig.load_state_dict(state)
    x = clips(5)
    with torch.no_grad():
        got, want = copy_(x), orig(x)
    # the same modules in the same order: equal to the bit
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def synthetic_batch(tree, index):
    """Clip ``index`` of the reference's synthetic stream as the loader
    hands a batch over."""
    clip = ref_train.synthetic_clip(tree, index)
    t, h, w, _ = clip["images"].shape
    arrays = {"images": np.ascontiguousarray(clip["images"][None], np.float32),
              "masks": clip["masks"][None],
              "ignore_masks": np.zeros((1, t, h, w), np.uint8),
              "category_ids": clip["category_ids"][None].astype(np.int32)}
    return to_device(loader_batch(arrays, scale=4), torch.device("cpu"))


def leaf_gap(got, want):
    median = float(np.median([float(v.norm()) for v in want.values()]))
    return {n: float((got[n] - want[n]).norm()) / max(float(want[n].norm()), median)
            for n in want}


def test_one_train_step_against_the_reference(tree, state):
    with bound():
        want = ref_train.train_steps(tree, state, 1, 1, ref_model.frozen_names(tree),
                                     torch.device("cpu"))
    (index,), = ref_train.step_indices(tree, 1, 1)

    cfg = load_config(tree)
    model = port_model(tree, state, for_training=True)
    optimizer, scheduler = make_optimizer(cfg.training, trainable_parameters(model))
    step = TrainStep(model, cfg, optimizer, scheduler, accumulate_steps=1)
    named = {n: p for n, p in model.named_parameters() if p.requires_grad}
    assert set(named) == set(want["params"])
    p0 = {n: p.detach().clone() for n, p in named.items()}
    metrics = step(synthetic_batch(tree, index))

    np.testing.assert_allclose(float(metrics["total"]), want["losses"][0], rtol=LOSS_RTOL)
    wd = cfg.training.weight_decay
    # the gradient as the optimizer got it: its first momentum buffer less the decay
    grads = {n: optimizer.state[p]["momentum_buffer"] - wd * p0[n] for n, p in named.items()}
    gaps = leaf_gap(grads, want["first_grad"])
    assert max(gaps.values()) < GRAD_RTOL, max(gaps.items(), key=lambda kv: kv[1])
    assert all(float(g.norm()) > 0 for n, g in grads.items() if ".conv2." in n)
    change = {n: p.detach() - p0[n] for n, p in named.items()}
    change_ref = {n: want["params"][n] - p0[n] for n in named}
    gaps = leaf_gap(change, change_ref)
    assert max(gaps.values()) < GRAD_RTOL, max(gaps.items(), key=lambda kv: kv[1])
