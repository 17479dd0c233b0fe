"""The ``train_resnext`` kind on the CPU at a tiny size: a sound run comes
out correct and a planted fault does not; the two backbone readers find
nothing in an empty context; ``backbone_flops_per_clip`` against a count
by hand."""

import importlib.util
import os
import time

import pytest
import torch

from benchmark import common, faults
from benchmark.drivers import train_resnext
from benchmark.tests.tiny import THIN, _merge

torch.set_num_threads(2)
READERS = ("backbone_ms_per_clip", "backbone_roofline")


def tiny_x101(frames=4):
    """``stemseg-ytvis-x101`` and its traffic, narrowed to 4 groups of 4
    channels (the stride still on the grouped 3x3), all 33 blocks."""
    conf = common.load_json(os.path.join(common.HERE, "configs", "stemseg-ytvis-x101.json"))
    traffic = common.load_json(os.path.join(common.HERE, "traffic", "ytvis-train-x101.json"))
    _merge(conf["train"], THIN)
    conf["train"]["input"]["num_frames"] = frames
    conf["train"]["model"]["backbone"]["type"] = "X-101-FPN"
    conf["train"]["model"]["resnets"].update(num_groups=4, width_per_group=4)
    assert conf["train"]["model"]["resnets"]["stride_in_1x1"] is False
    traffic["workers"] = 0
    return conf, traffic


def reader(name):
    mod_spec = importlib.util.spec_from_file_location(
        "m", os.path.join(common.HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch"])
def test_training_run(fault, monkeypatch):
    if fault:
        faults.plant(fault, monkeypatch.setattr)
    conf, traffic = tiny_x101()
    out = train_resnext.run("ytvis-x101-train-fp32", conf, traffic, 2 ** 31 + 23, 0.5, False,
                            time.perf_counter(), device="cpu")
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_in_an_empty_context(name):
    assert reader(name).read({}) is None


def test_roofline_reads_the_context_and_the_span(monkeypatch):
    """With 2 clips of 1e12 FLOPs over 100 ms of ``step.backbone`` the card
    ran at 20 TFLOP/s: 29.85 % of 67; a context from the ``train`` driver,
    without the FLOPs, reads nothing."""
    from benchmark import spans

    records = {"spans": [{"name": "step.backbone", "stream_ms": 60.0},
                         {"name": "step.backbone", "stream_ms": 40.0},
                         {"name": "step.forward", "stream_ms": 150.0}]}
    monkeypatch.setattr(spans, "session", lambda: records)
    ctx = {"kind": "train", "clips": 2}
    assert reader("backbone_ms_per_clip").read(ctx) == pytest.approx(50.0)
    assert reader("backbone_roofline").read(ctx) is None
    ctx["backbone_flops_per_clip"] = 1e12
    assert reader("backbone_roofline").read(ctx) == pytest.approx(2e12 / 0.1 / 67e12 * 100)


def test_backbone_flops_by_hand():
    """Every conv's 2 x output elements x (input channels / groups x kernel
    area), at 64x96 and 4 frames: the stride on the 3x3 leaves each stage's
    first 1x1 at its input's size."""
    conf, _ = tiny_x101()
    cfg = conf["train"]
    r = cfg["model"]["resnets"]
    groups, width, stem, res2, fpn = (r["num_groups"], r["width_per_group"],
                                      r["stem_out_channels"], r["res2_out_channels"],
                                      r["backbone_out_channels"])
    t, h, w = 4, 64, 96

    def px(stride):
        return t * (h // stride) * (w // stride)

    total = 2 * px(2) * stem * 3 * 49  # the stem's 7x7/2
    cin = stem
    for i, n in enumerate((3, 4, 23, 3), start=1):
        s_in, s_out = 4 * 2 ** max(i - 2, 0), 4 * 2 ** (i - 1)
        mid, cout = groups * width * 2 ** (i - 1), res2 * 2 ** (i - 1)
        for j in range(n):
            s = s_in if j == 0 else s_out
            total += 2 * px(s) * cin * mid  # 1x1 in, at the input's size
            total += 2 * px(s_out) * (mid // groups) * 9 * mid  # grouped 3x3, strided
            total += 2 * px(s_out) * mid * cout  # 1x1 out
            if cin != cout:
                total += 2 * px(s_out) * cin * cout  # the projection shortcut
            cin = cout
        total += 2 * px(s_out) * cout * fpn + 2 * px(s_out) * fpn * 9 * fpn  # FPN inner, layer
    assert train_resnext.backbone_flops_per_clip(cfg) == total
