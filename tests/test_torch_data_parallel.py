"""Data-parallel serving in the port: ``FusedSequencePipeline.run_batch``
(one sequence per device, a pipeline and a host thread each) and the
inference CLI's ``--data_parallel``, on the CPU:

* ``run_batch`` over ``["cpu", "cpu"]`` equals the per-sequence ``run``
  exactly (labels, counts, lifetimes, fg and multiclass masks), on
  sequences of mixed lengths, twice with the replica kept; a sequence's
  failure is raised;
* the CLI's ``--data_parallel`` (``CPU_DATA_PARALLEL`` replicas on the CPU;
  two sequences of one frame size, one of another, one shorter than the
  window, which takes the streaming path) writes DAVIS PNGs byte-equal to
  its serial run and to the JAX CLI's ``--data_parallel`` on the same JAX
  ``.ckpt`` (``tests/test_inference_cli.py``'s data-parallel case, which
  the JAX suite marks slow, with a second frame size).
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from stemseg_tpu.inference import main as jax_inference_main
from stemseg_tpu.utils.timer import Timer as JaxTimer
from stemseg_tpu_torch.config import load_config
from stemseg_tpu_torch.inference import main as cli
from stemseg_tpu_torch.inference.clustering import ClusterParams
from stemseg_tpu_torch.inference.engine import InferenceEngine
from stemseg_tpu_torch.inference.fused_pipeline import FusedSequencePipeline
from stemseg_tpu_torch.inference.windows import get_subsequence_frames
from stemseg_tpu_torch.models import build_model, init_random_weights
from stemseg_tpu_torch.utils import rle
from stemseg_tpu_torch.utils.timer import Timer
from test_inference_cli import _make_checkpoint

torch.set_num_threads(2)

OVER = {"input": {"num_frames": 4, "num_classes": 2},
        "model": {"backbone": {"type": "R-50-FPN"},
                  "resnets": {"backbone_out_channels": 32, "res2_out_channels": 32,
                              "stem_out_channels": 16, "width_per_group": 8},
                  "embeddings": {"inter_channels": [32, 32, 16, 16], "gn_num_groups": 8},
                  "seediness": {"inter_channels": [32, 32, 16, 16], "gn_num_groups": 8}},
        "clustering": {"min_seediness_prob": 0.3, "max_instances": 5}}
HW = (64, 96)


@pytest.fixture(scope="module")
def pipe():
    cfg = load_config(OVER)
    model = build_model(cfg, device="cpu")
    init_random_weights(model, 3)
    c = cfg.clustering
    params = ClusterParams(c.primary_prob_threshold, c.secondary_prob_threshold,
                           c.min_seediness_prob, c.max_instances)
    return FusedSequencePipeline(InferenceEngine(cfg, model), params)


def test_run_batch_equals_per_sequence_run(pipe):
    rng = np.random.RandomState(9)
    seqs = [(rng.rand(n, 60, 90, 3) * 255).astype(np.uint8) for n in (11, 8, 9, 12)]
    windows = [get_subsequence_frames(len(f), 4, 2) for f in seqs]
    want = [pipe.run(f, w, resize_hw=HW) for f, w in zip(seqs, windows)]
    assert any(len(np.unique(w[0])) > 2 for w in want)  # random weights still cluster

    for lo in (0, 2):  # the second call reuses slot 1's replica
        got = pipe.run_batch(seqs[lo:lo + 2], windows[lo:lo + 2], ["cpu", "cpu"],
                             resize_hw=HW)
        assert len(got) == 2
        for g, w in zip(got, want[lo:lo + 2]):
            np.testing.assert_array_equal(g[0], w[0])
            assert g[1] == w[1] and g[2] == w[2]
            np.testing.assert_array_equal(g[3], w[3])
            np.testing.assert_array_equal(g[4], w[4])
    assert list(pipe._replicas) == [(1, torch.device("cpu"))]
    replica = pipe._replicas[(1, torch.device("cpu"))]
    assert replica.engine.model is not pipe.engine.model

    with pytest.raises(TypeError, match="raw uint8"):
        pipe.run_batch([seqs[0], seqs[1].astype(np.float32)], windows[:2], ["cpu", "cpu"],
                       resize_hw=HW)


def write_davis_set(tmp_path):
    """seqA and seqB of 48x64, seqD of 40x56 (another frame size), seqC of 3
    frames (shorter than the window): JPEG frames and the val JSON."""
    rng = np.random.RandomState(1)
    base = tmp_path / "davis"
    sequences = []
    for si, (sid, n, (h, w)) in enumerate([("seqA", 6, (48, 64)), ("seqB", 7, (48, 64)),
                                           ("seqC", 3, (48, 64)), ("seqD", 5, (40, 56))]):
        (base / sid).mkdir(parents=True)
        paths, segs = [], []
        for t in range(n):
            paths.append(f"{sid}/{t:05d}.jpg")
            cv2.imwrite(str(base / paths[-1]), rng.randint(0, 255, (h, w, 3), np.uint8))
            m = np.zeros((h, w), np.uint8)
            m[8 + si:28 + si, 10 + t:30 + t] = 1
            segs.append({"1": rle.encode(m)["counts"].decode("utf-8")})
        sequences.append({"id": sid, "height": h, "width": w, "image_paths": paths,
                          "categories": {"1": 1}, "segmentations": segs})
    ann = tmp_path / "ann"
    ann.mkdir()
    (ann / "davis_val.json").write_text(json.dumps(
        {"meta": {"category_labels": {"1": "object"}}, "sequences": sequences}))
    return str(base), str(ann), {s["id"]: len(s["image_paths"]) for s in sequences}


def test_cli_data_parallel_byte_equal_to_serial_and_to_jax(tmp_path, monkeypatch):
    base, ann, lengths = write_davis_set(tmp_path)
    ckpt = _make_checkpoint(tmp_path)
    monkeypatch.setenv("DAVIS_BASE_DIR", base)
    monkeypatch.setenv("STEMSEG_JSON_ANNOTATIONS_DIR", ann)
    common = ["--dataset", "davis", "--max_tracks", "5", "--frame_overlap", "2"]

    seen = []
    run_batch = FusedSequencePipeline.run_batch

    def spy(self, frames_batch, windows_batch, devices, **kwargs):
        seen.append((tuple(len(f) for f in frames_batch), tuple(devices)))
        return run_batch(self, frames_batch, windows_batch, devices, **kwargs)

    monkeypatch.setattr(FusedSequencePipeline, "run_batch", spy)
    outs = {}
    for name, extra in (("serial", []), ("parallel", ["--data_parallel"])):
        Timer.reset()
        outs[name] = str(tmp_path / name)
        cli.main([ckpt, "-o", outs[name], *common, "--device", "cpu", *extra])
    # grouped by frame size, chunked to the replicas; seqC (3 frames) runs alone
    assert seen == [((6, 7), ("cpu", "cpu")), ((5,), ("cpu",))]

    JaxTimer.reset()
    outs["jax"] = str(tmp_path / "jax")
    jax_inference_main.main([ckpt, "-o", outs["jax"], *common, "--data_parallel"])

    for sid, n in lengths.items():
        for t in range(n):
            fn = os.path.join("results", sid, f"{t:05d}.png")
            files = {name: open(os.path.join(out, fn), "rb").read()
                     for name, out in outs.items()}
            assert files["parallel"] == files["serial"], fn
            assert files["parallel"] == files["jax"], fn
