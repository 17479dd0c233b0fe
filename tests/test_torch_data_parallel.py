"""Data-parallel serving in the port: ``FusedSequencePipeline.run_batch``
(one sequence per device, a pipeline and a host thread each) and the
inference CLI's ``--data_parallel``, on the CPU:

* ``run_batch`` over ``["cpu", "cpu"]`` equals the per-sequence ``run``
  exactly (labels, counts, lifetimes, fg and multiclass masks), on
  sequences of mixed lengths, twice with the replica kept; a sequence's
  failure is raised;
* ``run_batch`` runs slot 0 on the calling thread and slot 1 on one
  thread of its pipeline's own in every call, a thread that exits once
  the pipeline is dropped;
* ``run_batch`` over four slots, sequences of four lengths, equals
  ``run`` on each;
* the CLI's ``--data_parallel`` (``CPU_DATA_PARALLEL`` replicas on the CPU;
  two sequences of one frame size, one of another, one shorter than the
  window, which takes the streaming path) writes DAVIS PNGs byte-equal to
  its serial run and to the JAX CLI's ``--data_parallel`` on the same JAX
  ``.ckpt`` (``tests/test_inference_cli.py``'s data-parallel case, which
  the JAX suite marks slow, with a second frame size);
* the same over four devices (CPU devices standing in for four cards):
  nine sequences of two frame sizes and a short one, chunked and ordered
  as on four cards, the PNGs byte-equal to the serial CLI's.
"""

import json
import os
import threading

import cv2
import numpy as np
import pytest
import torch

from stemseg_tpu.inference import main as jax_inference_main
from stemseg_tpu.utils.timer import Timer as JaxTimer
from stemseg_tpu_torch.config import load_config, save_config
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
            np.testing.assert_array_equal(g[4].numpy(), w[4].numpy())
    assert list(pipe._replicas) == [(1, torch.device("cpu"))]
    replica = pipe._replicas[(1, torch.device("cpu"))]
    assert replica.engine.model is not pipe.engine.model

    with pytest.raises(TypeError, match="raw uint8"):
        pipe.run_batch([seqs[0], seqs[1].astype(np.float32)], windows[:2], ["cpu", "cpu"],
                       resize_hw=HW)


def test_run_batch_keeps_one_host_thread_per_slot(pipe, monkeypatch):
    """Over two ``run_batch`` calls, slot 0's pipeline runs on the calling
    thread and slot 1's on one worker thread, the same in both calls; once
    the pipelines are dropped, that thread exits."""
    rng = np.random.RandomState(5)
    seqs = [(rng.rand(n, 60, 90, 3) * 255).astype(np.uint8) for n in (8, 9)]
    windows = [get_subsequence_frames(len(f), 4, 2) for f in seqs]
    threads = {}  # id of the pipeline -> the threads its runs ran on
    run = FusedSequencePipeline.run

    def spy(self, *args, **kwargs):
        threads.setdefault(id(self), []).append(threading.current_thread())
        return run(self, *args, **kwargs)

    monkeypatch.setattr(FusedSequencePipeline, "run", spy)
    batched = FusedSequencePipeline(pipe.engine, pipe.cluster_params)
    slots = [id(batched.replica(i, "cpu")) for i in range(2)]
    for _ in range(2):
        batched.run_batch(seqs, windows, ["cpu", "cpu"], resize_hw=HW)
    assert threads[slots[0]] == [threading.current_thread()] * 2
    worker = threads[slots[1]][0]
    assert threads[slots[1]] == [worker] * 2 and worker is not threading.current_thread()
    assert worker.is_alive()

    del batched  # its only holder: no cyclic GC needed
    worker.join(timeout=30)
    assert not worker.is_alive()


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


def test_run_batch_over_four_slots_equals_per_sequence_run(pipe):
    """Four slots, as ``--data_parallel`` makes on four cards, each a
    sequence of another length: each result equals ``run`` on it."""
    rng = np.random.RandomState(4)
    seqs = [(rng.rand(n, 60, 90, 3) * 255).astype(np.uint8) for n in (11, 8, 13, 9)]
    windows = [get_subsequence_frames(len(f), 4, 2) for f in seqs]
    assert len({len(w) for w in windows}) > 1
    want = [pipe.run(f, w, resize_hw=HW) for f, w in zip(seqs, windows)]
    got = pipe.run_batch(seqs, windows, ["cpu"] * 4, resize_hw=HW)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        assert g[1] == w[1] and g[2] == w[2]
        np.testing.assert_array_equal(g[3], w[3])
        np.testing.assert_array_equal(g[4].numpy(), w[4].numpy())
    assert {key for key in pipe._replicas if key[0] > 1} == {(2, torch.device("cpu")),
                                                            (3, torch.device("cpu"))}


# nine sequences of two frame sizes, in an order that mixes the sizes, and a
# short one (3 frames, below the window) among them: (id, frames, (h, w))
FOUR_DEVICE_SET = [("a0", 6, (48, 64)), ("b0", 5, (40, 56)), ("a1", 7, (48, 64)),
                   ("a2", 4, (48, 64)), ("short", 3, (48, 64)), ("b1", 8, (40, 56)),
                   ("a3", 5, (48, 64)), ("b2", 6, (40, 56)), ("a4", 9, (48, 64)),
                   ("b3", 4, (40, 56))]


def test_cli_data_parallel_on_four_devices(tmp_path, monkeypatch):
    """``--data_parallel`` over four devices (CPU devices standing in for
    cards): sequences grouped by frame size in the order each size first
    appears, each group in chunks of four in dataset order, the short one
    last on the streaming path; every PNG byte-equal to the serial CLI's."""
    rng = np.random.RandomState(2)
    base = tmp_path / "davis"
    sequences = []
    for sid, n, (h, w) in FOUR_DEVICE_SET:
        (base / sid).mkdir(parents=True)
        paths = []
        for t in range(n):
            paths.append(f"{sid}/{t:05d}.jpg")
            cv2.imwrite(str(base / paths[-1]), rng.randint(0, 255, (h, w, 3), np.uint8))
        sequences.append({"id": sid, "height": h, "width": w, "image_paths": paths,
                          "categories": {}, "segmentations": [{} for _ in paths]})
    ann = tmp_path / "ann"
    ann.mkdir()
    (ann / "davis_val.json").write_text(json.dumps(
        {"meta": {"category_labels": {"1": "object"}}, "sequences": sequences}))
    cfg = load_config({**OVER, "input": {"num_frames": 4, "num_classes": 2, "min_dim": 32,
                                         "max_dim": 48},
                       "clustering": {"min_seediness_prob": 0.0, "max_instances": 5}})
    model = build_model(cfg, device="cpu")
    init_random_weights(model, 5)
    (tmp_path / "model").mkdir()
    pth = str(tmp_path / "model" / "davis.pth")
    torch.save({"model": model.state_dict()}, pth)
    save_config(cfg, str(tmp_path / "model" / "config.yaml"))
    monkeypatch.setenv("DAVIS_BASE_DIR", str(base))
    monkeypatch.setenv("STEMSEG_JSON_ANNOTATIONS_DIR", str(ann))
    monkeypatch.setattr(cli, "CPU_DATA_PARALLEL", 4)

    seen, short_runs = [], []
    run_batch, process_loaded = FusedSequencePipeline.run_batch, cli.TrackGenerator._process_loaded

    def spy(self, frames_batch, windows_batch, devices, **kwargs):
        seen.append((tuple(len(f) for f in frames_batch), tuple(devices)))
        return run_batch(self, frames_batch, windows_batch, devices, **kwargs)

    def spy_loaded(self, sequence, *args, **kwargs):
        short_runs.append(str(sequence.id))
        return process_loaded(self, sequence, *args, **kwargs)

    monkeypatch.setattr(FusedSequencePipeline, "run_batch", spy)
    monkeypatch.setattr(cli.TrackGenerator, "_process_loaded", spy_loaded)
    outs = {}
    for name, extra in (("serial", []), ("parallel", ["--data_parallel"])):
        Timer.reset()
        outs[name] = str(tmp_path / name)
        short_runs.clear()
        cli.main([pth, "-o", outs[name], "--dataset", "davis", "--max_tracks", "5",
                  "--frame_overlap", "2", "--device", "cpu", *extra])
    four = ("cpu",) * 4
    assert seen == [((6, 7, 4, 5), four), ((9,), ("cpu",)), ((5, 8, 6, 4), four)]
    assert short_runs == ["short"]
    n_files = 0
    for sid, n, _ in FOUR_DEVICE_SET:
        for t in range(n):
            fn = os.path.join("results", sid, f"{t:05d}.png")
            with open(os.path.join(outs["serial"], fn), "rb") as a, \
                    open(os.path.join(outs["parallel"], fn), "rb") as b:
                assert a.read() == b.read(), fn
            n_files += 1
    assert n_files == 57
