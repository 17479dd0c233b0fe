"""The port's spans and counters (``utils/profiling.py``) on the CPU, and
the kernels' launch counts on the fused path on a card.

* Off (no profiler recording): a fused run, a ``TrainStep`` micro-step and
  a DAVIS writer sequence enter no ``stemseg.*`` ``record_function`` and
  leave no records.
* On, under a ``torch.profiler`` session: the fused path's, the writer's
  and the train step's spans have the names, order, parents and ids the
  modules document, one ``writer.resize`` and one ``writer.encode`` a
  frame; each record lies inside the profiler's ``stemseg.*`` event of the
  same name (to within 2 ms), the two under 2 ms apart in the median; a
  session's records replace the session before's, back to back too;
  ``write_trace`` prints the totals and counters.
* On a card (``card``): a fused run's ``launch_counts`` equal the
  clustering and lsap kernels' launches in a profiler trace of the same
  run, graph replays included, and the device spans read stream times.

Narrow R-50, windows of 4 frames of 64x96 (frames of 60x90 resized), no
JAX: this file runs on the card too
(``STEMSEG_TEST_TPU=1 python -m pytest tests/test_torch_tracing.py``).
"""

import os
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stemseg_tpu_torch.config import load_config
from stemseg_tpu_torch.inference.main import TrackGenerator
from stemseg_tpu_torch.inference.output_utils import DavisOutputGenerator
from stemseg_tpu_torch.models import build_model, init_random_weights
from stemseg_tpu_torch.training.optim import make_optimizer, trainable_parameters
from stemseg_tpu_torch.training.step import TrainStep
from stemseg_tpu_torch.utils import profiling

torch.set_num_threads(2)

THIN = {
    "input": {"num_frames": 4, "min_dim": 64, "max_dim": 96},
    "model": {
        "backbone": {"type": "R-50-FPN"},
        "embedding_dim_mode": "xyff", "use_seediness_head": True, "use_semseg_head": False,
        "resnets": {"backbone_out_channels": 32, "res2_out_channels": 32,
                    "stem_out_channels": 16, "width_per_group": 8},
        "embeddings": {"embedding_size": 4, "inter_channels": [32, 32, 16, 16],
                       "gn_num_groups": 8},
        "seediness": {"inter_channels": [32, 32, 16, 16], "gn_num_groups": 8},
    },
    "clustering": {"min_seediness_prob": 0.05, "max_instances": 5},
    "training": {"losses": {"embedding": {"free_dim_stds": [0.3, 0.3]}}},
}
HW = (60, 90)
FRAMES = 10  # windows [0-3], [2-5], [4-7], [6-9] at an overlap of 2
WINDOWS = 4
TOLERANCE_NS = 2_000_000


class Seq:
    def __init__(self, seq_id, n):
        self.id, self._n, self.image_dims = seq_id, n, HW

    def __len__(self):
        return self._n


def frames(seed, n=FRAMES):
    return (np.random.RandomState(seed).rand(n, *HW, 3) * 255).astype(np.uint8)


@pytest.fixture(scope="module")
def cfg():
    return load_config(THIN)


def track_generator(cfg, out_dir, device="cpu"):
    model = build_model(cfg, device=device)
    init_random_weights(model, 3)
    writer = DavisOutputGenerator(str(out_dir), device=device)
    return TrackGenerator(cfg, "davis", model, writer, max_tracks=4, frame_overlap=2)


def run_sequence(tg, seq_id, seed):
    tg._process_loaded(Seq(seq_id, FRAMES), frames(seed), HW, tg.max_tracks)


def train_step(cfg):
    model = build_model(cfg, device="cpu", for_training=True)
    init_random_weights(model, 3)
    optimizer, scheduler = make_optimizer(cfg.training, trainable_parameters(model))
    return TrainStep(model, cfg, optimizer, scheduler, accumulate_steps=2)


def batch(seed, t=4, h=64, w=96):
    rng = np.random.RandomState(seed)
    masks = np.zeros((1, 2, t, h, w), np.uint8)
    masks[0, 0, :, 8:30, 10:40] = 1
    masks[0, 1, :, 34:60, 50:90] = 1
    return {"images": torch.from_numpy(rng.randn(1, t, h, w, 3).astype(np.float32) * 40),
            "masks": torch.from_numpy(masks),
            "ignore_masks": torch.zeros((1, t, h, w), dtype=torch.uint8),
            "category_ids": torch.tensor([[1, 1]], dtype=torch.int32)}


def names(records, top=None):
    return [s["name"] for s in records["spans"] if top is None or s["top"] == top]


# -- off -------------------------------------------------------------------------


@pytest.mark.parametrize("work", ["fused_and_writer", "train_step", "writer"])
def test_off_enters_no_record_function_and_keeps_no_records(cfg, tmp_path, monkeypatch,
                                                             work):
    entered = []
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        if name.startswith(profiling.PREFIX):
            entered.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    recorder = profiling._recorder
    profiling.last_session()  # ends a session an earlier profiler left open
    last = recorder.last
    assert not torch.autograd._profiler_enabled()
    if work == "fused_and_writer":
        run_sequence(track_generator(cfg, tmp_path), "s", 1)
    elif work == "train_step":
        train_step(cfg)(batch(0))
    else:
        labels = np.random.RandomState(0).randint(-1, 3, (FRAMES, 16, 24)).astype(np.int32)
        DavisOutputGenerator(str(tmp_path), device="cpu").process_sequence(
            Seq("w", FRAMES), labels, {1: 5, 2: 4}, {1: 9, 2: 8}, None, mask_scale=4,
            max_tracks=4, min_dim=64, max_dim=96)
        assert len(os.listdir(tmp_path / "results" / "w")) == FRAMES
    assert entered == []
    assert recorder.current is None and recorder.last is last


# -- on --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fused_session(cfg, tmp_path_factory):
    """Two DAVIS sequences (the fused path, then the writer) under one
    profiler session: (records, the profiler's stemseg.* events)."""
    tg = track_generator(cfg, tmp_path_factory.mktemp("fused"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_sequence(tg, "a", 1)
        run_sequence(tg, "b", 2)
    return profiling.last_session(), stemseg_events(prof)


@pytest.fixture(scope="module")
def step_session(cfg):
    """Two micro-steps of one optimizer step under one profiler session."""
    step = train_step(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(batch(0))
        step(batch(1))
    return profiling.last_session(), stemseg_events(prof)


def stemseg_events(prof):
    return [(e.name()[len(profiling.PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(profiling.PREFIX)]


def test_fused_run_spans_names_order_parents_and_ids(fused_session):
    records, _ = fused_session
    per_run = (["fused.load", "fused.prelude"] + ["fused.scan_a"] * WINDOWS
               + ["fused.derive"] + ["fused.scan_b"] * WINDOWS
               + ["fused.fetch", "fused.track_stats"])
    assert names(records, top=1) == ["fused.run", "fused.new_state"] + per_run
    assert names(records, top=2) == ["fused.run"] + per_run  # the state is kept
    spans = records["spans"]
    for s in spans:
        if s["name"] == "fused.run":
            assert spans[s["parent"]]["name"] == "cli.inference"
        elif s["name"].startswith("fused."):
            parent = spans[s["parent"]]
            assert parent["name"] == "fused.run" and parent["top"] == s["top"]
    cli = [s for s in spans if s["name"] == "cli.inference"]
    assert len(cli) == 2 and all(s["parent"] is None and s["top"] is None for s in cli)
    run = next(s for s in spans if s["name"] == "fused.run")
    children = [s for s in spans if s["parent"] == run["index"]]
    assert run["self_ms"] == pytest.approx(run["host_ms"] - sum(c["host_ms"] for c in children))
    assert all(s["stream_ms"] is None for s in spans)  # host-only on the CPU
    assert records["counters"] == {}  # no graph on the CPU


def test_writer_spans_one_resize_and_one_encode_a_frame(fused_session):
    records, _ = fused_session
    spans = records["spans"]
    for seq_id in ("a", "b"):
        seq = [s for s in spans if s["top"] == seq_id]
        assert seq[0]["name"] == "writer.sequence" and seq[0]["parent"] is None
        assert [s["name"] for s in seq[1:]] == ["writer.resize", "writer.encode"] * FRAMES
        assert all(s["parent"] == seq[0]["index"] for s in seq[1:])
    order = [s["name"] for s in spans if s["parent"] is None]
    assert order == ["cli.inference", "writer.sequence"] * 2


def test_train_step_spans_names_order_parents_and_ids(step_session):
    records, _ = step_session
    micro = ["step.forward", "step.loss", "step.backward", "step.accumulate"]
    assert names(records, top=1) == ["step"] + micro
    assert names(records, top=2) == ["step"] + micro + ["step.update"]  # the update is due
    spans = records["spans"]
    for s in spans:
        if s["name"] == "step":
            assert s["parent"] is None
        else:
            assert spans[s["parent"]]["name"] == "step" and spans[s["parent"]]["top"] == s["top"]


@pytest.mark.parametrize("which", ["fused_session", "step_session"])
def test_records_lie_within_2_ms_of_the_profiler_events(which, request):
    """The recorder stamps inside the profiler's ``record_function``, so on
    one clock each record lies inside its event, and the two are a few tens
    of microseconds apart. A stall of the host between a profiler stamp and
    the recorder's (a GC pass, another process on the core: 4-15 ms
    measured on a loaded host) only widens the event."""
    records, events = request.getfixturevalue(which)
    by_name = {}
    for name, start, end in sorted(events, key=lambda e: e[1]):
        by_name.setdefault(name, []).append((start, end))
    mine = {}
    for s in sorted(records["spans"], key=lambda s: s["start_ns"]):
        mine.setdefault(s["name"], []).append((s["start_ns"], s["end_ns"]))
    assert mine.keys() == by_name.keys()
    apart = []
    for name, spans in mine.items():
        assert len(spans) == len(by_name[name]), name
        for (s, e), (ps, pe) in zip(spans, by_name[name]):
            assert ps - TOLERANCE_NS < s <= e < pe + TOLERANCE_NS, name
            apart += [s - ps, pe - e]
    assert statistics.median(apart) < TOLERANCE_NS


def test_a_session_replaces_the_one_before(tmp_path, capsys):
    device = torch.device("cpu")
    prof = profiling.start_trace(device)
    with profiling.span("first", ident=7):
        profiling.count("things", 3)
    profiling.write_trace(prof, str(tmp_path), device)
    printed = capsys.readouterr().out
    assert "span stemseg.first: 1 calls" in printed and "counter stemseg.things: 3" in printed
    first = profiling.last_session()
    assert names(first) == ["first"] and first["counters"] == {"things": 3}
    assert first["spans"][0]["top"] == 7

    prof = profiling.start_trace(device)
    with profiling.span("second"):
        pass
    prof.stop()
    with profiling.span("after"):  # the profiler has stopped: no record
        pass
    assert names(profiling.last_session()) == ["second"]

    for name in ("third", "fourth"):  # back to back, nothing read between
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span(name):
                pass
    assert names(profiling.last_session()) == ["fourth"]
    assert profiling.last_session()["counters"] == {}


# -- on a card -------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
def test_fused_launch_counts_equal_the_profiled_launches(cfg, tmp_path, card):
    from stemseg_tpu_torch.ops import cluster, lsap

    tg = track_generator(cfg, tmp_path, device="cuda")
    run_sequence(tg, "warm", 0)  # eager, captures and replays before the session
    for attempt in range(2):  # the profiler has been seen to lose a launch
        cluster.reset_launch_counts()
        lsap.reset_launch_counts()
        captures = tg.fused.captures
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_sequence(tg, f"s{attempt}", attempt + 1)
            torch.cuda.synchronize()
        device = {"cluster_kernel": 0, "lsa_kernel": 0}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                for name in device:
                    device[name] += name in evt.name
        host = {"cluster_kernel": cluster.launch_counts["cluster_points_single"]
                + cluster.launch_counts["cluster_points_tiled"],
                "lsa_kernel": lsap.launch_counts["lsa_masked"]}
        if device == host:
            break
    assert host == device == {"cluster_kernel": WINDOWS, "lsa_kernel": WINDOWS}
    records = profiling.last_session()
    assert records["counters"].get("fused.captures", 0) == tg.fused.captures - captures
    assert records["counters"]["fused.replays"] == 1 + 2 * WINDOWS
    streamed = [s for s in records["spans"] if s["name"] in (
        "fused.prelude", "fused.scan_a", "fused.derive", "fused.scan_b")]
    assert len(streamed) == 2 + 2 * WINDOWS
    assert all(s["stream_ms"] is not None and s["stream_ms"] > 0 for s in streamed)
    assert all(s["stream_ms"] is None for s in records["spans"] if s not in streamed)
