"""The readers of the program's own spans and counters
(``benchmark/spans.py`` and the metrics that use it) against hand-made
sessions and device lists, with no session, and on a program without the
recorder; then a tiny traced inference run on the CPU."""

import time

import pytest
import torch

from benchmark import common, spans
from benchmark.tests.tiny import tiny

torch.set_num_threads(2)
MS = 1_000_000  # ns


def span(index, name, start_ms, end_ms, parent=None, stream_ms=None, top=None):
    host = end_ms - start_ms
    return {"name": name, "index": index, "parent": parent, "top": top, "thread": 1,
            "start_ns": start_ms * MS, "end_ns": end_ms * MS, "host_ms": host,
            "stream_ms": stream_ms, "self_ms": host}


# a fused run (0-100 ms) over a state's capture, then its writer (100-130 ms)
INFER = {"spans": [span(0, "fused.run", 0, 100, top=1),
                   span(1, "fused.prelude", 10, 30, 0, stream_ms=19.0, top=1),
                   span(2, "fused.scan_a", 30, 50, 0, stream_ms=18.0, top=1),
                   span(3, "fused.derive", 50, 60, 0, stream_ms=2.0, top=1),
                   span(4, "fused.scan_b", 60, 80, 0, stream_ms=3.0, top=1),
                   span(5, "fused.fetch", 80, 95, 0, top=1),
                   span(6, "writer.sequence", 100, 130, top="s"),
                   span(7, "writer.resize", 100, 110, 6, top="s"),
                   span(8, "writer.encode", 110, 125, 6, top="s")],
         "counters": {"fused.captures": 2, "fused.replays": 7}}
# device busy 2-5, 12-40, 41-52, 70-96, 101-108 ms: idle 0-2 (before the
# first interval) and 5-12 in fused.run alone, 40-41 in scan_a, 52-70
# (middle 61) in scan_b, 96-101 (middle 98.5) in fused.run, 108-130 (after
# the last, middle 119) in writer.encode
DEVICE = [("k", 2 * MS, 5 * MS), ("k", 12 * MS, 40 * MS), ("k", 41 * MS, 52 * MS),
          ("k", 70 * MS, 96 * MS), ("k", 101 * MS, 108 * MS)]
TRAIN = {"spans": [span(0, "step", 0, 100, top=1),
                   span(1, "step.forward", 0, 30, 0, stream_ms=30.0, top=1),
                   span(2, "step.loss", 30, 32, 0, stream_ms=2.0, top=1),
                   span(3, "step.backward", 32, 90, 0, stream_ms=60.0, top=1),
                   span(4, "step.accumulate", 90, 95, 0, stream_ms=4.0, top=1),
                   span(5, "step", 100, 210, top=2),
                   span(6, "step.forward", 100, 130, 5, stream_ms=30.0, top=2),
                   span(7, "step.loss", 130, 132, 5, stream_ms=2.0, top=2),
                   span(8, "step.backward", 132, 190, 5, stream_ms=62.0, top=2),
                   span(9, "step.accumulate", 190, 195, 5, stream_ms=4.0, top=2),
                   span(10, "step.update", 195, 205, 5, stream_ms=10.0, top=2)],
         "counters": {}}
INFER_CTX = {"kind": "infer", "frames": 10, "trace": {"device": DEVICE}}
TRAIN_CTX = {"kind": "train", "clips": 2, "steps": 1, "trace": {}}
WANT = {"fused_model_ms_per_frame": (INFER_CTX, INFER, 3.7),
        "fused_cluster_ms_per_frame": (INFER_CTX, INFER, 0.5),
        "fused_idle_ms_per_frame": (INFER_CTX, INFER, (2 + 7 + 1 + 18 + 5) / 10),
        "writer_encode_ms_per_frame": (INFER_CTX, INFER, 1.5),
        "fused_captures": (INFER_CTX, INFER, 2),
        "forward_ms_per_clip": (TRAIN_CTX, TRAIN, 32.0),
        "backward_ms_per_clip": (TRAIN_CTX, TRAIN, 61.0),
        "update_ms_per_step": (TRAIN_CTX, TRAIN, 18.0)}


def use_session(monkeypatch, records):
    from stemseg_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "last_session", lambda: records)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_by_hand(name, monkeypatch):
    ctx, records, want = WANT[name]
    use_session(monkeypatch, records)
    assert common.read_metrics([name], ctx) == {name: pytest.approx(want)}
    other = TRAIN_CTX if ctx is INFER_CTX else INFER_CTX
    assert common.read_metrics([name], other) == {}  # the other kind's cell


@pytest.mark.parametrize("name", sorted(WANT))
@pytest.mark.parametrize("session", ["none", "empty", "no_recorder"])
def test_reader_without_records_returns_none(name, session, monkeypatch):
    from stemseg_tpu_torch.utils import profiling

    if session == "no_recorder":  # the program before its recorder
        monkeypatch.delattr(profiling, "last_session")
    else:
        use_session(monkeypatch, None if session == "none" else
                    {"spans": [], "counters": {}})
    assert common.read_metrics([name], WANT[name][0]) == {}


def test_idle_goes_to_the_innermost_span():
    got = spans.idle_by_span(DEVICE, INFER, "fused.")
    assert got == pytest.approx({"fused.run": 2 + 7 + 5, "fused.scan_a": 1, "fused.scan_b": 18})
    assert spans.idle_by_span(DEVICE, INFER, "writer.") == pytest.approx({"writer.encode": 22})
    # no device interval: the records' whole extent is one gap, middle 65 ms
    assert spans.idle_by_span([], INFER, "fused.") == pytest.approx({"fused.scan_b": 130})


def test_tiny_traced_inference_run_reads_the_program():
    from benchmark.drivers import infer

    conf, traffic = tiny("stemseg-davis", "davis-val")
    out = infer.run("davis-val-fp32", conf, traffic, 2 ** 31 + 19, 0.5, True,
                    time.perf_counter(), device="cpu")
    records = spans.session()
    runs = spans.named(records, ["fused.run"])
    assert len(runs) == out["attempted"]
    got = common.read_metrics(sorted(WANT), out["ctx"])
    # the CPU times no stream and traces no device: those readers find nothing
    assert set(got) == {"writer_encode_ms_per_frame", "fused_captures"}
    assert got["fused_captures"] == 0
    assert 0 < got["writer_encode_ms_per_frame"] * out["ctx"]["frames"] <= spans.host_ms(
        records, "writer.sequence")
