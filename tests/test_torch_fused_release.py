"""The fused path's cache releases on a card (``card``).

``davis_2`` at full width (R-101-FPN, 16-frame windows at an overlap of 6,
480x854 frames padded to 704x1248) with random weights: a 104-frame
warm-up sequence, then a 69- and a 50-frame one, whose last windows bring
3 and 4 new frames, shapes the warm-up did not run, then the 104 frames
again, which only capture and replay. Each run that warmed a body up
releases once, and after each release the caching allocator's general
pool holds under 1 GiB of free blocks (``torch.cuda.memory_snapshot``:
the segments outside the graph pool); the last run releases nothing; the
``fused.cache_releases`` counter equals the runs that warmed a body up;
and each sequence's labels equal the streaming path's bit for bit. Then
``run_batch`` with two slots on the one card, in bf16 (two pipelines'
graph pools fit beside each other), whose threads warm up, release and
capture at the same time: its labels equal ``run``'s, and since each slot
keeps its host thread, its second and third calls warm no body up and
release nothing.

On the CPU nothing is released (``test_torch_tracing.py``). No JAX: run on
the card with ``STEMSEG_TEST_TPU=1 python -m pytest
tests/test_torch_fused_release.py``.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stemseg_tpu_torch.config import load_preset, merge
from stemseg_tpu_torch.inference.fused_pipeline import FusedSequencePipeline
from stemseg_tpu_torch.inference.main import TrackGenerator
from stemseg_tpu_torch.models import build_model, init_random_weights
from stemseg_tpu_torch.utils import profiling

HW = (480, 854)
LENGTHS = (104, 69, 50, 104)  # last windows of 8, 3, 4 and 8 new frames
GIB = 2 ** 30


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def general_free_bytes():
    return sum(s["total_size"] - s["allocated_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == (0, 0))


def host_labels(labels):
    return (labels.cpu().numpy() if torch.is_tensor(labels) else labels).astype(np.int32)


@pytest.mark.card
def test_card_releases_once_a_run_that_warmed_up_and_keeps_the_labels(card, monkeypatch):
    cfg = merge(load_preset("davis_2"), {"clustering": {"min_seediness_prob": 0.05}})
    model = build_model(cfg, device="cuda")
    init_random_weights(model, 5)
    tg = TrackGenerator(cfg, "davis", model, None, cfg.data.davis.max_inference_tracks)
    pool = np.random.RandomState(7).randint(0, 256, (max(LENGTHS),) + HW + (3,), np.uint8)

    free_after = []
    empty_cache = torch.cuda.empty_cache

    def release():
        empty_cache()
        free_after.append(general_free_bytes())

    monkeypatch.setattr(torch.cuda, "empty_cache", release)
    fused, warm, releases = [], [0], []
    with profile(activities=[ProfilerActivity.CPU]):
        for n in LENGTHS:
            fused.append(host_labels(tg.do_fused(pool[:n], HW)[0]))
            warm.append(len(tg.fused._state.warm))  # one key for each body run eagerly
            releases.append(len(free_after))
    monkeypatch.undo()
    records = profiling.last_session()

    assert tg.fused.states_made == 1 and warm[-1] >= 7  # prelude, A at 0, 10, 8, 3, 4 new, B
    warmed = [b > a for a, b in zip(warm, warm[1:])]
    assert warmed == [True, True, True, False], warm
    assert releases == list(np.cumsum(warmed)), releases
    assert records["counters"]["fused.cache_releases"] == sum(warmed)
    assert max(free_after) < GIB, [f / GIB for f in free_after]
    for n, labels in zip(LENGTHS, fused):
        streaming = host_labels(tg.do_clustering(tg.do_inference(pool[:n], HW))[0])
        assert np.array_equal(labels, streaming), n


@pytest.mark.card
def test_card_run_batch_with_two_slots_on_one_card_equals_run(card, monkeypatch):
    cfg = merge(load_preset("davis_2"), {"clustering": {"min_seediness_prob": 0.05}})
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16)
    init_random_weights(model, 5)
    tg = TrackGenerator(cfg, "davis", model, None, cfg.data.davis.max_inference_tracks)
    pool = np.random.RandomState(8).randint(0, 256, (40,) + HW + (3,), np.uint8)
    seqs = [pool, pool[6:]]  # last windows of 4 and 8 new frames
    windows = [tg._schedule(len(f), HW)[0] for f in seqs]
    kwargs = dict(seediness_fg_threshold=tg.seediness_thresh,
                  semseg_output_type=tg.semseg_output_type,
                  resize_hw=tg._schedule(len(pool), HW)[1])
    releases = []
    release_cache = FusedSequencePipeline.release_cache

    def counted(self):
        releases.append(id(self))
        release_cache(self)

    monkeypatch.setattr(FusedSequencePipeline, "release_cache", counted)
    slots = [tg.fused.replica(i, "cuda:0") for i in range(2)]
    # warm-ups and releases, captures, replays
    batches, warm, released = [], [], []
    for _ in range(3):
        batches.append(tg.fused.run_batch(seqs, windows, ["cuda:0", "cuda:0"], **kwargs))
        warm.append([len(pipe._state.warm) for pipe in slots])
        released.append(len(releases))
    monkeypatch.undo()
    assert slots[1].captures > 0
    assert warm[1] == warm[2] == warm[0], warm  # one key a body run eagerly
    assert released == [2, 2, 2] and sorted(releases) == sorted(map(id, slots)), released
    single = [tg.fused.run(f, w, **kwargs)[0] for f, w in zip(seqs, windows)]
    for batch in batches:
        for got, want in zip(batch, single):
            assert np.array_equal(got[0], want)
