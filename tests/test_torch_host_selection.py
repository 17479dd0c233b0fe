"""The embedding loss's instance rows, chosen on the host.

* ``step.kept_rows`` (the loader's rule, no resize) equals the rows that
  keep a pixel in ``prepare_targets``'s own ÷``scale`` masks, on crafted
  masks (1- and 2-pixel lines, 2x2 blocks at every offset, a single pixel,
  a row that vanishes at ÷4, all-zero padded rows, N = 2 with different
  counts) and on random blobs, at scale 4 and at scale 1
  (``loss_at_full_res``); ``collate_batch`` hands the rows over with the
  device keys and the counts as host ints, through ``to_device`` too.
* ``embedding_loss`` with the host's rows returns the total, the three
  terms and the gradient of a copy of the selection it had before
  (``torch.nonzero`` on the device), bit for bit, over a batch with a row
  that vanishes at ÷4 and a sequence with no kept instance.
* On a card (``card``): after one warm micro-step, two micro-steps and an
  update of a narrow ``youtube_vis`` ``TrainStep``, from pinned batches
  through ``to_device``, make no synchronising call; under a profiler,
  ``loss.host_selection`` counts each micro-step's sequence.

No JAX: this file runs on the card too
(``STEMSEG_TEST_TPU=1 python -m pytest tests/test_torch_host_selection.py``).
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from stemseg_tpu_torch.config import load_preset, merge, resolve_max_instances
from stemseg_tpu_torch.data.synthetic import SyntheticBlobDataset
from stemseg_tpu_torch.losses import EmbeddingLossParams, embedding_loss, free_bandwidths
from stemseg_tpu_torch.losses.lovasz import lovasz_hinge
from stemseg_tpu_torch.models import build_model, init_random_weights
from stemseg_tpu_torch.training.loader import (
    DEVICE_KEYS,
    collate_batch,
    kept_instances,
    make_data_loader,
    to_device,
)
from stemseg_tpu_torch.training.optim import make_optimizer, trainable_parameters
from stemseg_tpu_torch.training.step import TrainStep, kept_rows, prepare_targets, target_scale
from stemseg_tpu_torch.utils import profiling
from stemseg_tpu_torch.utils.constants import LossConsts

torch.set_num_threads(2)

T, H, W = 2, 32, 48


def steps_rows(masks, scale):
    """The rows that keep a pixel after the step's own ÷``scale``."""
    n = masks.shape[0]
    ds = prepare_targets(torch.from_numpy(masks).float(),
                         torch.zeros((n,) + masks.shape[2:]),
                         torch.zeros(masks.shape[:2], dtype=torch.int32), scale)[0]
    return [np.flatnonzero(row) for row in (ds.flatten(2).sum(-1) > 0).numpy()]


def crafted(case):
    """[N, I, T, H, W] uint8 masks of one crafted case."""
    masks = np.zeros((2 if case == "two_sequences" else 1, 6, T, H, W), np.uint8)
    m = masks[0]
    if case == "lines":
        m[0, 0, 9, 4:30] = 1  # one pixel high
        m[1, 1, 14:16, 8:40] = 1  # two pixels high, rows 14-15: not a 4i+1, 4i+2 pair
        m[2, 0, 17:19, 8:40] = 1  # rows 17-18: a pair
        m[3, 0, 4:28, 22] = 1  # one pixel wide
        m[4, 1, 4:28, 25:27] = 1  # columns 25-26: a pair
    elif case == "blocks":
        # a 2x2 block at every offset (0-3, 0-3) of the ÷4 grid, one row each
        masks = np.zeros((1, 16, T, H, W), np.uint8)
        for k in range(16):
            dy, dx = divmod(k, 4)
            masks[0, k, k % T, 8 + dy:10 + dy, 20 + dx:22 + dx] = 1
    elif case == "single_pixel":
        m[0, 1, 5, 5] = 1
        m[2, 0, 0, 0] = 1
    elif case == "vanishes":
        m[0, :, 8:20, 8:24] = 1  # kept
        m[1, :, 4:7, 3:40] = 1  # rows 4-6 hold the pair 5-6: kept
        m[2, :, 2:5, 2:40] = 1  # rows 2-4 hold no pair: gone
        m[3, 0, 12:32, 12] = 1
        m[3, 1, 12, 12:40] = 1  # a cross of 1-pixel lines: gone
    elif case == "padded":
        m[0, :, 4:12, 4:12] = 1
        m[2, 1, 20:30, 30:44] = 1  # rows 1, 3, 4, 5 all-zero
    elif case == "two_sequences":
        masks[0, 0, :, 4:12, 4:12] = 1
        masks[0, 1, :, 2:4, 2:4] = 1  # gone at ÷4
        for k in range(4):
            masks[1, k, :, 8 * k:8 * k + 6, 5:20] = 1
    elif case == "random":
        rng = np.random.RandomState(3)
        masks = np.zeros((2, 8, T, H, W), np.uint8)
        for n in range(2):
            for k in range(rng.randint(1, 9)):
                for t in range(T):
                    y, x = rng.randint(0, H - 1), rng.randint(0, W - 1)
                    masks[n, k, t, y:y + rng.randint(1, 7), x:x + rng.randint(1, 7)] = 1
        masks[1, 2] = rng.rand(T, H, W) > 0.7  # ragged
    return masks


CASES = ["lines", "blocks", "single_pixel", "vanishes", "padded", "two_sequences", "random"]


@pytest.mark.parametrize("scale", [4, 1])
@pytest.mark.parametrize("case", CASES)
def test_the_loaders_rule_equals_the_steps_downscale(case, scale):
    masks = crafted(case)
    want = steps_rows(masks, scale)
    got = [kept_rows(masks[n], scale) for n in range(len(masks))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rows, counts = kept_instances(masks, scale)
    assert counts == [len(w) for w in want]
    for n, w in enumerate(want):
        np.testing.assert_array_equal(rows[n, :counts[n]], w)
        assert not rows[n, counts[n]:].any()


def test_the_crafted_cases_cut_where_they_should():
    """The cases test what they say: a 2-pixel run keeps only on the
    block's middle pair, and a row can vanish at ÷4 but not at full size."""
    assert list(steps_rows(crafted("lines"), 4)[0]) == [2, 4]
    assert list(steps_rows(crafted("lines"), 1)[0]) == [0, 1, 2, 3, 4]
    assert list(steps_rows(crafted("single_pixel"), 4)[0]) == []
    assert list(steps_rows(crafted("padded"), 4)[0]) == [0, 2]
    assert list(steps_rows(crafted("blocks"), 4)[0]) == [5]  # offset (1, 1) alone
    assert list(steps_rows(crafted("vanishes"), 4)[0]) == [0, 1]
    assert list(steps_rows(crafted("vanishes"), 1)[0]) == [0, 1, 2, 3]
    assert [len(r) for r in steps_rows(crafted("two_sequences"), 4)] == [1, 4]


def test_the_rule_refuses_masks_that_do_not_divide_by_the_scale():
    with pytest.raises(ValueError, match="divide"):
        kept_rows(np.zeros((2, T, 30, 48), np.uint8), 4)


def synthetic_samples(n, seed):
    cfg = merge(load_preset("youtube_vis"), {"input": {"num_frames": T}})
    ds = SyntheticBlobDataset(cfg.input, n, height=H - 5, width=W - 7, max_instances=4,
                              seed=seed)
    return [ds[i] for i in range(n)]


@pytest.mark.parametrize("scale", [4, 1])
def test_collate_batch_hands_the_kept_rows_over(scale):
    samples = synthetic_samples(3, 5)
    samples[1]["masks"] = samples[1]["masks"][:1]  # fewer instances than the others
    samples[1]["category_ids"] = samples[1]["category_ids"][:1]
    samples[2]["masks"][0, :, 1:3] = 0  # still a row, perhaps thinner
    batch = collate_batch(samples, max_instances=6, scale=scale)
    assert set(DEVICE_KEYS) <= set(batch) and batch["kept_rows"].dtype == torch.int64
    want = steps_rows(batch["masks"].numpy(), scale)
    assert batch["kept_counts"] == [len(w) for w in want]
    for n, w in enumerate(want):
        np.testing.assert_array_equal(batch["kept_rows"][n, :len(w)].numpy(), w)
    placed = to_device(batch, torch.device("cpu"))
    assert set(placed) == set(DEVICE_KEYS) | {"kept_counts"}
    assert placed["kept_counts"] == tuple(batch["kept_counts"])
    assert all(type(c) is int for c in placed["kept_counts"])


# -- the loss against its selection on the device --------------------------------


def _device_selection_per_sequence(emb, bw, seed, masks, ignore, free_bandwidths):
    p = seed.numel()
    m = masks.reshape(masks.shape[0], p)
    counts = m.sum(dim=1)
    present = torch.nonzero(counts > 0).squeeze(1)
    n = int(present.numel())
    if n == 0:
        return None
    m, counts = m.index_select(0, present), counts.index_select(0, present)
    e_flat, bw_flat, s = emb.reshape(-1, p), bw.reshape(-1, p), seed.reshape(p)
    v = bw_flat.shape[0]
    centers = (m @ e_flat.T) / counts[:, None]
    bw_mean_act = (m @ (torch.exp(bw_flat) * 10.0).T) / counts[:, None]
    bw_mean_raw = (m @ bw_flat.T) / counts[:, None]
    sq_dev = (bw_flat[None] - bw_mean_raw[:, :, None]) ** 2
    smooth_i = (m[:, None] * sq_dev).sum(dim=(1, 2)) / (counts * v)
    smoothness = smooth_i.sum() / n
    full_bw = torch.cat([bw_mean_act, free_bandwidths.expand(n, -1)], dim=1)
    d2 = ((e_flat[None] - centers[:, :, None]) ** 2 * full_bw[:, :, None]).sum(dim=1)
    probs = torch.exp(-0.5 * d2)
    lovasz_sum = lovasz_hinge(probs * 2.0 - 1.0, m).sum()
    fg_mse = ((m * (s[None] - probs.detach()) ** 2).sum(dim=1) / counts).sum()
    bg = 1.0 - m.amax(dim=0)
    bg_sq = torch.where(ignore.reshape(p) > 0, 0.0, s ** 2)
    bg_mse = (bg * bg_sq).sum() / bg.sum().clamp(min=1.0)
    return lovasz_sum, fg_mse + bg_mse, smoothness, n


def device_selection_loss(embedding_map, masks, ignore_masks, params):
    """The selection on the device (``torch.nonzero`` and a read-back), as
    the loss made it before the host chose the rows."""
    e = params.embedding_size
    v = e - params.n_free_dims
    free_bw = torch.tensor([1.0 / (s ** 2) for s in params.free_dim_stds],
                           dtype=torch.float32, device=embedding_map.device)
    zero = (embedding_map * 0.0).sum()
    lovasz_sum = seed_sum = smooth_sum = zero
    total_instances = 0
    for i in range(embedding_map.shape[0]):
        terms = _device_selection_per_sequence(embedding_map[i, :e], embedding_map[i, e:e + v],
                                     embedding_map[i, e + v], masks[i], ignore_masks[i],
                                     free_bw)
        if terms is None:
            continue
        lovasz_sum = lovasz_sum + terms[0]
        seed_sum = seed_sum + terms[1]
        smooth_sum = smooth_sum + terms[2]
        total_instances += terms[3]
    n_sequences = masks.shape[0]
    if total_instances == 0:
        lovasz = smoothness = seediness = zero
    else:
        lovasz = lovasz_sum / total_instances
        smoothness = smooth_sum / n_sequences
        seediness = seed_sum / (total_instances + 1.0)
    total = (lovasz * params.weight_lovasz
             + smoothness * params.weight_variance_smoothness
             + seediness * params.weight_seediness) * params.weight
    return total, {LossConsts.LOVASZ_LOSS: lovasz, LossConsts.VARIANCE_SMOOTHNESS: smoothness,
                   LossConsts.SEEDINESS_LOSS: seediness}


@pytest.mark.parametrize("mode", ["xyff", "xyt"])
def test_loss_with_host_rows_equals_the_device_selection_bit_for_bit(mode):
    e, n_free, stds = {"xyff": (4, 2, (0.3, 0.3)), "xyt": (3, 0, ())}[mode]
    params = EmbeddingLossParams(embedding_size=e, n_free_dims=n_free, free_dim_stds=stds)
    full = np.zeros((3, 5, T, H, W), np.uint8)
    full[0, 0, :, 4:20, 8:30] = 1
    full[0, 1, :, 2:5, 2:40] = 1  # vanishes at ÷4
    full[0, 3, :, 18:31, 30:47] = 1  # after a vanished and an empty row
    full[1, 0, :, 2:4, 2:4] = 1  # sequence 1 keeps nothing
    full[2] = crafted("random")[0, :5]
    ignore = np.zeros((3, T, H, W), np.uint8)
    ignore[2, :, :, -8:] = 1
    masks, ignore_ds, _ = prepare_targets(torch.from_numpy(full).float(),
                                          torch.from_numpy(ignore).float(),
                                          torch.zeros((3, 5), dtype=torch.int32))
    rows, counts = kept_instances(full, 4)
    assert counts[0] == 2 and counts[1] == 0 and counts[2] > 0

    rng = np.random.RandomState(1)
    out = np.concatenate([rng.randn(3, e, T, H // 4, W // 4) * 0.3,
                          rng.randn(3, e - n_free, T, H // 4, W // 4) * 0.3 - 1.0,
                          rng.rand(3, 1, T, H // 4, W // 4)], axis=1).astype(np.float32)
    results = []
    for host in (True, False):
        x = torch.from_numpy(out).requires_grad_(True)
        if host:
            total, terms = embedding_loss(x, masks, ignore_ds, params,
                                          free_bandwidths(params, "cpu"),
                                          torch.from_numpy(rows), counts)
        else:
            total, terms = device_selection_loss(x, masks, ignore_ds, params)
        total.backward()
        results.append((total.detach(), {k: v.detach() for k, v in terms.items()}, x.grad))
    (total, terms, grad), (want_total, want_terms, want_grad) = results
    assert torch.equal(total, want_total) and total > 0
    assert terms.keys() == want_terms.keys()
    assert all(torch.equal(terms[k], want_terms[k]) for k in terms)
    assert torch.equal(grad, want_grad)
    assert not grad[1].any() and grad[0].any() and grad[2].any()


# -- on a card -------------------------------------------------------------------


NARROW = {
    "input": {"num_frames": 4, "min_dim": 64, "max_dim": 96},
    "model": {
        "backbone": {"type": "R-50-FPN"},
        "resnets": {"backbone_out_channels": 32, "res2_out_channels": 32,
                    "stem_out_channels": 16, "width_per_group": 8},
        "embeddings": {"inter_channels": [32, 32, 16, 16], "gn_num_groups": 8},
        "semseg": {"inter_channels": [32, 32, 24, 24], "gn_num_groups": 8},
    },
    "training": {"batch_size": 2, "max_samples_per_chip": 1},
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.card
def test_card_micro_steps_and_update_make_no_synchronising_call(card):
    cfg = merge(load_preset("youtube_vis"), NARROW)
    assert cfg.model.embedding_dim_mode == "xyff" and cfg.model.use_semseg_head
    dataset = SyntheticBlobDataset(cfg.input, 3, seed=7)
    loader = make_data_loader(dataset, [[0], [1], [2]], resolve_max_instances(cfg),
                              scale=target_scale(cfg), num_workers=0, pin_memory=True)
    batches = list(loader)
    assert all(b["masks"].is_pinned() and b["kept_rows"].is_pinned() for b in batches)
    assert all(sum(b["kept_counts"]) > 0 for b in batches)

    device = torch.device("cuda")
    model = build_model(cfg, device=device, for_training=True)
    init_random_weights(model, 3)
    optimizer, scheduler = make_optimizer(cfg.training, trainable_parameters(model))
    step = TrainStep(model, cfg, optimizer, scheduler, accumulate_steps=2)
    step(to_device(batches[0], device))  # warm: the handles, the first kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for batch in batches[1:]:  # the second completes an update
            metrics = step(to_device(batch, device))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert step.micro_step == 1 and scheduler.last_epoch == 1
    assert torch.isfinite(metrics["total"]).item()

    # a profiled window counts every sequence whose rows came from the host
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for batch in batches[:2]:
            step(to_device(batch, device))
        torch.cuda.synchronize()
    assert profiling.last_session()["counters"]["loss.host_selection"] == 2
