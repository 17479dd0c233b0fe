"""The port's clustering (``cluster_points_reference``, the plain version of
both CUDA kernels, and ``cluster_window``) against the JAX package:
``clustering._cluster`` (the plain reference of ``_cluster_kernel``) and the
tiled Pallas kernel in interpret mode. Labels and ``valid`` are exact;
centres, bandwidths and seed probabilities within 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemseg_tpu.inference.clustering import ClusterParams as JaxClusterParams
from stemseg_tpu.inference.clustering import _cluster
from stemseg_tpu.inference.clustering import cluster_window as jax_cluster_window
from stemseg_tpu.ops import cluster_points_pallas_tiled
from stemseg_tpu.ops.cluster_pallas import _single_block_supported
from stemseg_tpu_torch.inference.clustering import ClusterParams, cluster_window
from stemseg_tpu_torch.ops import cluster as ops

torch.set_num_threads(2)

ATOL = 1e-6


def mixture_points(rng, p, e=4, n_free=2, n_clusters=6, noise=0.06):
    """Gaussian blobs in embedding space, seediness peaked at the blob
    centres, plus low-seediness outliers; fg drops ~30 % of the points.
    Bandwidths are the learned ones (E - n_free dims), activated."""
    v = e - n_free
    centers = rng.uniform(-0.8, 0.8, size=(n_clusters, e)).astype(np.float32)
    k = rng.randint(0, n_clusters + 1, size=p)  # n_clusters -> outlier
    emb = np.where((k < n_clusters)[:, None],
                   centers[np.minimum(k, n_clusters - 1)] + rng.randn(p, e) * noise,
                   rng.uniform(-1, 1, size=(p, e))).astype(np.float32)
    dist = np.linalg.norm(emb - centers[np.minimum(k, n_clusters - 1)], axis=1)
    seed = np.where(k < n_clusters, np.exp(-dist / (2 * noise)) * 0.19 + 0.8,
                    rng.uniform(0.0, 0.5, p)).astype(np.float32)
    bw = (np.exp(rng.randn(p, v) * 0.1 + np.log(3.0)) * 10.0).astype(np.float32)
    fg = rng.rand(p) > 0.3
    return emb, bw, seed, fg


def _full_bw(bw, free_stds):
    if not free_stds:
        return bw
    free = np.asarray([1.0 / (s * s) for s in free_stds], np.float32)
    return np.concatenate([bw, np.broadcast_to(free, (len(bw), len(free)))], axis=1)


CASES = [
    # mode, K, free dim stds, min seediness
    ("reference", 20, (0.3, 0.3), 0.8),
    ("nearest", 20, (0.3, 0.3), 0.8),
    ("reference", 20, (), 0.8),
    ("reference", 3, (0.3, 0.3), 0.5),   # exhausts K: stale availability mask
    ("nearest", 3, (0.3, 0.3), 0.5),
    ("reference", 20, (0.3, 0.3), 0.99),  # stops at once: no cluster
]


def _run_both(mode, k, free_stds, min_seed, seed=0, p=1317):
    rng = np.random.RandomState(seed)
    e = 4 if free_stds else 2
    emb, bw, seeds, fg = mixture_points(rng, p, e=e, n_free=len(free_stds))
    full_bw = _full_bw(bw, free_stds)
    params = JaxClusterParams(min_seediness_prob=min_seed, max_instances=k,
                              secondary_assignment=mode)
    ref = _cluster(jnp.asarray(emb), jnp.asarray(full_bw), jnp.asarray(seeds),
                   jnp.asarray(fg), params)
    labels, meta = ops.cluster_points_reference(
        torch.from_numpy(emb), torch.from_numpy(full_bw), torch.from_numpy(seeds),
        torch.from_numpy(fg), e_dims=e, max_instances=k,
        primary=params.primary_prob_thresh, secondary=params.secondary_prob_thresh,
        min_seediness=min_seed, reference_secondary=mode == "reference")
    return (emb, full_bw, seeds, fg, params), ref, labels.numpy(), meta.numpy()


def _assert_meta(meta, ref, k, e):
    np.testing.assert_array_equal(meta[:k, -1] > 0.5, np.asarray(ref.valid))
    np.testing.assert_allclose(meta[:k, :e], np.asarray(ref.centers), atol=ATOL, rtol=0)
    np.testing.assert_allclose(meta[:k, e:2 * e], np.asarray(ref.bandwidths),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(meta[:k, -2], np.asarray(ref.seed_probs), atol=ATOL, rtol=0)
    assert not meta[k:].any() and not meta[:, 2 * e:-2].any()


@pytest.mark.parametrize("mode,k,free_stds,min_seed", CASES)
def test_reference_matches_jax_cluster(mode, k, free_stds, min_seed):
    (emb, *_), ref, labels, meta = _run_both(mode, k, free_stds, min_seed)
    np.testing.assert_array_equal(labels, np.asarray(ref.labels))
    _assert_meta(meta, ref, k, emb.shape[1])
    if min_seed < 0.9:
        assert (labels >= 0).sum() > 100  # clusters really formed


def edge_case(name, p=600, seed=5):
    """Inputs where the loop ends by running out of points ("all_taken":
    wide clusters, min seediness 0), has no point at all ("all_background")
    or runs one iteration ("k1")."""
    rng = np.random.RandomState(seed)
    emb, bw, seeds, fg = mixture_points(rng, p, n_clusters=2, noise=0.01)
    full_bw = _full_bw(bw, (0.3, 0.3))
    k, min_seed = 20, 0.0
    if name == "all_taken":
        fg[:] = True
        full_bw[:] = 1.0  # wide clusters: two of them take every point
    elif name == "all_background":
        fg[:] = False
    else:
        k, min_seed = 1, 0.8
    return emb, full_bw, seeds, fg, k, min_seed


@pytest.mark.parametrize("name", ["all_taken", "all_background", "k1"])
@pytest.mark.parametrize("mode", ["reference", "nearest"])
def test_reference_edge_cases_match_jax(name, mode):
    emb, full_bw, seeds, fg, k, min_seed = edge_case(name)
    params = JaxClusterParams(min_seediness_prob=min_seed, max_instances=k,
                              secondary_assignment=mode)
    ref = _cluster(jnp.asarray(emb), jnp.asarray(full_bw), jnp.asarray(seeds),
                   jnp.asarray(fg), params)
    labels, meta = ops.cluster_points_reference(
        *(torch.from_numpy(x) for x in (emb, full_bw, seeds, fg)), e_dims=4,
        max_instances=k, primary=0.5, secondary=0.3, min_seediness=min_seed,
        reference_secondary=mode == "reference")
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref.labels))
    _assert_meta(meta.numpy(), ref, k, 4)
    n_valid = int(np.asarray(ref.valid).sum())
    if name == "all_taken":  # stopped for lack of points, before K
        assert 2 <= n_valid < k and (labels >= 0).all()
    else:
        assert n_valid == {"all_background": 0, "k1": 1}[name]


@pytest.mark.parametrize("mode,k", [("reference", 20), ("nearest", 20), ("reference", 3)])
def test_reference_matches_tiled_pallas_interpret(mode, k):
    """Against the tiled Pallas kernel itself, several tiles on the
    interpreter."""
    (emb, full_bw, seeds, fg, params), _, labels, meta = _run_both(
        mode, k, (0.3, 0.3), 0.8 if k == 20 else 0.5, seed=1)
    labels_t, meta_t = cluster_points_pallas_tiled(
        jnp.asarray(emb), jnp.asarray(full_bw), jnp.asarray(seeds), jnp.asarray(fg),
        e_dims=4, max_instances=k, primary=params.primary_prob_thresh,
        secondary=params.secondary_prob_thresh,
        min_seediness=params.min_seediness_prob,
        reference_secondary=mode == "reference", tile_rows=8, interpret=True)
    np.testing.assert_array_equal(labels, np.asarray(labels_t))
    np.testing.assert_allclose(meta, np.asarray(meta_t), atol=ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["reference", "nearest"])
def test_cluster_window_matches_jax(mode):
    """[T, H, W, E] windows with a bg mask, free dims appended by the
    wrapper, slots shifted to ``label_start``."""
    rng = np.random.RandomState(2)
    t, h, w = 3, 12, 20
    emb, bw, seeds, fg = mixture_points(rng, t * h * w)
    jparams = JaxClusterParams(min_seediness_prob=0.8, n_free_dims=2,
                               free_dim_stds=(0.3, 0.3), secondary_assignment=mode)
    args = [x.reshape((t, h, w) + x.shape[1:]) for x in (emb, bw, seeds, fg)]
    ref = jax_cluster_window(*(jnp.asarray(a) for a in args), jparams, label_start=41,
                             backend="xla")
    params = ClusterParams(**jparams._asdict())
    out = cluster_window(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args),
                         params, label_start=41)
    assert out.labels.shape == (t, h, w) and out.labels.dtype == torch.int32
    np.testing.assert_array_equal(out.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_allclose(out.centers.numpy(), np.asarray(ref.centers), atol=ATOL)
    np.testing.assert_allclose(out.bandwidths.numpy(), np.asarray(ref.bandwidths), atol=ATOL)
    assert set(np.unique(out.labels.numpy())) - {-1} <= set(range(41, 61))


def test_dispatch_rule_and_counts():
    """Same single/tiled rule as the JAX package; CPU tensors go to the
    plain version, which is the only count that moves."""
    for p in (207_360, 262_144, 262_145, 878_592):
        for e in (3, 4, 8):
            assert ops.single_block_supported(p, 20, e) == _single_block_supported(p, 20, e)
    assert ops.single_block_supported(207_360, 20, 4)
    assert not ops.single_block_supported(878_592, 20, 4)

    rng = np.random.RandomState(3)
    emb, bw, seeds, fg = mixture_points(rng, 500)
    full_bw = _full_bw(bw, (0.3, 0.3))
    kwargs = dict(e_dims=4, max_instances=20, primary=0.5, secondary=0.3,
                  min_seediness=0.8, reference_secondary=True)
    tensors = [torch.from_numpy(x) for x in (emb, full_bw, seeds, fg)]
    ops.reset_launch_counts()
    l0, m0 = ops.cluster_points(*tensors, **kwargs)
    l1, m1 = ops.cluster_points_single(*tensors, **kwargs)
    l2, m2 = ops.cluster_points_tiled(*tensors, **kwargs)
    assert ops.launch_counts == {"cluster_points_single": 0, "cluster_points_tiled": 0,
                                 "cluster_points_reference": 3}
    assert torch.equal(l0, l1) and torch.equal(l0, l2) and torch.equal(m0, m2)



def _ordered_key(seed: float, idx: int) -> int:
    """The kernels' 64-bit first-occurrence key of one point."""
    u = int(np.float32(seed).view(np.uint32))
    bits = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (bits << 32) | (0xFFFFFFFF - idx)


def protocol_model(emb, bw, seed, fg, n_blocks, *, e_dims, max_instances, primary,
                   secondary, min_seediness, reference_secondary):
    """CPU model of the CUDA kernels' cross-block protocol (csrc/cluster.cu):
    the points split into ``n_blocks`` contiguous blocks, each keeping the
    list of its available points. Per iteration each block sweeps only its
    listed points (applying the decided iteration, writing the label of a
    point it assigns, keeping a best distance and best slot per listed
    point), and offers the first-occurrence key of its best remaining point
    with that point's emb and bw; every block decodes the same iteration
    from the max key over all records. The sweep after the last executed
    iteration runs the secondary pass over the list of points available at
    its start (the stale mask)."""
    p = emb.shape[0]
    per = -(-p // n_blocks)
    lists = [torch.arange(b * per, min(p, (b + 1) * per)) for b in range(n_blocks)]
    bd = torch.full((p,), float("-inf") if reference_secondary else float("inf"))
    bi = torch.zeros(p, dtype=torch.int32)
    labels = torch.full((p,), -9, dtype=torch.int32)
    meta = torch.zeros(K_PAD_MODEL, 128)
    init, apply, final, do_sec, active0 = True, False, False, False, False
    k, c, b = -1, None, None
    for it in range(max_instances + 1):
        records = []
        for blk, idx in enumerate(lists):
            lab = torch.full((len(idx),), -1, dtype=torch.int32)
            if init:
                listed = fg[idx]
                labels[idx[~listed]] = -1
                idx, lab = idx[listed], lab[listed]
            if apply:
                d2 = torch.zeros(len(idx))
                for e in range(e_dims):
                    d2 = d2 + (emb[idx, e] - c[e]) ** 2 * b[e]
                dist = torch.sqrt(d2)
                lab = torch.where(torch.exp(-0.5 * dist) > primary, k, lab)
                upd = (dist > bd[idx]) if reference_secondary else (dist < bd[idx])
                bd[idx] = torch.where(upd, dist, bd[idx])
                bi[idx] = torch.where(upd, k, bi[idx])
            if final:
                gate = torch.ones_like(lab, dtype=torch.bool) if reference_secondary \
                    else lab == -1
                if do_sec:
                    lab = torch.where(gate & (torch.exp(-0.5 * bd[idx]) > secondary), bi[idx], lab)
                labels[idx] = lab
                continue
            labels[idx[lab >= 0]] = lab[lab >= 0]
            lists[blk] = idx = idx[lab == -1]
            key = max((_ordered_key(float(seed[i]), int(i)) for i in idx), default=0)
            gi = 0xFFFFFFFF - (key & 0xFFFFFFFF)
            records.append((key, emb[gi] if key else torch.zeros(e_dims),
                            bw[gi] if key else torch.zeros(e_dims)))
        if final:
            break
        key, c, b = max(records, key=lambda record: record[0])
        score = float(seed[0xFFFFFFFF - (key & 0xFFFFFFFF)]) if key else 0.0
        active = key != 0 and np.float32(score) >= np.float32(min_seediness)
        active0 = active if it == 0 else active0
        init, k = False, it
        if active:
            meta[it, :e_dims], meta[it, e_dims:2 * e_dims] = c, b
            meta[it, -2], meta[it, -1] = score, 1.0
            apply, final = True, it == max_instances - 1
            do_sec = final
        else:
            apply, final, do_sec = False, True, active0 and key != 0
    assert (labels >= -1).all()  # every point written
    return labels, meta


K_PAD_MODEL = ops.K_PAD


def _protocol_case(name, p=1317, seed=4):
    """(inputs, K, min seediness, n_blocks) of one protocol case; P = 1317
    is not a multiple of any block count used."""
    rng = np.random.RandomState(seed)
    emb, bw, seeds, fg = mixture_points(rng, p)
    full_bw = _full_bw(bw, (0.3, 0.3))
    k, min_seed, n_blocks = 20, 0.8, 5
    if name == "tie":  # the same top seediness in blocks 1 and 3
        seeds[[300, 900]] = 0.9995
        fg[[300, 900]] = True
    elif name == "empty_block":
        fg[264:528] = False
    elif name == "k_exhausted":  # wide clusters: the stale mask relabels points
        k, min_seed = 3, 0.5
        full_bw *= np.float32(0.1)
    elif name == "k1":
        k = 1
    elif name == "uneven_blocks":
        n_blocks = 7
    return emb, full_bw, seeds, fg, k, min_seed, n_blocks


@pytest.mark.parametrize("name", ["tie", "empty_block", "k_exhausted", "k1", "uneven_blocks"])
@pytest.mark.parametrize("mode", ["reference", "nearest"])
def test_protocol_model_matches_reference(name, mode):
    emb, full_bw, seeds, fg, k, min_seed, n_blocks = _protocol_case(name)
    tensors = [torch.from_numpy(x) for x in (emb, full_bw, seeds, fg)]
    kwargs = dict(e_dims=4, max_instances=k, primary=0.5, secondary=0.3,
                  min_seediness=min_seed, reference_secondary=mode == "reference")
    labels, meta = protocol_model(*tensors, n_blocks, **kwargs)
    ref_labels, ref_meta = ops.cluster_points_reference(*tensors, **kwargs)
    assert torch.equal(labels, ref_labels)
    assert torch.equal(meta, ref_meta)
    n_valid = int((meta[:, -1] > 0.5).sum())
    assert n_valid == {"k1": 1, "k_exhausted": 3}.get(name, n_valid) and n_valid >= 1
    assert (labels >= 0).sum() > 100
    if name == "tie":  # the smaller index of the two equal seeds wins
        assert torch.equal(meta[0, :4], tensors[0][300])
    if name == "empty_block":
        assert (labels[264:528] == -1).all()


def test_on_chip_capacity():
    """H100: 132 SMs, 232,448 bytes of shared memory a block may opt in to."""
    sms, smem = 132, 232_448
    cap = ops.on_chip_capacity(4, True, sms, smem)
    assert 207_360 <= cap and 878_592 <= cap < 3_500_000
    assert cap == sms * ((smem - ops.FIXED_SMEM) // 29)
    assert ops.on_chip_capacity(8, True, sms, smem) < cap
    # the tiled kernel keeps path A's state on chip, not 3.5 M points'
    assert 878_592 <= ops.on_chip_capacity(4, False, sms, smem) < 3_500_000
    assert ops.on_chip_capacity(4, False, sms, 10_000) == 0


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    from stemseg_tpu_torch.ops import build

    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    before = build._library_path("k")
    (tmp_path / "k.cuh").write_text("// v2\n")
    assert build._library_path("k") != before
    assert build._library_path("k") == build._library_path("k")
