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

