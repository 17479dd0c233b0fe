"""The port's losses against the JAX package's on the same numpy inputs:
the Lovász hinge (value and gradient, tied errors and all-zero rows), the
embedding loss (three terms, total and the gradient with respect to the
head output, for ``xyff`` with free dims and ``xyt``, with padded instance
rows, a sequence without instances and a batch without any), the semseg
cross entropy (the reference's plain mean, the ignore mask a no-op) and the
fg BCE.

Values within rtol 2e-4 / atol 1e-6, the JAX suite's own loss tolerance;
gradients within a per-tensor relative L2 of 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemseg_tpu.losses import EmbeddingLossParams as JaxParams
from stemseg_tpu.losses import embedding_loss as jax_embedding_loss
from stemseg_tpu.losses import foreground_bce as jax_foreground_bce
from stemseg_tpu.losses import lovasz_hinge as jax_lovasz_hinge
from stemseg_tpu.losses import semseg_cross_entropy as jax_semseg_cross_entropy
from stemseg_tpu_torch.losses import (
    EmbeddingLossParams,
    embedding_loss,
    foreground_bce,
    lovasz_hinge,
    semseg_cross_entropy,
)

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 1e-6
GRAD_REL_L2 = 1e-4


def rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def lovasz_inputs():
    """Rows: continuous logits; logits on a coarse grid (many tied
    errors); all-zero labels; all-one labels; a single positive."""
    rng = np.random.RandomState(0)
    p = 257
    logits = rng.randn(5, p).astype(np.float32)
    logits[1] = rng.choice([-0.5, 0.0, 0.5, 1.0], size=p)
    labels = (rng.rand(5, p) > 0.6).astype(np.float32)
    labels[2] = 0.0
    labels[3] = 1.0
    labels[4] = 0.0
    labels[4, 17] = 1.0
    return logits, labels


def test_lovasz_value_and_gradient_match_jax():
    logits, labels = lovasz_inputs()
    g = np.linspace(0.5, 1.5, logits.shape[0]).astype(np.float32)

    jfn = jax.vmap(jax_lovasz_hinge)
    want = np.asarray(jfn(jnp.asarray(logits), jnp.asarray(labels)))
    want_grad = np.asarray(jax.grad(lambda x: jnp.sum(jfn(x, jnp.asarray(labels)) * g))(
        jnp.asarray(logits)))

    x = torch.from_numpy(logits).requires_grad_(True)
    got = lovasz_hinge(x, torch.from_numpy(labels))
    (got * torch.from_numpy(g)).sum().backward()

    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    for row in range(logits.shape[0]):
        assert rel_l2(x.grad[row].numpy(), want_grad[row]) <= GRAD_REL_L2, row
    # ties: the tied row's gradient depends on the stable order, exactly
    np.testing.assert_allclose(x.grad[1].numpy(), want_grad[1], rtol=1e-5, atol=1e-7)


def test_lovasz_labels_get_no_gradient():
    logits, labels = lovasz_inputs()
    y = torch.from_numpy(labels).requires_grad_(True)
    lovasz_hinge(torch.from_numpy(logits), y).sum().backward()
    assert y.grad is None


def embedding_case(mode, seed=0, n=3, i=4, t=2, h=12, w=16, empty=False):
    """Head output [N, T, H, W, C] (JAX layout), masks [N, I, T, H, W],
    ignore [N, T, H, W] and the loss parameters for ``mode``. Sequence 0
    has 2 instances and 2 padded rows, sequence 1 none, sequence 2 three
    instances and an ignore stripe."""
    rng = np.random.RandomState(seed)
    e, n_free, stds = {"xyff": (4, 2, (0.3, 0.3)), "xyt": (3, 0, ())}[mode]
    v = e - n_free
    emb = rng.randn(n, t, h, w, e) * 0.3
    bw = rng.randn(n, t, h, w, v) * 0.3 - 1.0
    seed_map = rng.rand(n, t, h, w, 1)
    out = np.concatenate([emb, bw, seed_map], axis=-1).astype(np.float32)

    masks = np.zeros((n, i, t, h, w), np.float32)
    ignore = np.zeros((n, t, h, w), np.float32)
    if not empty:
        for s, n_inst in ((0, 2), (2, 3)):
            for k in range(n_inst):
                for f in range(t):
                    y0, x0 = 1 + 3 * k + f, 2 + 4 * k
                    masks[s, k, f, y0:y0 + 4, x0:x0 + 5] = 1.0
        ignore[2, :, :, -2:] = 1.0
    lparams = dict(embedding_size=e, n_free_dims=n_free, free_dim_stds=stds,
                   weight_lovasz=1.0, weight_variance_smoothness=10.0,
                   weight_seediness=1.0, weight=1.0)
    return out, masks, ignore, lparams


def run_both_embedding(out, masks, ignore, lparams):
    def jloss(x):
        total, terms = jax_embedding_loss(x, jnp.asarray(masks), jnp.asarray(ignore),
                                          JaxParams(**lparams))
        return total, terms

    (jtotal, jterms), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(out))

    x = torch.from_numpy(out).permute(0, 4, 1, 2, 3).contiguous().requires_grad_(True)
    total, terms = embedding_loss(x, torch.from_numpy(masks), torch.from_numpy(ignore),
                                  EmbeddingLossParams(**lparams))
    total.backward()
    grad = x.grad.permute(0, 2, 3, 4, 1).numpy()
    return (float(jtotal), {k: float(v) for k, v in jterms.items()}, np.asarray(jgrad)), \
        (float(total.detach()), {k: float(v.detach()) for k, v in terms.items()}, grad)


@pytest.mark.parametrize("mode", ["xyff", "xyt"])
def test_embedding_loss_matches_jax(mode):
    out, masks, ignore, lparams = embedding_case(mode)
    (jtotal, jterms, jgrad), (total, terms, grad) = run_both_embedding(out, masks, ignore,
                                                                       lparams)
    assert terms.keys() == jterms.keys() == {"lovasz", "var_smoothness", "seediness"}
    for k in jterms:
        np.testing.assert_allclose(terms[k], jterms[k], rtol=RTOL, atol=ATOL, err_msg=k)
        assert jterms[k] > 0, k
    np.testing.assert_allclose(total, jtotal, rtol=RTOL, atol=ATOL)
    assert rel_l2(grad, jgrad) <= GRAD_REL_L2
    # the sequence without instances gets no gradient at all
    assert not grad[1].any() and not jgrad[1].any()


def test_embedding_loss_of_an_empty_batch_is_zero():
    out, masks, ignore, lparams = embedding_case("xyff", empty=True)
    (jtotal, jterms, jgrad), (total, terms, grad) = run_both_embedding(out, masks, ignore,
                                                                       lparams)
    assert total == jtotal == 0.0
    assert all(v == 0.0 for v in terms.values())
    assert not grad.any() and not jgrad.any()


def semseg_case(seed=0, n=2, c=5, t=2, h=8, w=12):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(n, t, h, w, c) * 2).astype(np.float32)  # JAX layout
    labels = rng.randint(0, c, size=(n, t, h, w)).astype(np.int32)
    ignore = (rng.rand(n, t, h, w) > 0.8).astype(np.float32)
    return logits, labels, ignore


def test_semseg_cross_entropy_matches_jax():
    logits, labels, ignore = semseg_case()
    want, want_grad = jax.value_and_grad(
        lambda x: jax_semseg_cross_entropy(x, jnp.asarray(labels), jnp.asarray(ignore)))(
        jnp.asarray(logits))
    x = torch.from_numpy(logits).permute(0, 4, 1, 2, 3).contiguous().requires_grad_(True)
    got = semseg_cross_entropy(x, torch.from_numpy(labels), torch.from_numpy(ignore))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL, atol=ATOL)
    assert rel_l2(x.grad.permute(0, 2, 3, 4, 1).numpy(), want_grad) <= GRAD_REL_L2


def test_semseg_cross_entropy_ignore_mask_is_a_no_op():
    """The reference's plain mean: ignore pixels count, as in the JAX
    package's default."""
    logits, labels, ignore = semseg_case(seed=2)
    x = torch.from_numpy(logits).permute(0, 4, 1, 2, 3).contiguous()
    got = semseg_cross_entropy(x, torch.from_numpy(labels), torch.from_numpy(ignore))
    plain = semseg_cross_entropy(x, torch.from_numpy(labels),
                                 torch.zeros_like(torch.from_numpy(ignore)))
    assert ignore.any() and float(got) == float(plain)
    want = jax_semseg_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    jnp.asarray(ignore))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=ATOL)


def test_foreground_bce_matches_jax():
    logits, labels, ignore = semseg_case(seed=1)
    fg_logits = logits[..., 0]
    fg = (labels > 1).astype(np.float32)

    want, want_grad = jax.value_and_grad(
        lambda x: jax_foreground_bce(x, jnp.asarray(fg), jnp.asarray(ignore)))(
        jnp.asarray(fg_logits))
    x = torch.from_numpy(fg_logits).requires_grad_(True)
    got = foreground_bce(x, torch.from_numpy(fg), torch.from_numpy(ignore))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL, atol=ATOL)
    assert rel_l2(x.grad.numpy(), want_grad) <= GRAD_REL_L2
    # ignore pixels get no gradient
    assert not x.grad.numpy()[ignore > 0].any()
