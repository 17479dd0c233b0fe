"""The port's dilated decoder trunk (``AtrousPyramid3D`` and the heads with
``trunk_type="squeeze_expand_dilated_decoder"``) against the JAX package's
on the same weights, carried across with ``state_dict_from_jax``: forward
within 1e-3, input and parameter gradients within a per-leaf relative L2 of
2e-3, at 8- and 16-frame clips (their temporal pool flags differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemseg_tpu.models.common3d import AtrousPyramid3D as JaxAtrousPyramid3D
from stemseg_tpu.models.common3d import get_pooling_flags
from stemseg_tpu.models.decoders import EmbeddingDecoder as JaxEmbeddingDecoder
from stemseg_tpu.models.decoders import SeedinessDecoder as JaxSeedinessDecoder
from stemseg_tpu.models.decoders import SemsegDecoder as JaxSemsegDecoder
from stemseg_tpu_torch.models.common3d import AtrousPyramid3D
from stemseg_tpu_torch.models.decoders import EmbeddingDecoder, SeedinessDecoder, SemsegDecoder
from stemseg_tpu_torch.models.weights import state_dict_from_jax

torch.set_num_threads(2)

ATOL = 1e-3
GRAD_REL_L2 = 2e-3
DILATED = "squeeze_expand_dilated_decoder"
C_IN = 16
INTER = (16, 16, 8, 8)


def rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def random_tree(shapes, rng):
    """numpy leaves for a JAX variable tree: kernels U(±sqrt(1/fan_in)), GN
    scales near 1, biases and the rest N(0, 0.2²), time_scale 0.8."""
    def leaf(name, shape):
        if name == "kernel":
            bound = np.sqrt(1.0 / np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, shape)
        elif name == "scale":
            v = 1.0 + rng.randn(*shape) * 0.2
        elif name == "time_scale":
            v = np.asarray(0.8)
        else:
            v = rng.randn(*shape) * 0.2
        return np.asarray(v, np.float32)

    return {k: random_tree(v, rng) if hasattr(v, "items") else leaf(k, v.shape)
            for k, v in shapes.items()}


def heads(kind, t):
    """(JAX head, port head) of ``kind`` with the dilated trunk at ``t``
    frames, small widths, GroupNorm."""
    common = dict(num_frames=t, norm_type="gn", gn_groups=4, trunk_type=DILATED)
    if kind == "embedding":
        return (JaxEmbeddingDecoder(inter_channels=INTER, embedding_size=4,
                                    embedding_dim_mode="xyff", seediness_output=True, **common),
                EmbeddingDecoder(C_IN, INTER, 4, "xyff", seediness_output=True, **common))
    if kind == "seediness":
        return (JaxSeedinessDecoder(inter_channels=INTER, **common),
                SeedinessDecoder(C_IN, INTER, **common))
    return (JaxSemsegDecoder(num_classes=3, inter_channels=INTER, **common),
            SemsegDecoder(C_IN, 3, INTER, **common))


def head_case(kind, t, seed):
    """Both heads on one set of random weights, the features (32x first,
    ``[1, t, s, 3s/2, C]``) and a fixed random weighting of the output."""
    rng = np.random.RandomState(seed)
    feats = [rng.randn(1, t, s, 3 * s // 2, C_IN).astype(np.float32) for s in (2, 4, 8, 16)]
    jhead, head = heads(kind, t)
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])
    variables = {name: random_tree(tree, rng) for name, tree in shapes.items()}
    sd = state_dict_from_jax({name: {"h": tree} for name, tree in variables.items()})
    assert set(sd) == {"h." + k for k in head.state_dict()}
    head.load_state_dict({k[2:]: v for k, v in sd.items()})
    return jhead, head, variables, feats, rng


def to_port(f):
    return torch.from_numpy(f).permute(0, 4, 1, 2, 3).contiguous()


@pytest.mark.parametrize("t", [8, 16])
def test_atrous_pyramid_matches_jax(t):
    rng = np.random.RandomState(t)
    x = rng.randn(1, t, 6, 9, C_IN).astype(np.float32)
    rates = ((1, 3, 3), (1, 6, 6), (1, 9, 9))
    jmod = JaxAtrousPyramid3D(8, rates, out_channels=12)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), jnp.asarray(x))
    params = random_tree(shapes["params"], rng)
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))

    mod = AtrousPyramid3D(C_IN, 8, rates, 12)
    sd = state_dict_from_jax({"params": {"h": {"trunk": {"block_32x_aspp0": params}}}})
    assert set(sd) == {"h.block_32x.0." + k for k in mod.state_dict()}
    mod.load_state_dict({k[len("h.block_32x.0."):]: v for k, v in sd.items()})
    with torch.no_grad():
        out = mod(to_port(x)).permute(0, 2, 3, 4, 1).numpy()
    assert out.shape == ref.shape == (1, t, 6, 9, 12)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("t", [8, 16])
@pytest.mark.parametrize("kind", ["embedding", "seediness", "semseg"])
def test_dilated_head_forward_matches_jax(kind, t):
    jhead, head, variables, feats, _ = head_case(kind, t, seed=t)
    ref = np.asarray(jhead.apply(variables, [jnp.asarray(f) for f in feats]))
    with torch.no_grad():
        out = head([to_port(f) for f in feats]).permute(0, 2, 3, 4, 1).numpy()
    assert out.shape == ref.shape
    assert out.shape[:4] == (1, t, 16, 24)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("t", [8, 16])
@pytest.mark.parametrize("kind", ["embedding", "seediness", "semseg"])
def test_dilated_head_gradients_match_jax(kind, t):
    jhead, head, variables, feats, rng = head_case(kind, t, seed=100 + t)
    out_shape = jax.eval_shape(jhead.apply, variables, [jnp.asarray(f) for f in feats]).shape
    weight = rng.randn(*out_shape).astype(np.float32)

    def jloss(params, fs):
        y = jhead.apply({**variables, "params": params}, fs)
        return jnp.sum(y * weight)

    jgrad_p, jgrad_x = jax.grad(jloss, argnums=(0, 1))(
        variables["params"], [jnp.asarray(f) for f in feats])

    xs = [to_port(f).requires_grad_(True) for f in feats]
    y = head(xs)
    (y * torch.from_numpy(weight).permute(0, 4, 1, 2, 3)).sum().backward()

    for x, jg in zip(xs, jgrad_x):
        assert rel_l2(x.grad.permute(0, 2, 3, 4, 1).numpy(), np.asarray(jg)) < GRAD_REL_L2
    want = state_dict_from_jax({"params": {"h": jax.tree.map(np.asarray, jgrad_p)}})
    named = dict(head.named_parameters())
    assert set(want) == {"h." + k for k in named}
    worst = max((rel_l2(named[k[2:]].grad.numpy(), v.numpy()), k) for k, v in want.items())
    assert worst[0] < GRAD_REL_L2, worst


def test_pool_flags_differ_between_8_and_16_frames():
    assert get_pooling_flags(8) != get_pooling_flags(16)
    _, head8 = heads("seediness", 8)
    _, head16 = heads("seediness", 16)
    pools8 = [type(m).__name__ for m in head8.block_32x[3::4]]
    pools16 = [type(m).__name__ for m in head16.block_32x[3::4]]
    assert pools8 == ["TemporalPool", "TemporalPool", "Identity"]
    assert pools16 == ["TemporalPool"] * 3
    assert head16.block_32x[3].window == (3, 1, 1) and head16.block_8x[3].window == (3, 3, 3)
