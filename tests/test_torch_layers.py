"""Layer primitives of the PyTorch port against the JAX package's
``models/layers.py`` and ``embedding_utils.py`` on the same random inputs
(channels-last for JAX, channels-first for the port), atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemseg_tpu.models import common3d as jax_common3d
from stemseg_tpu.models import embedding_utils as jax_emb
from stemseg_tpu.models import layers as jax_layers
from stemseg_tpu_torch.models import common3d, embedding_utils, layers

torch.set_num_threads(2)

ATOL = 1e-5


def _cl_to_cf(x: np.ndarray) -> torch.Tensor:
    """[N, ..., C] numpy -> [N, C, ...] torch."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _cf_to_cl(x: torch.Tensor) -> np.ndarray:
    return np.moveaxis(x.detach().numpy(), 1, -1)


def test_frozen_batch_norm():
    rng = np.random.RandomState(0)
    c = 6
    consts = {"weight": rng.randn(c), "bias": rng.randn(c),
              "running_mean": rng.randn(c), "running_var": rng.rand(c) + 0.5}
    consts = {k: v.astype(np.float32) for k, v in consts.items()}
    x = rng.randn(2, 5, 7, c).astype(np.float32)
    ref = jax_layers.FrozenBatchNorm(c).apply({"constants": consts}, jnp.asarray(x))

    bn = layers.FrozenBatchNorm(c)
    for k, v in consts.items():
        getattr(bn, k).copy_(torch.from_numpy(v))
    np.testing.assert_allclose(_cf_to_cl(bn(_cl_to_cf(x))), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("kernel,stride,padding,dilation,groups,bias", [
    ((7, 7), (2, 2), (3, 3), None, 1, False),
    ((3, 3), (1, 1), None, (2, 2), 2, False),
    ((1, 1), (2, 2), None, None, 1, True),
    ((3, 3, 3), None, None, None, 1, True),
    ((1, 1, 1), None, None, None, 1, False),
])
def test_conv(kernel, stride, padding, dilation, groups, bias):
    rng = np.random.RandomState(1)
    nd = len(kernel)
    cin, cout = 4, 6
    shape = (2,) + (5, 9, 11)[3 - nd:] + (cin,)
    x = rng.randn(*shape).astype(np.float32)
    mod = jax_layers.Conv(cout, kernel, strides=stride, padding=padding,
                          dilation=dilation, groups=groups, use_bias=bias)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = mod.apply(variables, jnp.asarray(x))

    conv = layers.make_conv(cin, cout, kernel, stride=stride, padding=padding,
                            dilation=dilation, groups=groups, bias=bias)
    k = np.asarray(variables["params"]["conv"]["kernel"])
    perm = (3, 2, 0, 1) if nd == 2 else (4, 3, 0, 1, 2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(k.transpose(perm))))
        if bias:
            conv.bias.copy_(torch.from_numpy(np.array(variables["params"]["conv"]["bias"])))
        out = conv(_cl_to_cf(x))
    np.testing.assert_allclose(_cf_to_cl(out), np.asarray(ref), atol=ATOL)


def test_group_norm():
    rng = np.random.RandomState(2)
    c, g = 8, 4
    x = (rng.randn(2, 3, 5, 6, c) * 3 + 1).astype(np.float32)
    scale, bias = rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)
    ref = jax_layers.GroupNorm(g).apply(
        {"params": {"gn": {"scale": scale, "bias": bias}}}, jnp.asarray(x))
    gn = layers.group_norm(g, c)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        out = gn(_cl_to_cf(x))
    np.testing.assert_allclose(_cf_to_cl(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("name,window,strides,padding", [
    ("avg_pool_3d", (3, 3, 3), (2, 1, 1), (1, 1, 1)),
    ("avg_pool_3d", (3, 1, 1), (2, 1, 1), (1, 0, 0)),
    ("max_pool_3d", (3, 3, 3), (2, 1, 1), (1, 1, 1)),
    ("max_pool_2d", (3, 3), (2, 2), (1, 1)),
])
def test_pools(name, window, strides, padding):
    rng = np.random.RandomState(3)
    nd = len(window)
    x = rng.randn(*((2,) + (7, 9, 10)[3 - nd:] + (3,))).astype(np.float32)
    ref = getattr(jax_layers, name)(jnp.asarray(x), window, strides, padding)
    out = getattr(layers, name)(_cl_to_cf(x), window, strides, padding)
    np.testing.assert_allclose(_cf_to_cl(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("scale", [(2.0, 2.0, 2.0), (1.0, 2.0, 2.0), (1.0, 4.0, 4.0)])
def test_upsample_trilinear(scale):
    rng = np.random.RandomState(4)
    x = rng.randn(1, 2, 5, 7, 3).astype(np.float32)
    ref = jax_layers.upsample_trilinear(jnp.asarray(x), scale)
    out = layers.upsample_trilinear(_cl_to_cf(x), scale)
    np.testing.assert_allclose(_cf_to_cl(out), np.asarray(ref), atol=ATOL)


def test_upsample_bilinear():
    rng = np.random.RandomState(5)
    x = rng.randn(2, 5, 7, 3).astype(np.float32)
    ref = jax_layers.upsample_bilinear(jnp.asarray(x), 2.0)
    out = layers.upsample_bilinear(_cl_to_cf(x), 2.0)
    np.testing.assert_allclose(_cf_to_cl(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("out_hw", [(48, 72), (13, 17), (20, 30)])
def test_resize_bilinear(out_hw):
    """Up- and downsampling, both without antialiasing."""
    rng = np.random.RandomState(6)
    x = rng.rand(3, 20, 30).astype(np.float32)
    ref = jax_layers.resize_bilinear(jnp.asarray(x[..., None]), out_hw)[..., 0]
    out = layers.resize_bilinear(torch.from_numpy(x), out_hw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("mode", ["xyff", "xyt", "xy", "xytf"])
def test_spatiotemporal_offset(mode):
    rng = np.random.RandomState(7)
    e = jax_emb.get_nb_embedding_dims(mode)
    assert embedding_utils.get_nb_embedding_dims(mode) == e
    assert embedding_utils.get_nb_free_dims(mode) == jax_emb.get_nb_free_dims(mode)
    x = rng.randn(1, 4, 9, 13, e).astype(np.float32)
    ref = jax_emb.add_spatiotemporal_offset(jnp.asarray(x), jnp.asarray(0.7), mode)
    out = embedding_utils.add_spatiotemporal_offset(_cl_to_cf(x), torch.tensor(0.7), mode)
    np.testing.assert_allclose(_cf_to_cl(out), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("num_frames", [2, 4, 8, 16, 24, 32])
def test_temporal_schedules(num_frames):
    assert common3d.get_pooling_flags(num_frames) == jax_common3d.get_pooling_flags(num_frames)
    assert common3d.get_temporal_scales(num_frames) == jax_common3d.get_temporal_scales(num_frames)
