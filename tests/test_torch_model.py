"""The port's model (ResNet body + FPN, embedding, seediness and semseg heads)
against the JAX package's on the same weights, carried across with
``state_dict_from_jax``; and the exact round trip of that mapping through the
JAX package's own checkpoint converter. The same for the X-101-FPN body
(ResNeXt: grouped 3x3s that carry the stride), with the youtube_vis heads."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemseg_tpu.config import load_config as jax_load_config
from stemseg_tpu.models import build_model as jax_build_model
from stemseg_tpu.models.converter import convert_state_dict
from stemseg_tpu.models.fpn import FPN as JaxFPN
from stemseg_tpu.models.resnet import STAGE_SPECS, ResNet as JaxResNet
from stemseg_tpu_torch.config import load_config
from stemseg_tpu_torch.models import build_model, state_dict_from_jax

torch.set_num_threads(2)

# tolerance of the JAX suite's forward parity against torch
ATOL = 1e-3

# a DAVIS-shaped model (xyff, separate seediness head, GN heads) at narrow
# widths and R-50 depth
SMALL = {
    "input": {"num_frames": 4},
    "model": {
        "backbone": {"type": "R-50-FPN"},
        "embedding_dim_mode": "xyff", "use_seediness_head": True,
        "use_semseg_head": False,
        "resnets": {"backbone_out_channels": 32, "res2_out_channels": 32,
                    "stem_out_channels": 16, "width_per_group": 8},
        "embeddings": {"embedding_size": 4, "inter_channels": [32, 32, 16, 16],
                       "gn_num_groups": 8},
        "seediness": {"inter_channels": [32, 32, 16, 16], "gn_num_groups": 8},
    },
    "training": {"losses": {"embedding": {"free_dim_stds": [0.3, 0.3]}}},
}


def random_variables(jmodel, x_shape, seed):
    """A JAX variable tree of numpy leaves for ``jmodel``, drawn with numpy
    (conv kernels U(±sqrt(1/fan_in)), random FrozenBN statistics, GN
    affines and time_scale), so that every kind of leaf is exercised."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros(x_shape, jnp.float32))

    def leaf(name, shape):
        if name == "kernel":
            bound = np.sqrt(1.0 / np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, shape)
        elif name == "running_var":
            v = rng.rand(*shape) + 0.5
        elif name in ("scale", "weight"):
            v = 1.0 + rng.randn(*shape) * 0.2
        elif name == "time_scale":
            v = np.asarray(0.8)
        else:  # bias, running_mean
            v = rng.randn(*shape) * 0.2
        return np.asarray(v, np.float32)

    def walk(tree):
        return {k: walk(v) if hasattr(v, "items") else leaf(k, v.shape)
                for k, v in tree.items()}

    return {"params": walk(shapes["params"]), "constants": walk(shapes["constants"])}


@pytest.fixture(scope="module")
def models():
    jcfg = jax_load_config(SMALL)
    jmodel = jax_build_model(jcfg, for_training=False)
    variables = random_variables(jmodel, (1, 4, 64, 96, 3), 1)

    cfg = load_config(SMALL)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables))
    return jcfg, jmodel, variables, model


def _check_backbone_fpn(models):
    """Body + FPN on 3 frames against the JAX package's ``ResNet`` and
    ``FPN`` built from the same config."""
    jcfg, _, variables, model = models
    rng = np.random.RandomState(2)
    x = (rng.randn(3, 64, 96, 3) * 40).astype(np.float32)
    r = jcfg.model.resnets
    body = JaxResNet(stage_specs=STAGE_SPECS[jcfg.model.backbone.type],
                     num_groups=r.num_groups, width_per_group=r.width_per_group,
                     stem_out_channels=r.stem_out_channels,
                     res2_out_channels=r.res2_out_channels, stride_in_1x1=r.stride_in_1x1)
    feats = body.apply({"params": variables["params"]["body"],
                        "constants": variables["constants"]["body"]}, jnp.asarray(x))
    ref = JaxFPN(out_channels=r.backbone_out_channels).apply(
        {"params": variables["params"]["fpn"]}, feats)

    with torch.no_grad():
        out = model.backbone_features(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(out) == 4
    for o, r_ in zip(out, ref):
        np.testing.assert_allclose(o.permute(0, 2, 3, 1).numpy(), np.asarray(r_),
                                   atol=ATOL, rtol=1e-4)


def test_backbone_fpn_matches_jax(models):
    _check_backbone_fpn(models)


def test_full_forward_matches_jax(models):
    """Backbone per frame, then both heads on the 4-frame clip: embeddings
    (grid offset included), variances and seediness."""
    _, jmodel, variables, model = models
    rng = np.random.RandomState(3)
    clip = (rng.randn(1, 4, 64, 96, 3) * 40).astype(np.float32)
    ref = np.asarray(jmodel.apply(variables, jnp.asarray(clip))["embeddings"])[0]

    with torch.no_grad():
        feats = model.backbone_features(torch.from_numpy(clip[0]).permute(0, 3, 1, 2))
        coarsest_first = [f.permute(1, 0, 2, 3)[None] for f in feats[::-1]]
        emb, seed, semseg = model.heads(coarsest_first)
    assert semseg is None
    out = torch.cat([emb, seed], dim=1)[0].permute(1, 2, 3, 0).numpy()
    assert out.shape == ref.shape == (4, 16, 24, 4 + 2 + 1)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-4)


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def _assert_round_trip(model, variables):
    back = convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()})
    for coll in ("params", "constants"):
        got = {k: np.asarray(v) for k, v in _flat(back[coll])}
        want = {k: np.asarray(v) for k, v in _flat(variables[coll])}
        assert got.keys() == want.keys(), coll
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg="/".join(k))


def test_state_dict_round_trip_is_exact(models):
    """``convert_state_dict(port.state_dict())`` reproduces the JAX tree."""
    _, _, variables, model = models
    sd = model.state_dict()
    assert "backbone.body.layer3.5.conv2.weight" in sd
    assert "backbone.fpn.fpn_inner4.weight" in sd
    assert "embedding_head.block_32x.4.weight" in sd
    assert "embedding_head.conv_16.weight" in sd
    assert "seediness_head.conv_out.weight" in sd
    assert sd["embedding_head.time_scale"].shape == ()
    _assert_round_trip(model, variables)


# SMALL with ``stemseg-ytvis-x101``'s body, X-101-FPN (3/4/23/3 bottlenecks
# with the stride on the grouped 3x3), narrowed to 4 groups of 4 channels,
# and youtube_vis's head layout: the seediness fused into the embedding
# head, a semseg head
X101_SMALL = copy.deepcopy(SMALL)
X101_SMALL["input"]["num_classes"] = 4
X101_SMALL["model"]["backbone"]["type"] = "X-101-FPN"
X101_SMALL["model"]["resnets"].update(num_groups=4, width_per_group=4, stride_in_1x1=False)
X101_SMALL["model"].update(use_seediness_head=False, use_semseg_head=True,
                           semseg={"inter_channels": [32, 32, 16, 16], "gn_num_groups": 8})


@pytest.fixture(scope="module")
def x101_models():
    jcfg = jax_load_config(X101_SMALL)
    jmodel = jax_build_model(jcfg, for_training=False)
    variables = random_variables(jmodel, (1, 4, 64, 96, 3), 11)
    model = build_model(load_config(X101_SMALL), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables))
    return jcfg, jmodel, variables, model


def test_x101_body_is_grouped_with_the_stride_on_the_3x3(x101_models):
    """Every bottleneck's 3x3 has 4 groups; a stage's first one carries the
    stride, its 1x1 none; the grouped kernel came across from JAX's
    ``[3, 3, 8, 32]`` (in / groups, out)."""
    _, _, variables, model = x101_models
    body = model.backbone.body
    assert [len(getattr(body, f"layer{i}")) for i in range(1, 5)] == [3, 4, 23, 3]
    block = body.layer2[0]
    assert block.conv1.stride == (1, 1) and block.conv2.stride == (2, 2)
    assert all(b.conv2.groups == 4 for i in range(1, 5) for b in getattr(body, f"layer{i}"))
    kernel = variables["params"]["body"]["layer2_0"]["conv2"]["conv"]["kernel"]
    assert kernel.shape == (3, 3, 8, 32) and block.conv2.weight.shape == (32, 8, 3, 3)
    np.testing.assert_array_equal(block.conv2.weight.detach().numpy(),
                                  kernel.transpose(3, 2, 0, 1))


def test_x101_backbone_fpn_matches_jax(x101_models):
    _check_backbone_fpn(x101_models)


def test_x101_full_forward_matches_jax(x101_models):
    """The port's training forward of one 4-frame clip (backbone, then the
    embedding head with its seediness channel and the semseg head) against
    the JAX model's."""
    _, jmodel, variables, model = x101_models
    rng = np.random.RandomState(4)
    clip = (rng.randn(1, 4, 64, 96, 3) * 40).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(clip))

    with torch.no_grad():
        out = model(torch.from_numpy(clip).permute(0, 1, 4, 2, 3))
    emb = out["embeddings"][0].permute(1, 2, 3, 0).numpy()
    sem = out["semseg_masks"][0].permute(1, 2, 3, 0).numpy()
    assert emb.shape == np.shape(ref["embeddings"])[1:] == (4, 16, 24, 4 + 2 + 1)
    assert sem.shape == np.shape(ref["semseg_masks"])[1:] == (4, 16, 24, 4 + 1)
    np.testing.assert_allclose(emb, np.asarray(ref["embeddings"])[0], atol=ATOL, rtol=1e-4)
    np.testing.assert_allclose(sem, np.asarray(ref["semseg_masks"])[0], atol=ATOL, rtol=1e-4)


def test_x101_state_dict_round_trip_is_exact(x101_models):
    """The grouped kernels too: ``convert_state_dict`` of the port's state
    reproduces the JAX tree."""
    _, _, variables, model = x101_models
    _assert_round_trip(model, variables)


@pytest.mark.parametrize("mode", ["xyff", "xyt"])
def test_semseg_state_dict_round_trip_is_exact(mode):
    """With a semseg head and the seediness fused into the embedding head."""
    over = copy.deepcopy(SMALL)
    over["input"]["num_classes"] = 4
    over["model"].update(use_seediness_head=False, use_semseg_head=True,
                         embedding_dim_mode=mode,
                         semseg={"inter_channels": [32, 32, 24, 24], "gn_num_groups": 8})
    if mode == "xyt":
        over["model"]["embeddings"]["embedding_size"] = 3
        over["training"] = {}
    variables = random_variables(jax_build_model(jax_load_config(over), for_training=False),
                                 (1, 4, 64, 96, 3), 7)
    model = build_model(load_config(over), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables))
    sd = model.state_dict()
    assert "seediness_head.conv_out.weight" not in sd
    assert sd["embedding_head.conv_seediness.weight"].shape == (1, 16, 1, 1, 1)
    assert sd["semseg_head.block_32x.0.weight"].shape == (32, 32, 3, 3, 3)
    assert sd["semseg_head.block_8x.1.weight"].shape == (24,)  # GroupNorm
    assert sd["semseg_head.conv_out.weight"].shape == (5, 24, 1, 1, 1)
    _assert_round_trip(model, variables)


def _check_r101_keys(preset):
    from stemseg_tpu.config import load_preset as jax_load_preset
    from stemseg_tpu_torch.config import load_preset

    model = build_model(load_preset(preset), device="cpu")
    sd = model.state_dict()
    assert "backbone.body.layer3.22.conv2.weight" in sd
    shapes = {k: np.zeros((), np.float32) if v.dim() == 0 else np.zeros(v.shape, np.float32)
              for k, v in sd.items()}
    converted = convert_state_dict(shapes)

    jmodel = jax_build_model(jax_load_preset(preset), for_training=False)
    want = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 16, 64, 96, 3), jnp.float32))
    for coll in ("params", "constants"):
        got = {k: tuple(np.shape(v)) for k, v in _flat(converted[coll])}
        assert got == {k: tuple(np.shape(v)) for k, v in _flat(want[coll])}, coll
    return sd


def test_r101_state_dict_keys_map_to_jax():
    """At the DAVIS preset's full R-101 layout the port's keys are exactly
    the ones the JAX converter maps to the JAX model's variables."""
    _check_r101_keys("davis_2")


def test_r101_youtube_vis_state_dict_keys_map_to_jax():
    """The same at the ``youtube_vis`` preset: fused seediness and a semseg
    head of (256, 256, 256, 256) channels with 41 + 1 logits."""
    sd = _check_r101_keys("youtube_vis")
    assert sd["semseg_head.block_4x.0.weight"].shape == (256, 256, 3, 3, 3)
    assert sd["semseg_head.conv_out.weight"].shape == (42, 256, 1, 1, 1)
    assert sd["embedding_head.conv_seediness.weight"].shape == (1, 128, 1, 1, 1)
