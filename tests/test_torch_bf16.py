"""bfloat16 compute with float32 parameters (``build_model(dtype=)``, the
inference CLI's ``--bf16``) against the JAX package's bf16 on the same
weights (``state_dict_from_jax``) and inputs (numpy seeds), R-50:

1. the forward of the default config (semseg head, ``xyt``) on a clip of 8
   frames of 64x96: port-bf16 and JAX-bf16 each against the shared fp32
   output at the JAX suite's bf16 bounds (``tests/test_bf16.py``):
   embeddings max abs error < 0.02, variance channels' median relative
   error < 0.05, semseg argmax agreement >= 0.99 and exact where the fp32
   margin is > 0.05; port-bf16 against JAX-bf16 within twice those bounds;
   the outputs are bfloat16 and differ from the port's fp32;
2. every convolution of the backbone, FPN and heads computes in bfloat16
   (input and weight of each ``F.conv2d`` / ``F.conv3d`` call, and each
   conv module's output), so a dropped cast fails;
3. the engine on a DAVIS-shaped narrow model, 8 frames of 64x96 in windows
   of 4: each window's embeddings, bandwidths and seediness against JAX's
   fp32 and bf16 engines, fg masks against JAX-bf16's on >= 99.9 % of the
   pixels, the feature rings and head outputs bf16, the averages float32;
4. the inference CLI with ``--bf16`` on both packages over the same PNG
   sequence (``--profile_clustering``, which keeps the JAX CLI on its
   streaming path, whose fg masks and labels can be read): fg masks on
   >= 99.9 % of the pixels; labels on >= 90 % of the pixels, >= 95 % with
   the track ids matched one to one (measured 0.9186 and 0.9600): the JAX
   package clusters a bf16 window in bf16 on the CPU, the port in float32,
   so seeds and the points near a cluster's edge move.

The DAVIS-shaped model's seediness head is a linear probe of its trunk
(``probe_seediness``): random weights put the seediness near 0.5
everywhere, where bf16's 8 mantissa bits decide the fg masks.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from stemseg_tpu.config import load_config as jax_load_config
from stemseg_tpu.inference.main import TrackGenerator as JaxTrackGenerator
from stemseg_tpu.inference.output_utils import DavisOutputGenerator as JaxDavisWriter
from stemseg_tpu.models import build_model as jax_build_model
from stemseg_tpu_torch.config import load_config
from stemseg_tpu_torch.inference.engine import InferenceEngine
from stemseg_tpu_torch.inference.main import TrackGenerator
from stemseg_tpu_torch.inference.output_utils import DavisOutputGenerator
from stemseg_tpu_torch.models import build_model, state_dict_from_jax
from stemseg_tpu_torch.models.decoders import SqueezeExpandDecoder
from test_torch_model import SMALL, random_variables

torch.set_num_threads(2)

T, H, W = 8, 64, 96
EMB_ATOL = 0.02
VAR_MEDIAN_RTOL = 0.05
ARGMAX_AGREEMENT = 0.99
CONFIDENT_MARGIN = 0.05
FG_AGREEMENT = 0.999
FG_AGREEMENT_FP32 = 0.99
# measured 0.9186 and, ids matched one to one, 0.9600 (about 480 fg pixels)
LABEL_AGREEMENT = 0.9
MATCHED_LABEL_AGREEMENT = 0.95
WINDOW, OVERLAP = 4, 2
SEEDINESS_THRESH = 0.5

DEFAULT_R50 = {"input": {"num_frames": T, "num_classes": 2, "min_dim": H, "max_dim": W},
               "model": {"backbone": {"type": "R-50-FPN"}}}


def _np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def forward():
    """Outputs [N, T, h, w, C] float32 of JAX fp32 / bf16 and port fp32 / bf16."""
    jcfg, cfg = jax_load_config(DEFAULT_R50), load_config(DEFAULT_R50)
    variables = random_variables(jax_build_model(jcfg, for_training=False), (1, T, H, W, 3), 0)
    images = np.random.RandomState(0).randn(1, T, H, W, 3).astype(np.float32) * 50
    out = {}
    for name, dtype in (("jax32", None), ("jax16", jnp.bfloat16)):
        jmodel = jax_build_model(jcfg, for_training=False, dtype=dtype)
        out[name] = {k: np.asarray(v, np.float32)
                     for k, v in jax.jit(jmodel.apply)(variables, images).items()}
    sd = state_dict_from_jax(variables)
    models = {}
    for name, dtype in (("port32", None), ("port16", torch.bfloat16)):
        models[name] = build_model(cfg, device="cpu", dtype=dtype)
        models[name].load_state_dict(sd)
        with torch.no_grad():
            res = models[name](torch.from_numpy(images).permute(0, 1, 4, 2, 3))
        out[name] = {k: v.float().permute(0, 2, 3, 4, 1).numpy() for k, v in res.items()}
        out[name + "_dtypes"] = {v.dtype for v in res.values()}
    return out, models, images


def errors(got, want, e=3):
    """(embeddings max abs error, variances' median relative error, semseg
    argmax agreement, argmax flips where the fp32 margin is > 0.05)."""
    emb = float(np.abs(got["embeddings"][..., :e] - want["embeddings"][..., :e]).max())
    var_g, var_w = got["embeddings"][..., e:], want["embeddings"][..., e:]
    var = float(np.median(np.abs(var_g - var_w) / (np.abs(var_w) + 1e-3)))
    lg, lw = got["semseg_masks"][..., :-1], want["semseg_masks"][..., :-1]
    top2 = np.sort(lw, axis=-1)[..., -2:]
    confident = top2[..., 1] - top2[..., 0] > CONFIDENT_MARGIN
    assert confident.mean() > 0.5  # the check covers real pixels
    same = lg.argmax(-1) == lw.argmax(-1)
    return emb, var, float(same.mean()), int((~same & confident).sum())


@pytest.mark.parametrize("name", ["port16", "jax16"])
def test_bf16_forward_within_the_jax_suite_bounds_of_fp32(forward, name):
    out, _, _ = forward
    np.testing.assert_allclose(out["port32"]["embeddings"], out["jax32"]["embeddings"],
                               atol=1e-3, rtol=1e-4)
    emb, var, agree, flips = errors(out[name], out["jax32"])
    assert emb < EMB_ATOL and var < VAR_MEDIAN_RTOL, (emb, var)
    assert agree >= ARGMAX_AGREEMENT and flips == 0, (agree, flips)


def test_port_bf16_within_twice_the_bounds_of_jax_bf16(forward):
    out, _, _ = forward
    assert out["port16_dtypes"] == {torch.bfloat16}
    assert out["port32_dtypes"] == {torch.float32}
    emb, var, agree, flips = errors(out["port16"], out["jax16"])
    assert emb < 2 * EMB_ATOL and var < 2 * VAR_MEDIAN_RTOL, (emb, var)
    assert agree >= 1 - 2 * (1 - ARGMAX_AGREEMENT), agree
    # bf16 rounds: the port's bf16 is not its fp32
    assert np.abs(out["port16"]["embeddings"] - out["port32"]["embeddings"]).max() > 1e-4


def test_every_conv_computes_in_bf16(forward, monkeypatch):
    _, models, images = forward
    model = models["port16"]
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    seen = []
    for fn_name in ("conv2d", "conv3d"):
        inner = getattr(F, fn_name)

        def spy(x, weight, *args, _inner=inner, **kwargs):
            seen.append((x.dtype, weight.dtype))
            return _inner(x, weight, *args, **kwargs)

        monkeypatch.setattr(F, fn_name, spy)
    outputs = []
    convs = [m for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    hooks = [m.register_forward_hook(lambda mod, inp, out: outputs.append(out.dtype))
             for m in convs]
    try:
        with torch.no_grad():
            model(torch.from_numpy(images[:, :4]).permute(0, 1, 4, 2, 3))
    finally:
        for h in hooks:
            h.remove()
    # every conv module runs once, the 3 expand convs of each head as 2
    # functional calls and no module call
    n_fuse = 3 * sum(isinstance(m, SqueezeExpandDecoder) for m in model.modules())
    assert n_fuse == 6  # embedding and semseg heads
    assert len(seen) == len(convs) - n_fuse + 2 * n_fuse
    assert set(seen) == {(torch.bfloat16, torch.bfloat16)}, set(seen)
    assert len(outputs) == len(convs) - n_fuse and set(outputs) == {torch.bfloat16}


# --- the engine and the CLI on a DAVIS-shaped narrow model --------------------

def davis_over():
    over = copy.deepcopy(SMALL)
    over["input"].update(num_frames=WINDOW, min_dim=H, max_dim=W)
    over["clustering"] = {"min_seediness_prob": 0.58}
    return over


def frames_8():
    """Moving discs on a gradient with pixel noise, BGR uint8, 8 x 64x96,
    and the discs' masks."""
    rng = np.random.RandomState(3)
    yy, xx = np.mgrid[:H, :W]
    frames = np.zeros((T, H, W, 3), np.float32) + np.stack(
        [yy * 0.5 + 40, xx * 0.5 + 60, (yy + xx) * 0.3 + 80], -1)
    masks = np.zeros((T, H, W), bool)
    for t in range(T):
        for cy, cx, r, col in [(20, 20 + 2 * t, 12, (200, 30, 30)),
                               (44, 70 - 2 * t, 14, (20, 220, 40)),
                               (32, 48, 10, (30, 40, 230))]:
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 < r * r
            frames[t][disc] = col
            masks[t] |= disc
    return np.clip(frames + rng.randn(T, H, W, 3) * 8, 0, 255).astype(np.uint8), masks


def probe_seediness(cfg, variables, frames, masks, logit=4.0):
    """``variables`` with the seediness head's output conv replaced by the
    least-squares linear probe of its fp32 trunk features for ``±logit``
    on the discs / the background. Random weights give a seediness near
    0.5 everywhere, where bf16's 8 mantissa bits decide the fg mask (a
    third of the pixels within 0.01 of 0.5); the probe, as a trained head,
    puts most pixels far from the threshold."""
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables))
    x, y = [], []
    with torch.no_grad():
        feats = model.backbone_features(
            InferenceEngine(cfg, model).preprocess(torch.from_numpy(frames), (H, W)))
        for s in range(0, T, WINDOW):
            clip = [f[s:s + WINDOW].permute(1, 0, 2, 3)[None] for f in feats[::-1]]
            trunk = model.seediness_head.trunk(clip)[0]
            x.append(trunk.permute(1, 2, 3, 0).reshape(-1, trunk.shape[0]).numpy())
            y.append(masks[s:s + WINDOW, ::4, ::4].reshape(-1))
    w = np.linalg.lstsq(np.concatenate(x), np.where(np.concatenate(y), logit, -logit),
                        rcond=None)[0]
    out = copy.deepcopy(variables)
    out["params"]["seediness_head"]["conv_out"]["conv"]["kernel"] = \
        w.reshape(1, 1, 1, -1, 1).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def davis_setup(tmp_path_factory):
    over = davis_over()
    jcfg, cfg = jax_load_config(over), load_config(over)
    frames, masks = frames_8()
    variables = probe_seediness(cfg, random_variables(
        jax_build_model(jcfg, for_training=False), (1, WINDOW, H, W, 3), 1), frames, masks)
    root = tmp_path_factory.mktemp("bf16")
    engines = {}
    for name, bf16 in (("jax32", False), ("jax16", True)):
        engines[name] = JaxTrackGenerator(jcfg, "davis", variables,
                                          JaxDavisWriter(str(root / name)), 20,
                                          seediness_thresh=SEEDINESS_THRESH,
                                          frame_overlap=OVERLAP, use_fused=False, bf16=bf16)
    for name, dtype in (("port32", None), ("port16", torch.bfloat16)):
        model = build_model(cfg, device="cpu", dtype=dtype)
        model.load_state_dict(state_dict_from_jax(variables))
        engines[name] = TrackGenerator(cfg, "davis", model,
                                       DavisOutputGenerator(str(root / name), device="cpu"), 20,
                                       seediness_thresh=SEEDINESS_THRESH, frame_overlap=OVERLAP)
    outs = {name: tg.do_inference(frames, (H, W)) for name, tg in engines.items()}
    return cfg, variables, engines, outs, frames


def test_engine_windows_in_bf16(davis_setup):
    _, _, _, outs, _ = davis_setup
    p16, j16, j32 = outs["port16"], outs["jax16"], outs["jax32"]
    assert len(p16["windows"]) == len(j16["windows"]) == 3
    for pw, jw16, jw32 in zip(p16["windows"], j16["windows"], j32["windows"]):
        assert pw["frames"] == jw16["frames"]
        assert {pw[k].dtype for k in ("embeddings", "bandwidths", "seediness")} == \
            {torch.bfloat16}
        # the probe's logits cancel (|w| |x| is 20x the logit), so bf16
        # moves the seediness by up to 0.1 in JAX too: bounded by JAX's own
        jax_seed = np.abs(_np(jw16["seediness"]) - _np(jw32["seediness"])).max()
        for ref, scale in ((jw32, 1), (jw16, 2)):
            emb = np.abs(_np(pw["embeddings"]) - _np(ref["embeddings"])).max()
            bw_w = _np(ref["bandwidths"])
            bw = np.median(np.abs(_np(pw["bandwidths"]) - bw_w) / bw_w)
            seed = np.abs(_np(pw["seediness"]) - _np(ref["seediness"])).max()
            assert emb < scale * EMB_ATOL and bw < scale * VAR_MEDIAN_RTOL, (emb, bw)
            assert seed <= scale * 1.5 * jax_seed, (seed, jax_seed)
    fg, jfg = p16["fg_masks"].numpy(), np.asarray(j16["fg_masks"])
    assert p16["fg_masks"].dtype == torch.bool and fg.shape == jfg.shape == (T, 16, 24)
    assert 0.1 < jfg.mean() < 0.9
    assert (fg == jfg).mean() >= FG_AGREEMENT
    # against fp32 a bf16 mask moves where the averaged seediness lies
    # within bf16's rounding of the threshold, in JAX as in the port
    # (measured 0.9938 and 0.9935)
    j32_fg = np.asarray(j32["fg_masks"])
    assert (fg == j32_fg).mean() >= FG_AGREEMENT_FP32
    assert (np.asarray(j16["fg_masks"]) == j32_fg).mean() >= FG_AGREEMENT_FP32


def _spy_on_clustering(monkeypatch, cls, store):
    inner = cls.do_clustering

    def do_clustering(self, out):
        result = inner(self, out)
        store["fg"] = _np(out["fg_masks"]) > 0
        store["labels"] = np.asarray(result[0])
        return result

    monkeypatch.setattr(cls, "do_clustering", do_clustering)


def matched_agreement(a, b):
    """Share of pixels whose labels agree after the one-to-one matching of
    ``a``'s track ids to ``b``'s that maximises the agreement (outliers -1
    match only -1)."""
    from scipy.optimize import linear_sum_assignment

    ids_a, ids_b = np.unique(a), np.unique(b)
    overlap = np.array([[np.sum((a == i) & (b == j)) if (i < 0) == (j < 0) else 0
                         for j in ids_b] for i in ids_a])
    rows, cols = linear_sum_assignment(-overlap)
    return overlap[rows, cols].sum() / a.size


def write_davis_dataset(root, frames, seq_id="seqA"):
    """PNG frames (lossless) and ``davis_val.json``; returns the environment."""
    import cv2

    base = root / "davis"
    (base / seq_id).mkdir(parents=True)
    paths = []
    for t, frame in enumerate(frames):
        paths.append(f"{seq_id}/{t:05d}.png")
        cv2.imwrite(str(base / paths[-1]), frame)
    ann = root / "ann"
    ann.mkdir()
    (ann / "davis_val.json").write_text(json.dumps({
        "meta": {"category_labels": {"1": "object"}},
        "sequences": [{"id": seq_id, "height": int(frames.shape[1]),
                       "width": int(frames.shape[2]), "image_paths": paths}]}))
    return {"DAVIS_BASE_DIR": str(base), "STEMSEG_JSON_ANNOTATIONS_DIR": str(ann)}


def test_cli_bf16_against_jax_cli_bf16(davis_setup, tmp_path, monkeypatch):
    import yaml

    from stemseg_tpu.inference import main as jax_cli
    from stemseg_tpu_torch.config import to_dict
    from stemseg_tpu_torch.inference import main as cli

    cfg, _, engines, _, frames = davis_setup
    for k, v in write_davis_dataset(tmp_path, frames).items():
        monkeypatch.setenv(k, v)
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "config.yaml").write_text(yaml.safe_dump(to_dict(cfg)))
    torch.save(engines["port32"].engine.model.state_dict(), model_dir / "weights.pth")

    runs = {}
    for name, module, cls in (("jax", jax_cli, JaxTrackGenerator), ("port", cli, TrackGenerator)):
        runs[name] = {}
        _spy_on_clustering(monkeypatch, cls, runs[name])
        argv = [str(model_dir / "weights.pth"), "-o", str(tmp_path / name), "--dataset", "davis",
                "-fo", str(OVERLAP), "-st", str(SEEDINESS_THRESH), "--bf16",
                "--profile_clustering"]
        module.main(argv + (["--device", "cpu"] if name == "port" else []))
    jax_run, port_run = runs["jax"], runs["port"]
    assert port_run["fg"].shape == jax_run["fg"].shape == (T, 16, 24)
    assert (port_run["fg"] == jax_run["fg"]).mean() >= FG_AGREEMENT
    agreement = (port_run["labels"] == jax_run["labels"]).mean()
    matched = matched_agreement(port_run["labels"], jax_run["labels"])
    assert agreement >= LABEL_AGREEMENT and matched >= MATCHED_LABEL_AGREEMENT, \
        (agreement, matched)
    assert len(np.unique(port_run["labels"])) > 3  # several tracks
    for t in range(T):
        name = os.path.join("results", "seqA", f"{t:05d}.png")
        assert os.path.isfile(tmp_path / "port" / name)
