"""The port's semseg head, fused seediness and semseg engine branch against
the JAX package on the same weights (carried across with
``state_dict_from_jax``) and the same frames, at narrow widths and R-50:

1. ``SemsegDecoder`` and the full forward of a YT-VIS-shaped model (``xyff``,
   seediness fused into the embedding head, 4 classes + fg) and a
   KITTI-shaped one (``xyt``, E = 3, 3 classes + fg) within 1e-3;
2. the engine against ``InferenceEngine``: per-window maps and averaged
   semseg logits within 1e-3, fg and multiclass masks on >= 99.9 % of the
   pixels, for the ``logits`` and ``argmax`` outputs, the 2-channel softmax
   branch, ``semseg_resize_scale=4`` and a sequence shorter than a window.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemseg_tpu.config import load_config as jax_load_config
from stemseg_tpu.inference.engine import InferenceEngine as JaxEngine
from stemseg_tpu.inference.windows import get_subsequence_frames
from stemseg_tpu.models import build_model as jax_build_model
from stemseg_tpu.models.decoders import SemsegDecoder as JaxSemsegDecoder
from stemseg_tpu_torch.config import load_config
from stemseg_tpu_torch.inference.engine import InferenceEngine
from stemseg_tpu_torch.models import build_model, state_dict_from_jax
from stemseg_tpu_torch.models.decoders import SemsegDecoder
from test_torch_inference import synthetic_frames
from test_torch_model import ATOL, SMALL, random_variables

torch.set_num_threads(2)

MIN_AGREEMENT = 0.999
H, W = 32, 48  # frames, resized to 64x96 network input


def small_cfg(mode, num_classes):
    """A narrow R-50 model with 4-frame windows and a semseg head: ``ytvis``
    (``xyff``, E = 4) or ``kitti`` (``xyt``, E = 3), seediness fused."""
    over = copy.deepcopy(SMALL)
    over["input"].update(num_classes=num_classes, min_dim=64, max_dim=96)
    m = over["model"]
    m.update(use_seediness_head=False, use_semseg_head=True,
             semseg={"inter_channels": [32, 32, 24, 24], "gn_num_groups": 8})
    if mode == "kitti":
        m["embedding_dim_mode"] = "xyt"
        m["embeddings"]["embedding_size"] = 3
        over["training"] = {}
    over["clustering"] = {"min_seediness_prob": 0.5}
    return over


def centre_fg(over, variables):
    """Make the fg decision of random semseg weights vary over the pixels of
    ``synthetic_frames``: the fg logit's weights (with 2 channels, the
    difference of the two) lose their component along the trunk's mean
    output on the first window, so that the fg logit is about 0 on average."""
    model = build_model(load_config(over), device="cpu")
    model.load_state_dict(state_dict_from_jax(variables))
    eng = InferenceEngine(load_config(over), model)
    with torch.no_grad():
        feats = model.backbone_features(
            eng.preprocess(torch.from_numpy(synthetic_frames()[:4]), (64, 96)))
        trunk = model.semseg_head.trunk([f.permute(1, 0, 2, 3)[None] for f in feats[::-1]])
    mu = trunk.mean(dim=(0, 2, 3, 4)).double().numpy()
    k = variables["params"]["semseg_head"]["conv_out"]["conv"]["kernel"]
    base = k[0, 0, 0, :, 0] if k.shape[-1] == 2 else 0.0
    d = k[0, 0, 0, :, -1] - base
    k[0, 0, 0, :, -1] -= (d @ mu / (mu @ mu) * mu).astype(np.float32)
    return variables


CASES = {"ytvis": ("ytvis", 4), "kitti": ("kitti", 3), "two_channels": ("ytvis", 1)}


@pytest.fixture(scope="module")
def setups():
    """Per case: (over, JAX variables, port model)."""
    out = {}
    for name, (mode, n_cls) in CASES.items():
        over = small_cfg(mode, n_cls)
        jmodel = jax_build_model(jax_load_config(over), for_training=False)
        variables = centre_fg(over, random_variables(jmodel, (1, 4, 64, 96, 3), 4))
        model = build_model(load_config(over), device="cpu")
        model.load_state_dict(state_dict_from_jax(variables))
        out[name] = (over, jmodel, variables, model)
    return out


def test_semseg_decoder_matches_jax():
    rng = np.random.RandomState(5)
    c = 16
    feats = [rng.randn(1, 4, s, 3 * s // 2, c).astype(np.float32) for s in (2, 4, 8, 16)]
    jdec = JaxSemsegDecoder(num_classes=5, inter_channels=(16, 16, 8, 8), num_frames=4,
                            norm_type="gn", gn_groups=4)
    shapes = jax.eval_shape(jdec.init, jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])

    def walk(tree):
        return {k: walk(v) if hasattr(v, "items") else
                np.asarray(rng.randn(*v.shape) * 0.3, np.float32) for k, v in tree.items()}

    params = walk(shapes["params"])
    ref = np.asarray(jdec.apply({"params": params}, [jnp.asarray(f) for f in feats]))

    dec = SemsegDecoder(c, 5, (16, 16, 8, 8), num_frames=4, norm_type="gn", gn_groups=4)
    sd = state_dict_from_jax({"params": {"semseg_head": params}})
    assert set(sd) == {"semseg_head." + k for k in dec.state_dict()}
    assert sd["semseg_head.conv_out.weight"].shape == (6, 8, 1, 1, 1)
    dec.load_state_dict({k[len("semseg_head."):]: v for k, v in sd.items()})
    with torch.no_grad():
        out = dec([torch.from_numpy(f).permute(0, 4, 1, 2, 3) for f in feats])
    out = out.permute(0, 2, 3, 4, 1).numpy()
    assert out.shape == ref.shape == (1, 4, 16, 24, 6)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("case", ["ytvis", "kitti"])
def test_full_forward_matches_jax(setups, case):
    """Backbone per frame, then the heads on a 4-frame clip: embeddings with
    the fused seediness as their last channel, and the semseg logits."""
    over, jmodel, variables, model = setups[case]
    rng = np.random.RandomState(6)
    clip = (rng.randn(1, 4, 64, 96, 3) * 40).astype(np.float32)
    ref = jmodel.apply(variables, jnp.asarray(clip))
    with torch.no_grad():
        feats = model.backbone_features(torch.from_numpy(clip[0]).permute(0, 3, 1, 2))
        emb, seed, semseg = model.heads([f.permute(1, 0, 2, 3)[None] for f in feats[::-1]])
    assert seed is None and model.seediness_head is None
    e = 4 if case == "ytvis" else 3
    v = 2 if case == "ytvis" else 3
    n_cls = over["input"]["num_classes"] + 1
    for ours, want, ch in ((emb, ref["embeddings"], e + v + 1),
                           (semseg, ref["semseg_masks"], n_cls)):
        ours = ours[0].permute(1, 2, 3, 0).numpy()
        assert ours.shape == np.asarray(want)[0].shape == (4, 16, 24, ch)
        np.testing.assert_allclose(ours, np.asarray(want)[0], atol=ATOL, rtol=1e-4)


def _run_engines(setup, frames, output_type, scale=1.0, overlap=2):
    over, _, variables, model = setup
    windows, _ = get_subsequence_frames(len(frames), 4, overlap)
    jout = JaxEngine(jax_load_config(over), variables, semseg_resize_scale=scale) \
        .infer_sequence(frames, windows, semseg_output_type=output_type, resize_hw=(64, 96))
    out = InferenceEngine(load_config(over), model, semseg_resize_scale=scale) \
        .infer_sequence(frames, windows, resize_hw=(64, 96), semseg_output_type=output_type)
    return jout, out


def _check_windows(jout, out):
    assert len(out["windows"]) == len(jout["windows"])
    for jw, pw in zip(jout["windows"], out["windows"]):
        assert pw["frames"] == jw["frames"]
        for key in ("embeddings", "bandwidths", "seediness"):
            np.testing.assert_allclose(pw[key].numpy(), np.asarray(jw[key]), atol=ATOL,
                                       rtol=1e-4, err_msg=key)


def _agree(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return (a == b).mean()


@pytest.mark.parametrize("case,output_type,n_frames,scale", [
    ("ytvis", "logits", 10, 1.0),
    ("ytvis", "logits", 6, 4.0),
    ("ytvis", "probs", 3, 1.0),  # shorter than a window: frame 0 repeats
    ("kitti", "argmax", 10, 1.0),
    ("kitti", "argmax", 2, 1.0),
])
def test_engine_matches_jax(setups, case, output_type, n_frames, scale):
    frames = synthetic_frames()[:n_frames]
    jout, out = _run_engines(setups[case], frames, output_type, scale)
    _check_windows(jout, out)
    hw = (16 * int(scale), 24 * int(scale))
    jfg = np.asarray(jout["fg_masks"])
    assert out["fg_masks"].shape == jfg.shape == (n_frames,) + hw
    assert 0.02 < jfg.mean() < 0.98
    assert _agree(out["fg_masks"].numpy(), jfg) >= MIN_AGREEMENT
    jmc, mc = np.asarray(jout["multiclass_masks"]), out["multiclass_masks"].numpy()
    if output_type == "argmax":
        assert mc.shape == (n_frames,) + hw
        assert len(np.unique(jmc)) > 1
        assert _agree(mc, jmc) >= MIN_AGREEMENT
    else:
        n_cls = setups[case][0]["input"]["num_classes"]
        assert mc.shape == (n_frames,) + hw + (n_cls,)
        np.testing.assert_allclose(mc, jmc, atol=ATOL, rtol=1e-4)
        assert _agree(mc.argmax(-1), jmc.argmax(-1)) >= MIN_AGREEMENT


def test_engine_two_channel_softmax_branch(setups):
    """2 semseg channels: fg is channel 1 of their softmax, no multiclass."""
    frames = synthetic_frames()[:6]
    jout, out = _run_engines(setups["two_channels"], frames, "logits")
    _check_windows(jout, out)
    assert jout["multiclass_masks"] is None and out["multiclass_masks"] is None
    jfg = np.asarray(jout["fg_masks"])
    assert 0.02 < jfg.mean() < 0.98
    assert _agree(out["fg_masks"].numpy(), jfg) >= MIN_AGREEMENT
