"""The port's fused sequence path (``FusedSequencePipeline``) against the
JAX package's fused pipeline (``backend="xla"``) and against the port's own
streaming path, at the JAX test's size (``tests/test_fused_pipeline.py``):
R-50-FPN, windows of 4 frames, K = 5, ``min_seediness_prob`` 0.3, frames of
64x96, the JAX model's flax init carried across with ``state_dict_from_jax``.
The port takes raw uint8 frames, so every case is the JAX test's raw-uint8
form (on-device resize and normalisation).

1. Against JAX (three JAX fused runs): labels and fg masks bit-identical,
   multiclass masks within the JAX test's own tolerance between its paths
   (rtol 1e-5, atol 1e-6: the two packages' convolutions round apart),
   track counts and lifetimes equal, on a multi-window sequence (10 frames
   of 60x90 resized to 64x96) and on the full-scale path (8 frames,
   ``--resize_embeddings``, logits); bf16 against JAX's fused bf16 at the
   bounds of ``tests/test_torch_bf16.py``: fg masks on >= 99.9 % of the
   pixels (measured 1.0), labels on >= 90 % of the pixels and >= 95 % with
   the track ids matched one to one (measured 0.9526 and 0.9792: JAX's
   fused graph clusters a bf16 window in float32, as the port does, so only
   the two packages' bf16 convolutions differ, and a seed moves).
2. Against the port's streaming path: bit-identical labels, equal masks on
   the single-window, tail-window, pre-padded-frames and memoised-schedule
   cases.
3. The CLI's routing: sequences of at least ``num_frames`` frames take the
   fused path, shorter ones and ``--profile_clustering`` the streaming one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemseg_tpu.config import load_config as jax_load_config
from stemseg_tpu.inference import get_subsequence_frames as jax_windows
from stemseg_tpu.inference.clustering import ClusterParams as JaxClusterParams
from stemseg_tpu.inference.engine import InferenceEngine as JaxEngine
from stemseg_tpu.inference.fused_pipeline import FusedSequencePipeline as JaxFused
from stemseg_tpu.models import build_model as jax_build_model
from stemseg_tpu_torch.config import load_config, merge
from stemseg_tpu_torch.inference.chainer import OnlineChainer
from stemseg_tpu_torch.inference.clustering import ClusterParams, cluster_window
from stemseg_tpu_torch.inference.engine import InferenceEngine, upscale_window
from stemseg_tpu_torch.inference.fused_pipeline import FusedSequencePipeline
from stemseg_tpu_torch.inference.main import TrackGenerator
from stemseg_tpu_torch.inference.output_utils import DavisOutputGenerator
from stemseg_tpu_torch.inference.windows import get_subsequence_frames
from stemseg_tpu_torch.models import build_model, state_dict_from_jax
from test_torch_bf16 import matched_agreement

torch.set_num_threads(2)

OVER = {"input": {"num_frames": 4, "num_classes": 2},
        "model": {"backbone": {"type": "R-50-FPN"}},
        # loose thresholds so that random weights still give clusters
        "clustering": {"min_seediness_prob": 0.3, "max_instances": 5}}
HW = (64, 96)
FG_AGREEMENT = 0.999
BF16_LABEL_AGREEMENT = 0.9
BF16_MATCHED_LABEL_AGREEMENT = 0.95


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_load_config(OVER), load_config(OVER)
    jmodel = jax_build_model(jcfg, for_training=False)
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                     jnp.zeros((1, 4) + HW + (3,))))
    models = {}
    for name, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        models[name] = build_model(cfg, device="cpu", dtype=dtype)
        models[name].load_state_dict(state_dict_from_jax(variables))
    rng = np.random.RandomState(1)
    frames = {"raw": (rng.rand(10, 60, 90, 3) * 255).astype(np.uint8),
              "full": (rng.rand(11, 64, 96, 3) * 255).astype(np.uint8)}
    return jcfg, cfg, variables, models, frames


def _params(cfg):
    c = cfg.clustering
    return (ClusterParams(c.primary_prob_threshold, c.secondary_prob_threshold,
                          c.min_seediness_prob, c.max_instances),
            JaxClusterParams(c.primary_prob_threshold, c.secondary_prob_threshold,
                             c.min_seediness_prob, c.max_instances))


def _pipe(cfg, model, full_scale=False):
    engine = InferenceEngine(cfg, model, semseg_resize_scale=4.0 if full_scale else 1.0)
    return FusedSequencePipeline(engine, _params(cfg)[0], cluster_full_scale=full_scale)


def _fused(cfg, model, frames, full_scale=False, semseg_output_type="probs", overlap=2):
    windows = get_subsequence_frames(len(frames), 4, overlap)
    return _pipe(cfg, model, full_scale).run(frames, windows, resize_hw=HW,
                                             semseg_output_type=semseg_output_type)


def _streaming(cfg, model, frames, full_scale=False, semseg_output_type="probs", overlap=2):
    engine = InferenceEngine(cfg, model, semseg_resize_scale=4.0 if full_scale else 1.0)
    params = _params(cfg)[0]
    windows = get_subsequence_frames(len(frames), 4, overlap)
    out = engine.infer_sequence(frames, windows, resize_hw=HW,
                                semseg_output_type=semseg_output_type)

    def cluster_fn(emb, bw, seed, fg, start):
        if full_scale:
            emb, bw = upscale_window(emb), upscale_window(bw)
            seed = upscale_window(seed[..., None])[..., 0]
        return cluster_window(emb, bw, seed, fg, params, start)

    labels, counts, lifetimes, _ = OnlineChainer(cluster_fn, params.max_instances).process(
        out["fg_masks"], out["windows"])
    mc = out["multiclass_masks"]
    return labels, counts, lifetimes, out["fg_masks"].numpy(), (
        None if mc is None else mc.numpy())


def _jax_fused(jcfg, variables, frames, full_scale=False, semseg_output_type="probs",
               dtype=None):
    engine = JaxEngine(jcfg, variables, dtype=dtype,
                       semseg_resize_scale=4.0 if full_scale else 1.0)
    pipe = JaxFused(engine, _params(jcfg)[1], cluster_full_scale=full_scale, backend="xla")
    windows, _ = jax_windows(len(frames), 4, 2)
    return pipe.run(frames, windows, semseg_output_type=semseg_output_type, resize_hw=HW)


@pytest.mark.parametrize("case", ["multi_window_raw_uint8", "full_scale"])
def test_fused_matches_jax(setup, case):
    jcfg, cfg, variables, models, frames = setup
    full = case == "full_scale"
    clip = frames["full"][:8] if full else frames["raw"]
    kw = dict(full_scale=full, semseg_output_type="logits" if full else "probs")
    want = _jax_fused(jcfg, variables, clip, **kw)
    got = _fused(cfg, models["fp32"], clip, **kw)
    assert got[0].dtype == np.int32 and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_allclose(got[4].numpy(), want[4], rtol=1e-5, atol=1e-6)
    assert got[1] == want[1] and got[2] == want[2]
    assert got[3].sum() > 0 and len(got[1]) > 3, "degenerate: no foreground or no clusters"


def test_fused_bf16_matches_jax_bf16(setup):
    jcfg, cfg, variables, models, frames = setup
    want = _jax_fused(jcfg, variables, frames["raw"], dtype=jnp.bfloat16)
    got = _fused(cfg, models["bf16"], frames["raw"])
    assert got[0].dtype == np.int32 and got[0].shape == want[0].shape
    fg = (got[3] == want[3]).mean()
    labels = (got[0] == want[0]).mean()
    matched = matched_agreement(got[0], want[0])
    assert fg >= FG_AGREEMENT and labels >= BF16_LABEL_AGREEMENT, (fg, labels)
    assert matched >= BF16_MATCHED_LABEL_AGREEMENT, matched
    assert np.isfinite(got[4].numpy()).all() and len(got[1]) > 3


@pytest.mark.parametrize("n,overlap,k", [(4, 2, 5), (9, 2, 5), (11, 2, 5), (11, 3, 5),
                                         (10, 2, 3)])
def test_fused_matches_streaming(setup, n, overlap, k):
    """One window (exactly T frames, no association), a tail window with a
    shorter stride, several windows, a stride of one frame (overlap frames
    committed up to three windows back: a look-back band of 3), and K = 3
    over 4 windows, whose last band (8 rows, rounded up from 3) reaches
    past the last id."""
    _, cfg, _, models, frames = setup
    cfg = merge(cfg, {"clustering": {"max_instances": k}})
    clip = frames["full"][:n]
    windows = get_subsequence_frames(n, 4, overlap)
    if n == 9:
        assert windows[-1] == [5, 6, 7, 8] and windows[-2][0] != 5
    want = _streaming(cfg, models["fp32"], clip, overlap=overlap)
    got = _fused(cfg, models["fp32"], clip, overlap=overlap)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4].numpy(), want[4])
    assert got[1] == want[1] and got[2] == want[2]


def test_fused_full_scale_matches_streaming(setup):
    _, cfg, _, models, frames = setup
    clip = frames["full"][:8]
    want = _streaming(cfg, models["fp32"], clip, full_scale=True, semseg_output_type="logits")
    got = _fused(cfg, models["fp32"], clip, full_scale=True, semseg_output_type="logits")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4].numpy(), want[4])


def test_prepadded_frames_slice_to_the_true_length(setup):
    """Frames already padded to the padded length (a tensor, as device-
    resident frames arrive) give the unpadded run's outputs, sliced to the
    schedule's length; a second run of the same bucket reuses its buffers."""
    _, cfg, _, models, frames = setup
    pipe = _pipe(cfg, models["fp32"])
    windows = get_subsequence_frames(10, 4, 2)
    want = pipe.run(frames["full"][:10], windows, resize_hw=HW)
    padded = torch.from_numpy(np.concatenate(
        [frames["full"][:10], np.full((6,) + frames["full"].shape[1:], 77, np.uint8)]))
    got = pipe.run(padded, windows, resize_hw=HW)
    assert got[0].shape[0] == 10 and got[3].shape[0] == 10
    np.testing.assert_array_equal(want[0], got[0])
    assert want[1] == got[1] and want[2] == got[2]
    with pytest.raises(ValueError):
        pipe.run(padded[:12], windows, resize_hw=HW)


def test_state_shared_across_lengths(setup):
    """Sequences of one frame size share one device state: a longer one
    grows its buffers (a new state), a shorter one reuses them, and each
    gives a fresh pipeline's outputs (rows of earlier, longer runs left in
    the buffers are never read)."""
    _, cfg, _, models, frames = setup
    pipe = _pipe(cfg, models["fp32"])
    for n, states in ((10, 1), (11, 2), (9, 2), (10, 2)):
        windows = get_subsequence_frames(n, 4, 2)
        got = pipe.run(frames["full"][:n], windows, resize_hw=HW)
        want = _pipe(cfg, models["fp32"]).run(frames["full"][:n], windows, resize_hw=HW)
        assert pipe.states_made == states, (n, pipe.states_made)
        for a, b in zip(got, want):
            if torch.is_tensor(a):  # the multiclass masks
                a, b = a.numpy(), b.numpy()
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    assert (pipe._state.l_cap, pipe._state.w_cap) == (16, 8)


def test_schedule_memoised_across_runs(setup):
    _, cfg, _, models, _ = setup
    pipe = _pipe(cfg, models["fp32"])
    windows = get_subsequence_frames(10, 4, 2)
    s1 = pipe._schedule(windows, 5, 16, 8)
    assert pipe._schedule(windows, 5, 16, 8) is s1
    s3 = pipe._schedule(get_subsequence_frames(8, 4, 2), 5, 16, 8)
    assert s3 is not s1
    pipe._schedule_cache.clear()
    s4 = pipe._schedule(windows, 5, 16, 8)
    assert s4 is not s1
    np.testing.assert_array_equal(s4.win_frames, s1.win_frames)
    assert s1.n_new[:3] == [0, 2, 2] and s1.lookback == 1


class _Seq:
    id = "seqA"
    image_dims = HW

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,profile_clustering,fused", [(11, False, True), (3, False, False),
                                                        (11, True, False)])
def test_cli_routing(setup, tmp_path, n, profile_clustering, fused):
    _, cfg, _, models, frames = setup
    cfg = merge(cfg, {"input": {"min_dim": HW[0], "max_dim": HW[1]}})
    tg = TrackGenerator(cfg, "davis", models["fp32"],
                        DavisOutputGenerator(str(tmp_path), device="cpu"), 20,
                        frame_overlap=2, profile_clustering=profile_clustering)
    assert (tg.fused is not None) == (not profile_clustering)
    labels, counts, _, per_window = tg._process_loaded(_Seq(n), frames["full"][:n], HW, 20)
    assert (per_window is None) == fused
    assert labels.shape == (n, 16, 24) and len(counts) > 1
