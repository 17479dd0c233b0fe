"""The port's DAVIS slice as a whole against the JAX package on the same
frames and weights (small R-50 model, 10 frames of 32x48 resized to 64x96,
4-frame windows with overlap 2):

1. engine outputs against ``InferenceEngine`` within 1e-3;
2. the port's clustering + chainer + DAVIS writer fed the JAX engine's
   outputs: labels, counts and lifetimes identical, PNG pixels identical
   (the final 2x downscale of this geometry is exact in float32);
3. the port's ``TrackGenerator`` against ``TrackGenerator(use_fused=False)``
   end to end: labels agree on at least 99.9 % of the pixels.
"""

import copy
import os

import numpy as np
import pytest
import torch
from PIL import Image

from stemseg_tpu.config import load_config as jax_load_config
from stemseg_tpu.inference.main import TrackGenerator as JaxTrackGenerator
from stemseg_tpu.inference.output_utils import DavisOutputGenerator as JaxDavisWriter
from stemseg_tpu.models import build_model as jax_build_model
from stemseg_tpu_torch.config import load_config
from stemseg_tpu_torch.inference.main import TrackGenerator
from stemseg_tpu_torch.inference.output_utils import DavisOutputGenerator
from stemseg_tpu_torch.models import build_model, state_dict_from_jax
from test_torch_model import SMALL, random_variables

torch.set_num_threads(2)

ATOL = 1e-3
MIN_AGREEMENT = 0.999
T, H, W = 10, 32, 48
OVERLAP = 2
SEEDINESS_THRESH = 0.5


class Sequence:
    id = "seqA"
    image_dims = (H, W)

    def __len__(self):
        return T


def synthetic_frames(seed=0):
    """Three moving discs on a flat background, with pixel noise; BGR uint8."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W]
    frames = np.zeros((T, H, W, 3), np.float32) + np.array([60, 90, 120])
    for t in range(T):
        for cy, cx, r, col in [(10, 10 + t, 6, (200, 30, 30)),
                               (22, 35 - t, 7, (20, 220, 40)),
                               (16, 24, 5, (30, 40, 230))]:
            frames[t][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = col
    return np.clip(frames + rng.randn(T, H, W, 3) * 8, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def slice_setup(tmp_path_factory):
    over = copy.deepcopy(SMALL)
    over["input"].update(min_dim=64, max_dim=96)
    over["clustering"] = {"min_seediness_prob": 0.58}
    jcfg, cfg = jax_load_config(over), load_config(over)
    variables = random_variables(jax_build_model(jcfg, for_training=False),
                                 (1, 4, 64, 96, 3), 1)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables))

    out_dir = tmp_path_factory.mktemp("davis")
    jtg = JaxTrackGenerator(jcfg, "davis", variables,
                            JaxDavisWriter(str(out_dir / "jax")), 20,
                            seediness_thresh=SEEDINESS_THRESH,
                            frame_overlap=OVERLAP, use_fused=False)
    tg = TrackGenerator(cfg, "davis", model,
                        DavisOutputGenerator(str(out_dir / "port"), device="cpu"), 20,
                        seediness_thresh=SEEDINESS_THRESH, frame_overlap=OVERLAP)
    frames = synthetic_frames()
    jax_out = jtg.do_inference(frames, (H, W))
    return jtg, tg, frames, jax_out, out_dir


def test_engine_matches_jax(slice_setup):
    _, tg, frames, jax_out, _ = slice_setup
    out = tg.do_inference(frames, (H, W))
    assert len(out["windows"]) == len(jax_out["windows"]) == 4
    for jw, pw in zip(jax_out["windows"], out["windows"]):
        assert pw["frames"] == jw["frames"]
        assert pw["embeddings"].shape == (4, 16, 24, 4)
        for key in ("embeddings", "bandwidths", "seediness"):
            np.testing.assert_allclose(pw[key].numpy(), np.asarray(jw[key]),
                                       atol=ATOL, rtol=1e-4, err_msg=key)
    jfg = np.asarray(jax_out["fg_masks"])
    assert out["fg_masks"].shape == jfg.shape == (T, 16, 24)
    assert 0.1 < jfg.mean() < 0.9
    assert (out["fg_masks"].numpy() == jfg).mean() >= MIN_AGREEMENT


def test_clustering_chainer_writer_on_jax_engine_outputs(slice_setup):
    """Identical inputs (the JAX engine's outputs) give identical tracks and
    identical PNGs."""
    jtg, tg, _, jax_out, out_dir = slice_setup
    j_labels, j_counts, j_lifetimes, _ = jtg.do_clustering(jax_out)

    windows = [{"frames": w["frames"],
                **{k: torch.from_numpy(np.array(w[k]))
                   for k in ("embeddings", "bandwidths", "seediness")}}
               for w in jax_out["windows"]]
    fg = torch.from_numpy(np.array(jax_out["fg_masks"]))
    labels, counts, lifetimes, metas = tg.chainer.process(fg, windows)

    np.testing.assert_array_equal(labels, j_labels)
    assert counts == j_counts and lifetimes == j_lifetimes
    assert len(counts) > 3  # several tracks besides the outliers

    seq = Sequence()
    jax_kept, _ = jtg.output_generator.process_sequence(
        seq, j_labels, j_counts, j_lifetimes, None, mask_scale=4, max_tracks=20,
        min_dim=64, max_dim=96)
    kept = tg.output_generator.process_sequence(
        seq, labels, counts, lifetimes, None, mask_scale=4, max_tracks=20,
        min_dim=64, max_dim=96)
    assert kept == jax_kept
    for t in range(T):
        name = os.path.join("results", "seqA", f"{t:05d}.png")
        ref = Image.open(out_dir / "jax" / name)
        ours = Image.open(out_dir / "port" / name)
        assert ours.mode == ref.mode == "P"
        assert ours.getpalette() == ref.getpalette()
        np.testing.assert_array_equal(np.array(ours), np.array(ref))
        assert np.array(ours).shape == (H, W)


def test_cli_end_to_end_on_cpu(slice_setup, tmp_path, monkeypatch):
    """``stemseg_tpu_torch.inference.main`` on a synthetic DAVIS dataset:
    JPEG frames, a ``config.yaml`` beside a ``.pth`` state dict, DAVIS
    JSON from the environment; PNGs out, labels as the TrackGenerator's."""
    import json

    import cv2
    import yaml

    from stemseg_tpu_torch.config import to_dict
    from stemseg_tpu_torch.inference import main as cli
    from stemseg_tpu_torch.utils.timer import Timer

    _, tg, frames, _, setup_dir = slice_setup
    port_dir = setup_dir / "port"
    base = tmp_path / "davis"
    (base / "seqA").mkdir(parents=True)
    paths = []
    for t, frame in enumerate(frames):
        paths.append(f"seqA/{t:05d}.png")  # lossless, so the pixels match
        cv2.imwrite(str(base / paths[-1]), frame)
    ann = tmp_path / "ann"
    ann.mkdir()
    (ann / "davis_val.json").write_text(json.dumps({
        "meta": {"category_labels": {"1": "object"}},
        "sequences": [{"id": "seqA", "height": H, "width": W, "image_paths": paths}]}))
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "config.yaml").write_text(yaml.safe_dump(to_dict(tg.cfg)))
    torch.save(tg.engine.model.state_dict(), model_dir / "weights.pth")
    monkeypatch.setenv("DAVIS_BASE_DIR", str(base))
    monkeypatch.setenv("STEMSEG_JSON_ANNOTATIONS_DIR", str(ann))

    Timer.reset()
    out_dir = tmp_path / "out"
    cli.main([str(model_dir / "weights.pth"), "-o", str(out_dir), "--dataset", "davis",
              "-fo", str(OVERLAP), "-st", str(SEEDINESS_THRESH), "--device", "cpu"])
    files = sorted(os.listdir(out_dir / "results" / "seqA"))
    assert files == [f"{t:05d}.png" for t in range(T)]
    assert Timer.get_duration("inference") > 0 and Timer.get_duration("postprocessing") > 0

    # the same sequence through the TrackGenerator in memory writes the
    # same PNGs
    tg._process_loaded(Sequence(), frames, (H, W), 20)
    for t in range(T):
        name = os.path.join("results", "seqA", f"{t:05d}.png")
        np.testing.assert_array_equal(np.array(Image.open(out_dir / name)),
                                      np.array(Image.open(port_dir / name)))


def test_track_generator_matches_jax(slice_setup):
    jtg, tg, frames, _, _ = slice_setup
    seq = Sequence()
    jtg._process_loaded(seq, frames, (H, W), 20)
    j_labels, _, _, _ = jtg.do_clustering(jtg.do_inference(frames, (H, W)))
    done_before = tg.total_frames_processed
    labels, counts, _, metas = tg._process_loaded(seq, frames, (H, W), 20)
    assert labels.shape == j_labels.shape == (T, 16, 24)
    assert (labels == j_labels).mean() >= MIN_AGREEMENT
    assert [int(m.valid.sum()) for m in metas] == [5, 5, 3, 3]
    assert tg.total_frames_processed == done_before + T
    assert all("fps" in line for line in tg.fps_report())
