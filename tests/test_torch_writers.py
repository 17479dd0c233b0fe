"""The port's YT-VIS and KITTI-MOTS slice against the JAX package on the
CPU (small R-50 models with a semseg head and fused seediness, 10 frames of
32x48 resized to 64x96, 4-frame windows with overlap 2):

1. the RLE codec against ``stemseg_tpu.utils.rle``, byte for byte;
2. both writers fed the same labels, counts, lifetimes and category masks
   (the JAX ``TrackGenerator``'s): ``results.json``, ``results/0002.txt``
   and ``results_nms/0002.txt`` identical to the JAX writers' (the final 2x
   downscale of this geometry is exact in float32);
3. the NMS filters on a hand-made txt whose detections fall on both sides
   of every threshold;
4. ``TrackGenerator`` for ytvis (with and without ``--resize_embeddings``)
   and kittimots against ``TrackGenerator(use_fused=False)``: labels agree
   on at least 99.9 % of the pixels;
5. the CLI end to end on the CPU for both datasets, on synthetic datasets
   found through the environment.
"""

import json
import os

import numpy as np
import pytest
import torch

from stemseg_tpu.config import load_config as jax_load_config
from stemseg_tpu.inference.main import TrackGenerator as JaxTrackGenerator
from stemseg_tpu.inference.output_utils import KittiMOTSOutputGenerator as JaxKittiWriter
from stemseg_tpu.inference.output_utils import YoutubeVISOutputGenerator as JaxYTWriter
from stemseg_tpu.inference.output_utils import kitti_mots_postprocessing as jax_nms
from stemseg_tpu.models import build_model as jax_build_model
from stemseg_tpu.utils import rle as jax_rle
from stemseg_tpu_torch.config import load_config
from stemseg_tpu_torch.inference.main import TrackGenerator
from stemseg_tpu_torch.inference.output_utils import (
    KittiMOTSOutputGenerator,
    YoutubeVISOutputGenerator,
)
from stemseg_tpu_torch.inference.output_utils import kitti_mots_postprocessing as nms
from stemseg_tpu_torch.models import build_model, state_dict_from_jax
from stemseg_tpu_torch.utils import rle
from test_torch_inference import synthetic_frames
from test_torch_model import random_variables
from test_torch_semseg import centre_fg, small_cfg

torch.set_num_threads(2)

MIN_AGREEMENT = 0.999
T, H, W = 10, 32, 48
OVERLAP = 2
MAX_TRACKS = 8


class Sequence:
    def __init__(self, seq_id):
        self.id = seq_id
        self.image_dims = (H, W)

    def __len__(self):
        return T


def _masks():
    rng = np.random.RandomState(3)
    one_px = np.zeros((37, 53), np.uint8)
    one_px[20, 31] = 1
    long_runs = np.zeros((720, 1280), np.uint8)
    long_runs[100:700, 50:1200] = 1  # runs of 600 and 120 px: varint continuation
    long_runs[:, 1250:] = 1  # a run across whole columns
    return {"zeros": np.zeros((20, 30), np.uint8), "ones": np.ones((20, 30), np.uint8),
            "one_pixel": one_px, "long_runs": long_runs,
            "random": (rng.rand(41, 67) > 0.5).astype(np.uint8),
            "blobs": (rng.rand(8, 12) > 0.7).repeat(6, 0).repeat(5, 1).astype(np.uint8)}


@pytest.mark.parametrize("name", sorted(_masks()))
def test_rle_matches_jax_codec(name):
    mask = _masks()[name]
    ours, ref = rle.encode(mask), jax_rle.encode(mask)
    assert ours == ref and isinstance(ours["counts"], bytes)
    counts = rle.string_to_counts(ours["counts"])
    assert counts == jax_rle.string_to_counts(ref["counts"])
    assert rle.counts_to_string(counts) == ours["counts"]
    for r in (ours, {"size": ours["size"], "counts": ours["counts"].decode()}):
        np.testing.assert_array_equal(rle.decode(r), mask)
        np.testing.assert_array_equal(rle.decode(r), jax_rle.decode(ref))
        assert rle.area(r) == jax_rle.area(ref) == int(mask.sum())
        np.testing.assert_array_equal(rle.toBbox(r), jax_rle.toBbox(ref))
    assert rle.encode(np.stack([mask, 1 - mask], -1)) == jax_rle.encode(np.stack([mask, 1 - mask], -1))


CASES = {"ytvis": ("ytvis", 4, False), "ytvis_resize": ("ytvis", 4, True),
         "kittimots": ("kitti", 3, False)}


@pytest.fixture(scope="module")
def slices(tmp_path_factory):
    """Per case: (JAX TrackGenerator, port TrackGenerator, JAX outputs of
    inference and clustering, output root)."""
    frames = synthetic_frames()
    out = {}
    for case, (mode, n_cls, resize) in CASES.items():
        over = small_cfg(mode, n_cls)
        jcfg, cfg = jax_load_config(over), load_config(over)
        variables = random_variables(jax_build_model(jcfg, for_training=False),
                                     (1, 4, 64, 96, 3), 4)
        if mode == "kitti":  # a narrow time bandwidth, so tracks span frames
            variables["params"]["embedding_head"]["conv_variance"]["conv"]["bias"][-1] = -4.0
        variables = centre_fg(over, variables)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state_dict_from_jax(variables))
        root = tmp_path_factory.mktemp(case)
        dataset = "kittimots" if mode == "kitti" else "ytvis"
        writers = ((JaxKittiWriter(str(root / "jax"), upscaled_inputs=resize),
                    KittiMOTSOutputGenerator(str(root / "port"), upscaled_inputs=resize,
                                             device="cpu"))
                   if mode == "kitti" else
                   (JaxYTWriter(str(root / "jax"), upscaled_inputs=resize),
                    YoutubeVISOutputGenerator(str(root / "port"), upscaled_inputs=resize,
                                              device="cpu")))
        jtg = JaxTrackGenerator(jcfg, dataset, variables, writers[0], MAX_TRACKS,
                                frame_overlap=OVERLAP, resize_embeddings=resize,
                                use_fused=False)
        tg = TrackGenerator(cfg, dataset, model, writers[1], MAX_TRACKS,
                            frame_overlap=OVERLAP, resize_embeddings=resize, use_fused=False)
        jax_out = jtg.do_inference(frames, (H, W))
        out[case] = (jtg, tg, jax_out, jtg.do_clustering(jax_out), root)
    return frames, out


@pytest.mark.parametrize("case", sorted(CASES))
def test_writers_match_jax_on_identical_inputs(slices, case):
    _, setups = slices
    jtg, tg, jax_out, (labels, counts, lifetimes, _), root = setups[case]
    assert len(counts) > 3  # several tracks besides the outliers
    category_masks = np.asarray(jax_out["multiclass_masks"])
    inputs = [("0002", category_masks)]
    if case != "kittimots":  # also random logits, so that the class vote varies
        rng = np.random.RandomState(8)
        inputs.append(("0003", (rng.randn(*category_masks.shape) * 3).astype(np.float32)))
    for gen in (jtg.output_generator, tg.output_generator):
        for seq_id, masks in inputs:
            gen.process_sequence(Sequence(seq_id), labels, counts, lifetimes, masks,
                                 mask_scale=4, max_tracks=MAX_TRACKS, min_dim=64, max_dim=96)
        gen.save()
    if case == "kittimots":
        names = [os.path.join("results", "0002.txt"), os.path.join("results_nms", "0002.txt")]
        lines = (root / "port" / names[0]).read_text().splitlines()
        assert len(lines) >= MAX_TRACKS  # one line per kept track and frame
        assert {int(line.split()[2]) for line in lines} <= {1, 2}
    else:
        names = ["results.json"]
        results = json.loads((root / "port" / "results.json").read_text())
        assert len(results) == 2 * min(MAX_TRACKS, len(counts) - 1)
        assert all(len(r["segmentations"]) == T for r in results)
        assert len({r["category_id"] for r in results}) > 1
        assert {r["category_id"] for r in results} <= {1, 2, 3}
    for name in names:
        assert (root / "port" / name).read_bytes() == (root / "jax" / name).read_bytes(), name


def test_kitti_writer_refuses_a_sequence_without_instances(tmp_path):
    labels = np.full((2, 16, 24), -1, np.int32)
    with pytest.raises(ValueError, match="Zero instances"):
        KittiMOTSOutputGenerator(str(tmp_path), device="cpu").process_sequence(
            Sequence("0002"), labels, {-1: 768}, {-1: 1}, np.zeros((2, 16, 24), np.int64),
            mask_scale=4, max_tracks=5, min_dim=64, max_dim=96)


def _box_mask(h, w, y0, x0, bh, bw, fill_rows=None):
    """A ``bh x bw`` box at (y0, x0), its first ``fill_rows`` rows set."""
    m = np.zeros((h, w), np.uint8)
    m[y0:y0 + (bh if fill_rows is None else fill_rows), x0:x0 + bw] = 1
    return m


def test_nms_matches_jax_on_both_sides_of_every_threshold(tmp_path):
    """Per class: detections just below / at the area limit, just below /
    above the box-fill ratio, tracks just inside / beyond the time-break
    ratio and just short of / at the minimum length."""
    h, w = 120, 120
    lines = []

    def add(frame, track, cls, mask):
        counts = rle.encode(mask)["counts"].decode()
        lines.append(f"{frame} {cls * 1000 + track} {cls} {h} {w} {counts}")

    for cls, area, ratio, min_len, max_break in ((1, 150, 0.35, 3, 0.3),
                                                 (2, 250, 0.2, 10, 0.5)):
        side = int(np.ceil(np.sqrt(area)))
        full = _box_mask(h, w, 2, 2, side, side)
        # area: one pixel short of the limit (dropped), exactly at it (kept)
        small = full.copy()
        small.flat[np.flatnonzero(small)[area - 1:]] = 0
        at = full.copy()
        at.flat[np.flatnonzero(at)[area:]] = 0
        # box fill ratio: a sparse comb below the limit, a dense box above
        sparse = np.zeros((h, w), np.uint8)
        k = int(1 / ratio) + 2
        sparse[2:2 + side * k:k, 2:2 + side] = 1
        for t in range(min_len):
            add(t, 1, cls, small)  # dropped by area, so the track vanishes
            add(t, 2, cls, at)     # kept
        for t in range(min_len + 1):
            add(t, 3, cls, sparse if t == 0 else full)  # frame 0 dropped by ratio
        # time breaks: a track of n detections with b breaks, just inside
        # and just beyond max_break
        n = 2 * min_len
        b_in = int(np.floor(max_break * n))
        for track, breaks in ((4, b_in), (5, b_in + 1)):
            frames = list(range(n))
            for j in range(breaks):
                frames[n - 1 - j:] = [f + 1 for f in frames[n - 1 - j:]]
            for f in frames:
                add(f, track, cls, full)
        # length: one short of the minimum, exactly at it
        for track, length in ((6, min_len - 1), (7, min_len)):
            for t in range(length):
                add(t, track, cls, full)

    for d in ("ours", "ref"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "0007.txt").write_text("\n".join(lines) + "\n")
    out = nms.postprocess_results(str(tmp_path / "ours"))
    jax_nms.postprocess_results(results_dir=str(tmp_path / "ref"))
    ours = (tmp_path / "ours_nms" / "0007.txt").read_text()
    assert out == str(tmp_path / "ours_nms")
    assert ours == (tmp_path / "ref_nms" / "0007.txt").read_text()
    kept = {(int(x.split()[1]) % 1000, int(x.split()[2])) for x in ours.splitlines()}
    frames_of_3 = [int(x.split()[0]) for x in ours.splitlines() if int(x.split()[1]) == 1003]
    for cls in (1, 2):
        assert (1, cls) not in kept and (2, cls) in kept
        assert (4, cls) in kept and (5, cls) not in kept
        assert (6, cls) not in kept and (7, cls) in kept
    assert 0 not in frames_of_3 and frames_of_3


def test_nms_cli(tmp_path):
    mask = rle.encode(_box_mask(30, 40, 1, 1, 20, 20))["counts"].decode()
    (tmp_path / "res").mkdir()
    (tmp_path / "res" / "0001.txt").write_text(
        "".join(f"{t} 1001 1 30 40 {mask}\n" for t in range(3)))
    nms.main([str(tmp_path / "res"), "--min_track_length_car", "4"])
    assert (tmp_path / "res_nms" / "0001.txt").read_text() == ""
    nms.main([str(tmp_path / "res")])
    assert len((tmp_path / "res_nms" / "0001.txt").read_text().splitlines()) == 3


@pytest.mark.parametrize("case", sorted(CASES))
def test_track_generator_matches_jax(slices, case):
    frames, setups = slices
    _, tg, _, (j_labels, _, _, _), _ = setups[case]
    out = tg.do_inference(frames, (H, W))
    labels, counts, _, metas = tg.do_clustering(out)
    scale = 4 if case == "ytvis_resize" else 1
    assert labels.shape == j_labels.shape == (T, 16 * scale, 24 * scale)
    assert (labels == j_labels).mean() >= MIN_AGREEMENT
    assert all(int(m.valid.sum()) for m in metas) and len(counts) > 3
    assert out["multiclass_masks"].shape[:3] == labels.shape


def _write_dataset(root, base, seq_id, frames, ann_name, categories):
    import cv2

    (base / seq_id).mkdir(parents=True)
    paths = []
    for t, frame in enumerate(frames):
        paths.append(f"{seq_id}/{t:06d}.png")  # lossless, so the pixels match
        cv2.imwrite(str(base / paths[-1]), frame)
    ann = root / "ann"
    ann.mkdir()
    (ann / ann_name).write_text(json.dumps({
        "meta": {"category_labels": categories},
        "sequences": [{"id": seq_id, "height": H, "width": W, "image_paths": paths}]}))
    return ann


@pytest.mark.parametrize("case", ["ytvis", "kittimots"])
def test_cli_end_to_end_on_cpu(slices, case, tmp_path, monkeypatch):
    """``stemseg_tpu_torch.inference.main --dataset ytvis|kittimots`` on a
    synthetic dataset (PNG frames, dataset JSON and image root from the
    environment, ``config.yaml`` beside a ``.pth``): the same files as the
    TrackGenerator and writer in memory (the CLI on its default fused path,
    the TrackGenerator on the streaming path)."""
    import yaml

    from stemseg_tpu_torch.config import to_dict
    from stemseg_tpu_torch.inference import main as cli

    frames, setups = slices
    tg = setups[case][1]
    if case == "ytvis":
        base = tmp_path / "ytvis" / "valid"
        ann = _write_dataset(tmp_path, base, "0002", frames, "youtube_vis_val.json",
                             {str(i): f"cat{i}" for i in range(1, 4)})
        monkeypatch.setenv("YOUTUBE_VIS_BASE_DIR", str(tmp_path / "ytvis"))
        names = ["results.json"]
        mem = YoutubeVISOutputGenerator(str(tmp_path / "mem"), device="cpu")
    else:
        base = tmp_path / "kitti"
        ann = _write_dataset(tmp_path, base, "0002", frames, "kittimots_val.json",
                             {"1": "car", "2": "pedestrian"})
        monkeypatch.setenv("KITTIMOTS_BASE_DIR", str(base))
        names = [os.path.join("results", "0002.txt"), os.path.join("results_nms", "0002.txt")]
        mem = KittiMOTSOutputGenerator(str(tmp_path / "mem"), device="cpu")
    monkeypatch.setenv("STEMSEG_JSON_ANNOTATIONS_DIR", str(ann))
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    (model_dir / "config.yaml").write_text(yaml.safe_dump(to_dict(tg.cfg)))
    torch.save(tg.engine.model.state_dict(), model_dir / "weights.pth")

    cli.main([str(model_dir / "weights.pth"), "-o", str(tmp_path / "out"), "--dataset", case,
              "-fo", str(OVERLAP), "--max_tracks", str(MAX_TRACKS), "--device", "cpu"])

    writer, tg.output_generator = tg.output_generator, mem
    try:
        tg._process_loaded(Sequence("0002"), frames, (H, W), MAX_TRACKS)
    finally:
        tg.output_generator = writer
    mem.save()
    assert (tmp_path / "out" / names[0]).read_bytes()
    for name in names:  # the NMS drops every track of this small geometry
        got = (tmp_path / "out" / name).read_bytes()
        assert got == (tmp_path / "mem" / name).read_bytes(), name


def test_full_scale_clustering_needs_a_semseg_head(tmp_path):
    """``--resize_embeddings`` takes the fg masks from the semseg head: the
    port refuses a config without one when it is built, where the JAX
    package fails in the clustering (fg masks at a quarter of the upscaled
    embeddings' size)."""
    import copy

    from stemseg_tpu.inference.output_utils import DavisOutputGenerator as JaxDavisWriter
    from stemseg_tpu_torch.inference.output_utils import DavisOutputGenerator
    from test_torch_model import SMALL

    over = copy.deepcopy(SMALL)
    over["input"].update(min_dim=64, max_dim=96)
    jcfg, cfg = jax_load_config(over), load_config(over)
    variables = random_variables(jax_build_model(jcfg, for_training=False), (1, 4, 64, 96, 3), 1)
    with pytest.raises(ValueError, match="semseg head"):
        TrackGenerator(cfg, "davis", build_model(cfg, device="cpu"),
                       DavisOutputGenerator(str(tmp_path), device="cpu"), 20,
                       frame_overlap=OVERLAP, resize_embeddings=True)
    jtg = JaxTrackGenerator(jcfg, "davis", variables, JaxDavisWriter(str(tmp_path)), 20,
                            frame_overlap=OVERLAP, resize_embeddings=True, use_fused=False)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jtg.do_clustering(jtg.do_inference(synthetic_frames(), (H, W)))
