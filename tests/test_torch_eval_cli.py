"""The port's scoring CLI (``stemseg_tpu_torch.eval.main``) and runbook
(``stemseg_tpu_torch.tools.eval_all``) against the JAX package, on the CPU:

* both scoring CLIs on the same ground-truth JSONs and results (DAVIS PNGs,
  YT-VIS ``results.json``, KITTI-MOTS txt with ignore regions and class
  separation), with and without ``--seqs``: the printed JSON lines are
  equal;
* the runbook with ``--device cpu`` at the CLI tests' small size (R-50,
  4-frame windows, 10 frames of 32x48): the port's inference CLI writes
  each dataset's results, and the runbook's metrics are equal to what
  ``stemseg_tpu.eval.main`` gives on those files; ``RESULTS.md`` is
  written; a dataset without its environment is refused.
"""

import contextlib
import copy
import io
import json
import os

import numpy as np
import pytest
import torch
import yaml

from stemseg_tpu.config import load_config as jax_load_config
from stemseg_tpu.eval.main import main as jax_eval_main
from stemseg_tpu.models import build_model as jax_build_model
from stemseg_tpu_torch.config import load_config, to_dict
from stemseg_tpu_torch.eval.main import main as eval_main
from stemseg_tpu_torch.inference.output_utils import (
    DavisOutputGenerator,
    KittiMOTSOutputGenerator,
    YoutubeVISOutputGenerator,
)
from stemseg_tpu_torch.models import state_dict_from_jax
from stemseg_tpu_torch.tools import eval_all
from stemseg_tpu_torch.utils import rle
from test_torch_cli_rest import OVER
from test_torch_eval import _labels, _Seq, blobs
from test_torch_inference import H, T, W, synthetic_frames
from test_torch_model import random_variables
from test_torch_semseg import centre_fg, small_cfg

torch.set_num_threads(2)

# dataset -> (annotation JSON, root variable, root subfolder, frame extension)
LAYOUT = {"davis": ("davis_val.json", "DAVIS_BASE_DIR", "", "jpg"),
          "ytvis": ("youtube_vis_val.json", "YOUTUBE_VIS_BASE_DIR", "valid", "jpg"),
          "kittimots": ("kittimots_val.json", "KITTIMOTS_BASE_DIR", "", "png")}
SEQ_IDS = {"davis": ["s0", "s1"], "ytvis": [1, 2], "kittimots": ["0001", "0002"]}


def gt_instances(dataset, rng, t, h, w):
    """{instance id: (category, [t, h, w] uint8)}: DAVIS objects, YT-VIS
    tracks of categories 1-40, KITTI cars, pedestrians and an ignore
    region (category 3)."""
    vols = blobs(rng, t, h, w, 4)
    if dataset == "davis":
        return {i + 1: (1, v) for i, v in enumerate(vols[:3])}
    if dataset == "ytvis":
        return {i + 1: (int(rng.randint(1, 41)), v) for i, v in enumerate(vols[:3])}
    ignore = np.zeros((t, h, w), np.uint8)
    ignore[:, : h // 3, : w // 3] = 1
    return {1001: (1, vols[0]), 1002: (1, vols[1]), 2001: (2, vols[2]), 10000: (3, ignore)}


def write_val_set(root, dataset, frames=None, seed=0):
    """The dataset's validation JSON with RLE masks (and, with ``frames``,
    its frames in the dataset's layout); returns the environment and the
    ground truth {seq id: instances}."""
    import cv2

    json_name, root_var, sub, ext = LAYOUT[dataset]
    rng = np.random.RandomState(seed)
    base = root / dataset
    n, h, w = (len(frames), *frames.shape[1:3]) if frames is not None else (6, H, W)
    sequences, gt = [], {}
    for seq_id in SEQ_IDS[dataset]:
        inst = gt_instances(dataset, rng, n, h, w)
        gt[seq_id] = inst
        paths = [f"{seq_id}/{t:05d}.{ext}" for t in range(n)]
        if frames is not None:
            (base / sub / str(seq_id)).mkdir(parents=True)
            for p, frame in zip(paths, frames):
                cv2.imwrite(str(base / sub / p), frame)
        sequences.append({
            "id": seq_id, "height": h, "width": w, "image_paths": paths,
            "categories": {str(i): c for i, (c, _) in inst.items()},
            "segmentations": [{str(i): rle.encode(v[t])["counts"].decode()
                               for i, (_, v) in inst.items() if v[t].any()}
                              for t in range(n)]})
    ann = root / "ann"
    ann.mkdir(exist_ok=True)
    cats = {str(c) for s in sequences for c in s["categories"].values()}
    (ann / json_name).write_text(json.dumps(
        {"meta": {"category_labels": {c: c for c in sorted(cats)}}, "sequences": sequences}))
    return {root_var: str(base), "STEMSEG_JSON_ANNOTATIONS_DIR": str(ann)}, gt


def write_results(root, dataset, gt, seed=1):
    """Results in the dataset's format from the port's writers on random
    labels (one DAVIS sequence left without results), plus for YT-VIS a
    noisy copy of every other ground-truth track and for KITTI-MOTS a copy
    of most ground-truth objects, a car over a pedestrian and a hypothesis
    inside the ignore region. Returns the ``--results`` path."""
    rng = np.random.RandomState(seed)
    out = root / "results_out"
    gen = {"davis": DavisOutputGenerator, "ytvis": YoutubeVISOutputGenerator,
           "kittimots": KittiMOTSOutputGenerator}[dataset](str(out), device="cpu")
    for k, (seq_id, inst) in enumerate(gt.items()):
        if dataset == "davis" and k == 1:
            continue
        t = next(iter(inst.values()))[1].shape[0]
        labels, counts, lifetimes = _labels(rng, t, H // 4 * 2, W // 4 * 2, 4)
        masks = {"davis": None, "ytvis": rng.randn(t, H // 2, W // 2, 41).astype(np.float32),
                 "kittimots": rng.randint(0, 3, labels.shape)}[dataset]
        gen.process_sequence(_Seq(seq_id, (H, W)), labels, counts, lifetimes, masks,
                             mask_scale=2, max_tracks=4, min_dim=H, max_dim=W)
    if dataset == "ytvis":
        gen.save()
        entries = json.loads((out / "results.json").read_text())
        for seq_id, inst in gt.items():
            for cat, vol in list(inst.values())[::2]:
                noisy = (vol & (rng.rand(*vol.shape) > 0.25)).astype(np.uint8)
                entries.append({"video_id": seq_id, "category_id": cat,
                                "score": float(rng.rand()),
                                "segmentations": [dict(size=[H, W], counts=rle.encode(
                                    m)["counts"].decode()) for m in noisy]})
        (out / "results.json").write_text(json.dumps(entries))
        return out / "results.json"
    if dataset == "kittimots":
        for seq_id, inst in gt.items():
            lines = []
            for t in range(next(iter(inst.values()))[1].shape[0]):
                for iid, (cat, vol) in inst.items():
                    if cat == 3 or not vol[t].any():
                        continue
                    if (t + iid) % 4 != 3:  # the rest are misses
                        lines.append(f"{t} {cat * 1000 + 500 + iid % 1000} {cat} {H} {W} "
                                     f"{rle.encode(vol[t])['counts'].decode()}")
                    if cat == 2:  # a car on top of the pedestrian
                        lines.append(f"{t} 1900 1 {H} {W} "
                                     f"{rle.encode(vol[t])['counts'].decode()}")
                inside = np.zeros((H, W), np.uint8)
                inside[1:H // 3 - 1, 1:W // 3 - 1] = 1
                lines.append(f"{t} 1950 1 {H} {W} {rle.encode(inside)['counts'].decode()}")
            with open(out / "results" / f"{seq_id}.txt", "a") as fh:
                fh.write("\n".join(lines) + "\n")
    return out / "results"


def printed(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    lines = buf.getvalue().strip().splitlines()
    return lines[-1]


@pytest.mark.parametrize("dataset,seqs", [("davis", None), ("davis", ["s0"]),
                                          ("ytvis", None), ("ytvis", ["2"]),
                                          ("kittimots", None), ("kittimots", ["0002"])])
def test_eval_cli_prints_the_jax_line(dataset, seqs, tmp_path, monkeypatch):
    env, gt = write_val_set(tmp_path, dataset)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = ["--dataset", dataset, "--results", str(write_results(tmp_path, dataset, gt))]
    if seqs:
        argv += ["--seqs", *seqs]
    ours = printed(eval_main, argv)
    assert ours == printed(jax_eval_main, argv)
    metrics = json.loads(ours)
    if dataset == "kittimots":
        assert metrics["TP"] > 0 and metrics["FP"] > 0 and metrics["FN"] > 0
        assert metrics["sMOTSA_car"] != metrics["sMOTSA_pedestrian"]
    else:
        assert 0.0 < metrics["J_mean" if dataset == "davis" else "AR10"] < 1.0


def test_eval_cli_scores_ground_truth_as_perfect(tmp_path, monkeypatch):
    env, gt = write_val_set(tmp_path, "ytvis")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    entries = [{"video_id": seq_id, "category_id": cat, "score": 0.9,
                "segmentations": [dict(rle.encode(m), counts=rle.encode(m)["counts"].decode())
                                  for m in vol]}
               for seq_id, inst in gt.items() for cat, vol in inst.values()]
    (tmp_path / "results.json").write_text(json.dumps(entries))
    metrics = eval_main(["--dataset", "ytvis", "--results", str(tmp_path / "results.json")])
    assert {metrics[k] for k in ("AP", "AP50", "AP75", "AR10")} == {1.0}


MODELS = {"davis": OVER, "ytvis": small_cfg("ytvis", 40), "kittimots": small_cfg("kitti", 3)}
MODEL_NAMES = {"davis": "davis.pth", "ytvis": "youtube_vis.pth", "kittimots": "kitti_mots.pth"}


@pytest.mark.parametrize("dataset", ["davis", "ytvis", "kittimots"])
def test_eval_all_on_cpu_scores_what_the_jax_scorer_scores(dataset, tmp_path, monkeypatch):
    over = copy.deepcopy(MODELS[dataset])
    over["input"].update(min_dim=64, max_dim=96)
    jmodel = jax_build_model(jax_load_config(over), for_training=False)
    variables = random_variables(jmodel, (1, 4, 64, 96, 3), 4)
    if dataset != "davis":
        variables = centre_fg(over, variables)
    models = tmp_path / "models"
    models.mkdir()
    (models / "config.yaml").write_text(yaml.safe_dump(to_dict(load_config(over))))
    torch.save(state_dict_from_jax(variables), models / MODEL_NAMES[dataset])
    env, _ = write_val_set(tmp_path, dataset, frames=synthetic_frames())
    for k, v in env.items():
        monkeypatch.setenv(k, v)

    out = tmp_path / "out"
    per_dataset = eval_all.main(["--models_dir", str(models), "--output_dir", str(out),
                                 "--datasets", dataset, "--frame_overlap", "2",
                                 "--device", "cpu"])
    res = per_dataset[dataset]
    results = out / dataset / ("results.json" if dataset == "ytvis" else "results")
    assert results.exists()
    want = jax_eval_main(["--dataset", dataset, "--results", str(results)])
    assert res["metrics"] == want
    assert res["inference_s"] > 0 and res["scoring_s"] > 0
    text = (out / "RESULTS.md").read_text()
    assert f"## {dataset}" in text and "inference on\n``cpu``" in text
    assert all(f"| {k} |" in text for k in want)
    if dataset == "ytvis":
        assert {e["video_id"] for e in json.loads(results.read_text())} == {1, 2}
    else:  # a folder of PNGs or a txt per sequence
        assert len(os.listdir(results)) == 2


def test_eval_all_refuses_a_dataset_without_its_environment(tmp_path, monkeypatch):
    for var in ("DAVIS_BASE_DIR", "STEMSEG_JSON_ANNOTATIONS_DIR"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit):
        eval_all.main(["--models_dir", str(tmp_path), "--output_dir", str(tmp_path / "o"),
                       "--datasets", "davis", "--device", "cpu"])
    assert not (tmp_path / "o").exists()
