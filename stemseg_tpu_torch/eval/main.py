"""Scoring CLI: an inference CLI's output against the ground-truth JSONs.

    python -m stemseg_tpu_torch.eval.main --dataset davis --results OUT/results
    python -m stemseg_tpu_torch.eval.main --dataset ytvis --results OUT/results.json
    python -m stemseg_tpu_torch.eval.main --dataset kittimots --results OUT/results

The ground truth is the generic video JSON and dataset root that the
inference CLI reads (``stemseg_tpu_torch/data/paths.py``): ``davis_val.json``
under ``DAVIS_BASE_DIR``, ``youtube_vis_val.json`` under
``YOUTUBE_VIS_BASE_DIR``'s ``valid/``, ``kittimots_val.json`` under
``KITTIMOTS_BASE_DIR``, all in ``STEMSEG_JSON_ANNOTATIONS_DIR``. Scoring
runs on the host. Prints one JSON line of metrics, floats rounded to 4
places.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _gt_object_volumes(seq):
    """One ``[T, H, W]`` uint8 volume per instance of a
    ``GenericVideoSequence``."""
    per_frame = seq.load_masks()  # [T][num_instances]
    return [np.stack([per_frame[t][k] for t in range(len(seq))])
            for k in range(len(seq.instance_ids))]


def eval_davis(results_dir: str, seqs=None) -> dict:
    """J&F of ``results_dir/<seq>/*.png`` against ``davis_val.json``; a
    sequence without a results folder has no proposals."""
    from stemseg_tpu_torch.data.parsers import parse_generic_video_dataset
    from stemseg_tpu_torch.data.paths import DavisUnsupervisedPaths
    from stemseg_tpu_torch.eval.davis import evaluate_davis, load_davis_results_dir

    sequences, _ = parse_generic_video_dataset(
        DavisUnsupervisedPaths.trainval_base_dir(), DavisUnsupervisedPaths.val_vds_file())
    gt, pred = {}, {}
    for seq in sequences:
        if seqs and seq.id not in seqs:
            continue
        seq_dir = os.path.join(results_dir, seq.id)
        gt[seq.id] = _gt_object_volumes(seq)
        pred[seq.id] = load_davis_results_dir(seq_dir) if os.path.isdir(seq_dir) else []
    return evaluate_davis(gt, pred)


def eval_ytvis(results_json: str, seqs=None) -> dict:
    """AP of ``results.json`` against ``youtube_vis_val.json``; ``seqs``
    compare as strings (video ids are ints in the JSON)."""
    from stemseg_tpu_torch.data.parsers import parse_generic_video_dataset
    from stemseg_tpu_torch.data.paths import YoutubeVISPaths
    from stemseg_tpu_torch.eval.ytvis import evaluate_ytvis, load_ytvis_results_json

    sequences, _ = parse_generic_video_dataset(
        YoutubeVISPaths.val_base_dir(), YoutubeVISPaths.val_vds_file())
    seqs = {str(s) for s in seqs} if seqs else None
    gt_tracks = []
    for seq in sequences:
        if seqs and str(seq.id) not in seqs:
            continue
        vols = _gt_object_volumes(seq)
        for k, iid in enumerate(seq.instance_ids):
            gt_tracks.append({"video": seq.id, "category": seq.instance_categories[iid],
                              "masks": list(vols[k])})
    preds = load_ytvis_results_json(results_json)
    if seqs:
        preds = [p for p in preds if str(p["video"]) in seqs]
    return evaluate_ytvis(gt_tracks, preds)


def eval_kittimots(results_dir: str, seqs=None) -> dict:
    """CLEAR-MOTS of ``results_dir/<seq>.txt`` against
    ``kittimots_val.json``, per class as ``mots_tools`` scores it: cars (1)
    and pedestrians (2) apart, a hypothesis (class from the txt's class
    column) matching only ground truth of its class; ground truth of
    category 3 is the ignore region of both classes. Returns sMOTSA, MOTSA
    and MOTSP per class (``_car``, ``_pedestrian``) and pooled over both,
    and the pooled counts."""
    from stemseg_tpu_torch.data.parsers import parse_generic_video_dataset
    from stemseg_tpu_torch.data.paths import KITTIMOTSPaths
    from stemseg_tpu_torch.eval.mots import evaluate_mots, parse_mots_txt

    sequences, _ = parse_generic_video_dataset(
        KITTIMOTSPaths.train_images_dir(), KITTIMOTSPaths.val_vds_file())

    class_names = {1: "car", 2: "pedestrian"}
    keys = ("TP", "FP", "FN", "IDS", "soft_TP", "num_gt")
    totals = {cls: {k: 0.0 for k in keys} for cls in class_names}
    for seq in sequences:
        if seqs and seq.id not in seqs:
            continue
        txt = os.path.join(results_dir, f"{seq.id}.txt")
        hyp, hyp_class = parse_mots_txt(txt) if os.path.exists(txt) else ([], {})
        t_total = len(seq)
        hyp += [{} for _ in range(t_total - len(hyp))]

        per_frame = seq.load_masks()
        gt_frames, ignore_frames = [], []
        for t in range(t_total):
            gt_t, ignore_t = {}, None
            for k, iid in enumerate(seq.instance_ids):
                if seq.instance_categories[iid] == 3:  # ignore region
                    m = per_frame[t][k].astype(bool)
                    ignore_t = m if ignore_t is None else (ignore_t | m)
                elif per_frame[t][k].any():
                    gt_t[iid] = per_frame[t][k]
            gt_frames.append(gt_t)
            ignore_frames.append(ignore_t)

        for cls in class_names:
            gt_cls = [{iid: m for iid, m in gt_t.items()
                       if seq.instance_categories[iid] == cls} for gt_t in gt_frames]
            hyp_cls = [{tid: m for tid, m in hyp_t.items() if hyp_class.get(tid) == cls}
                       for hyp_t in hyp[:t_total]]
            res = evaluate_mots(gt_cls, hyp_cls, ignore_frames)
            for k in keys:
                totals[cls][k] += res[k]

    def _derive(t):
        num_gt, tp = t["num_gt"], t["TP"]
        return {
            "sMOTSA": (t["soft_TP"] - t["FP"] - t["IDS"]) / num_gt if num_gt else 0.0,
            "MOTSA": (tp - t["FP"] - t["IDS"]) / num_gt if num_gt else 0.0,
            "MOTSP": t["soft_TP"] / tp if tp else 0.0,
        }

    out = {}
    pooled = {k: sum(totals[c][k] for c in class_names) for k in keys}
    for cls, name in class_names.items():
        for k, v in _derive(totals[cls]).items():
            out[f"{k}_{name}"] = v
    out.update(_derive(pooled))
    out.update({k: (pooled[k] if k == "soft_TP" else int(pooled[k])) for k in keys})
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="STEm-Seg evaluation (PyTorch port)")
    parser.add_argument("--dataset", "-d", required=True,
                        choices=("davis", "ytvis", "kittimots"))
    parser.add_argument("--results", "-r", required=True,
                        help="davis: the results dir of per-sequence PNG dirs; "
                             "ytvis: results.json; kittimots: the dir of "
                             "per-sequence txt files")
    parser.add_argument("--seqs", nargs="*", required=False)
    args = parser.parse_args(argv)

    scorer = {"davis": eval_davis, "ytvis": eval_ytvis, "kittimots": eval_kittimots}
    metrics = scorer[args.dataset](args.results, args.seqs)
    print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                      for k, v in metrics.items()}))
    return metrics


if __name__ == "__main__":
    main()
