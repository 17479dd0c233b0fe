"""YouTube-VIS average precision, the benchmark's COCO-style protocol
(``ytvoseval.py``, a track-level pycocotools ``COCOeval``), in float64
numpy on the host.

* **Spatio-temporal mask IoU** of two tracks: the sum of the per-frame
  intersections over the sum of the per-frame unions (a missing frame is
  an empty mask).
* Per category, video and IoU threshold the predictions, by decreasing
  score, take the not yet matched ground-truth track of highest IoU at or
  above the threshold (COCO matching with its ignore rules; on an exact
  IoU tie the later ground truth wins, as in pycocotools).
* **AP**: the 101-point interpolated area under the precision-recall
  curve, averaged over the IoU thresholds 0.50:0.05:0.95, then over the
  categories that have ground truth. AP50 and AP75 at one threshold;
  AP_S / M / L over COCO's area buckets (< 32², 32²-96², > 96²) of a
  track's mean area over its non-empty frames; AR@1 and AR@10 the recall
  with at most the 1 or 10 best-scored predictions a video.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.arange(0.5, 0.96, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {  # on the track's mean per-frame area
    "all": (0.0, float("inf")),
    "S": (0.0, 32.0 ** 2),
    "M": (32.0 ** 2, 96.0 ** 2),
    "L": (96.0 ** 2, float("inf")),
}


def st_mask_iou(a: Sequence[Optional[np.ndarray]], b: Sequence[Optional[np.ndarray]]) -> float:
    """Spatio-temporal IoU of two tracks given as per-frame masks (None for
    a frame where the track is absent)."""
    inter = union = 0.0
    for ma, mb in zip(a, b):
        if ma is None and mb is None:
            continue
        if ma is None:
            union += float(np.asarray(mb, bool).sum())
            continue
        if mb is None:
            union += float(np.asarray(ma, bool).sum())
            continue
        ma = np.asarray(ma, bool)
        mb = np.asarray(mb, bool)
        inter += float((ma & mb).sum())
        union += float((ma | mb).sum())
    return inter / union if union > 0 else 0.0


def _avg_area(masks: Sequence[Optional[np.ndarray]]) -> float:
    """Mean mask area over the frames where the track is non-empty; 0 if it
    never is."""
    areas = [float(np.asarray(m, bool).sum()) for m in masks if m is not None]
    areas = [a for a in areas if a > 0]
    return float(np.mean(areas)) if areas else 0.0


def _match_video(iou: np.ndarray, gt_ignore: np.ndarray, dt_areas: np.ndarray,
                 area_range: Tuple[float, float], thr: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """COCO's per-image matching, for one video and threshold.

    ``iou`` is ``[n_dt, n_gt]``, the predictions sorted by score and cut to
    maxDets, the ground truths sorted with the ignored ones last. Returns
    (prediction matched to a non-ignored ground truth, prediction ignored).
    A ground truth whose IoU equals the running best replaces it, so on an
    exact tie the last candidate wins (pycocotools' ``evaluateImg``)."""
    n_dt, n_gt = iou.shape
    gt_taken = np.zeros(n_gt, bool)
    dt_match_gt = np.full(n_dt, -1)
    for di in range(n_dt):
        best = min(thr, 1.0 - 1e-10)
        m = -1
        for gi in range(n_gt):
            if gt_taken[gi]:
                continue
            # once a real match is held, an ignored ground truth (sorted
            # last) cannot replace it
            if m > -1 and not gt_ignore[m] and gt_ignore[gi]:
                break
            if iou[di, gi] < best:
                continue
            best = iou[di, gi]
            m = gi
        if m > -1:
            gt_taken[m] = True
            dt_match_gt[di] = m
    matched = dt_match_gt >= 0
    dt_ig = np.zeros(n_dt, bool)
    dt_ig[matched] = gt_ignore[dt_match_gt[matched]]
    out_of_range = (dt_areas < area_range[0]) | (dt_areas > area_range[1])
    dt_ig |= ~matched & out_of_range
    return matched & ~dt_ig, dt_ig


def _pr_curves(scores: np.ndarray, tp: np.ndarray, ig: np.ndarray,
               n_gt: int) -> Tuple[float, float]:
    """(101-point AP, final recall) of pooled predictions; NaN when the
    category has no non-ignored ground truth (left out of the means)."""
    if n_gt == 0:
        return float("nan"), float("nan")
    keep = ~ig
    scores, tp = scores[keep], tp[keep]
    if scores.size == 0:
        return 0.0, 0.0
    order = np.argsort(-scores, kind="stable")
    tps = tp[order].astype(np.float64)
    tp_cum = np.cumsum(tps)
    fp_cum = np.cumsum(1.0 - tps)
    recall = tp_cum / n_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    for i in range(precision.size - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    prec_at = np.where(idx < precision.size,
                       precision[np.minimum(idx, precision.size - 1)], 0.0)
    return float(np.mean(prec_at)), float(recall[-1])


def evaluate_ytvis(gt_tracks: List[Dict], pred_tracks: List[Dict]) -> Dict[str, float]:
    """Scores video instance segmentation predictions; reads its inputs
    and writes nothing into them.

    :param gt_tracks: ``[{"video", "category", "masks": [per-frame mask or
        None]}]``
    :param pred_tracks: the same, plus ``"score"``
    :return: ``{AP, AP50, AP75, AP_S, AP_M, AP_L, AR1, AR10}``, averaged over
        the categories of the ground truth (NaN buckets left out, as COCO
        does)
    """
    categories = sorted({g["category"] for g in gt_tracks})
    videos = sorted({g["video"] for g in gt_tracks} | {p["video"] for p in pred_tracks})

    n_thr = len(IOU_THRESHOLDS)
    # ap[range][category, threshold]; rec[maxDets][category, threshold] over "all"
    ap = {rng: np.full((len(categories), n_thr), np.nan) for rng in AREA_RANGES}
    rec = {md: np.full((len(categories), n_thr), np.nan) for md in (1, 10)}

    for ci, cat in enumerate(categories):
        per_video = []  # score-sorted predictions' IoUs, areas and scores
        for vid in videos:
            gts = [g for g in gt_tracks if g["category"] == cat and g["video"] == vid]
            dts = sorted((p for p in pred_tracks
                          if p["category"] == cat and p["video"] == vid),
                         key=lambda p: -p.get("score", 0.0))
            iou = np.zeros((len(dts), len(gts)))
            for di, d in enumerate(dts):
                for gi, g in enumerate(gts):
                    iou[di, gi] = st_mask_iou(d["masks"], g["masks"])
            g_areas = np.asarray([_avg_area(g["masks"]) for g in gts])
            d_areas = np.asarray([_avg_area(d["masks"]) for d in dts])
            d_scores = np.asarray([d.get("score", 0.0) for d in dts])
            per_video.append((iou, g_areas, d_areas, d_scores))

        for rng_name, rng in AREA_RANGES.items():
            max_dets = (100,) if rng_name != "all" else (100, 10, 1)
            md0 = max(max_dets)
            for ti, thr in enumerate(IOU_THRESHOLDS):
                # greedy matching takes predictions in score order, so a
                # smaller maxDets' result is a prefix of the largest's
                # (COCOeval matches at maxDets[-1] and slices)
                vids_res = []
                n_gt = 0
                for iou, g_areas, d_areas, d_scores in per_video:
                    g_ig = (g_areas < rng[0]) | (g_areas > rng[1])
                    g_order = np.argsort(g_ig, kind="stable")  # ignored last
                    tp, ig = _match_video(iou[:md0][:, g_order], g_ig[g_order],
                                          d_areas[:md0], rng, float(thr))
                    vids_res.append((d_scores[:md0], tp, ig))
                    n_gt += int((~g_ig).sum())
                for md in max_dets:
                    ap_v, rec_v = _pr_curves(
                        np.concatenate([s[:md] for s, _, _ in vids_res])
                        if vids_res else np.zeros(0),
                        np.concatenate([t[:md] for _, t, _ in vids_res])
                        if vids_res else np.zeros(0, bool),
                        np.concatenate([i[:md] for _, _, i in vids_res])
                        if vids_res else np.zeros(0, bool),
                        n_gt)
                    if md == 100:
                        ap[rng_name][ci, ti] = ap_v
                    if rng_name == "all" and md in rec:
                        rec[md][ci, ti] = rec_v

    def _mean(a: np.ndarray) -> float:
        return float(np.nanmean(a)) if not np.all(np.isnan(a)) else 0.0

    per_thr_all = np.nanmean(ap["all"], axis=0) if categories else np.zeros(n_thr)
    return {
        "AP": _mean(ap["all"]),
        "AP50": float(per_thr_all[0]) if categories else 0.0,
        "AP75": float(per_thr_all[5]) if categories else 0.0,
        "AP_S": _mean(ap["S"]),
        "AP_M": _mean(ap["M"]),
        "AP_L": _mean(ap["L"]),
        "AR1": _mean(rec[1]),
        "AR10": _mean(rec[10]),
    }


def load_ytvis_results_json(path: str) -> List[Dict]:
    """The writer's ``results.json`` (the YT-VIS submission format) as
    ``evaluate_ytvis`` prediction dicts."""
    import json

    from stemseg_tpu_torch.utils import rle

    with open(path) as fh:
        entries = json.load(fh)
    return [{"video": e["video_id"], "category": e["category_id"],
             "score": e.get("score", 0.0),
             "masks": [None if seg is None else rle.decode(seg)
                       for seg in e["segmentations"]]}
            for e in entries]
