"""Unsupervised DAVIS J&F, the protocol of the official
``davis2017-evaluation`` package, in float64 numpy on the host.

* **J** (region similarity): per-frame IoU of a ground-truth object mask
  and a predicted mask; a frame where both are empty scores 1.0.
* **F** (boundary accuracy): per-frame F-measure of the mask boundaries.
  A pixel is on the boundary if it differs from its east, south or
  south-east neighbour (on the last row only the east one counts, on the
  last column only the south one, and the bottom-right corner never is);
  each boundary is dilated by the disk ``{(y, x): y² + x² <= r²}`` with
  ``r = ceil(0.008 * diagonal)`` (``skimage.morphology.disk``), and
  precision and recall count the boundary pixels inside the other side's
  dilation.
* **Unsupervised matching**: the proposals are unordered; each
  ground-truth object gets the proposal that maximises its mean
  ``(J + F) / 2`` over the frames by Hungarian assignment, extra proposals
  are ignored and an unmatched object scores 0.

Per-object means are pooled over sequences into J-mean, F-mean and J&F,
with the official recall (share of frames above 0.5) and decay (first bin
minus last bin of 4 overlapping inclusive bins).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment


def db_eval_iou(gt: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Per-frame IoU of ``[T, H, W]`` masks; 1.0 where both are empty."""
    gt = gt.astype(bool)
    pred = pred.astype(bool)
    inter = np.logical_and(gt, pred).sum(axis=(1, 2)).astype(np.float64)
    union = np.logical_or(gt, pred).sum(axis=(1, 2)).astype(np.float64)
    return np.where(union > 0, inter / np.maximum(union, 1.0), 1.0)


def _seg2bmap(mask: np.ndarray) -> np.ndarray:
    """Boundary map of one ``[H, W]`` mask by the shifted-XOR rule."""
    seg = mask.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def _disk(radius: int) -> np.ndarray:
    """``{(y, x): y² + x² <= r²}`` as uint8, ``skimage.morphology.disk``'s
    element (cv2's ``MORPH_ELLIPSE`` differs at some radii)."""
    y, x = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.uint8)


def db_eval_boundary(gt: np.ndarray, pred: np.ndarray,
                     bound_th: float = 0.008) -> np.ndarray:
    """Per-frame boundary F-measure of ``[T, H, W]`` masks."""
    import cv2

    t, h, w = gt.shape
    radius = int(np.ceil(bound_th * np.sqrt(h * h + w * w)))
    kernel = _disk(radius)
    out = np.empty(t, np.float64)
    for i in range(t):
        gb = _seg2bmap(np.asarray(gt[i], bool))
        pb = _seg2bmap(np.asarray(pred[i], bool))
        n_g, n_p = int(gb.sum()), int(pb.sum())
        if n_g == 0 and n_p == 0:
            out[i] = 1.0
            continue
        if n_g == 0 or n_p == 0:
            out[i] = 0.0
            continue
        gd = cv2.dilate(gb.astype(np.uint8), kernel) > 0
        pd = cv2.dilate(pb.astype(np.uint8), kernel) > 0
        precision = float((pb & gd).sum()) / n_p
        recall = float((gb & pd).sum()) / n_g
        out[i] = (0.0 if precision + recall == 0
                  else 2 * precision * recall / (precision + recall))
    return out


def _recall(series: np.ndarray) -> float:
    """Share of the frames scoring above 0.5."""
    return float(np.mean(series > 0.5))


def _decay(series: np.ndarray) -> float:
    """Mean of the first bin minus mean of the last, over 4 bins with ends
    ``round(linspace(1, N, 5) + 1e-10) - 1``, each bin inclusive of its end
    (neighbouring bins share a frame)."""
    n = len(series)
    ids = (np.round(np.linspace(1, n, 5) + 1e-10) - 1).astype(int)
    bins = [series[ids[i]:ids[i + 1] + 1] for i in range(4)]
    first = float(np.mean(bins[0])) if len(bins[0]) else 0.0
    last = float(np.mean(bins[3])) if len(bins[3]) else 0.0
    return first - last


def evaluate_davis_sequence(gt_masks: Sequence[np.ndarray],
                            pred_masks: Sequence[np.ndarray],
                            bound_th: float = 0.008,
                            with_series: bool = False):
    """Scores one sequence under the unsupervised protocol.

    :param gt_masks: per ground-truth object, ``[T, H, W]`` masks
    :param pred_masks: per proposal, ``[T, H, W]`` masks, in any order
    :param with_series: also return each object's per-frame J and F of its
        assigned proposal (zeros where unmatched), for recall and decay
    :return: (per-object J means, per-object F means[, J series, F series]),
        0.0 for an unmatched object
    """
    n_gt, n_pr = len(gt_masks), len(pred_masks)
    if n_gt == 0:
        return ([], [], [], []) if with_series else ([], [])
    t = gt_masks[0].shape[0]
    j_series = np.zeros((n_gt, n_pr, t))
    f_series = np.zeros((n_gt, n_pr, t))
    for gi in range(n_gt):
        for pi in range(n_pr):
            j_series[gi, pi] = db_eval_iou(gt_masks[gi], pred_masks[pi])
            f_series[gi, pi] = db_eval_boundary(gt_masks[gi], pred_masks[pi], bound_th)
    j = j_series.mean(axis=2)
    f = f_series.mean(axis=2)
    j_means = [0.0] * n_gt
    f_means = [0.0] * n_gt
    j_rows = [np.zeros(t)] * n_gt
    f_rows = [np.zeros(t)] * n_gt
    if n_pr:
        rows, cols = linear_sum_assignment(-(j + f) / 2.0)
        for gi, pi in zip(rows, cols):
            j_means[gi] = float(j[gi, pi])
            f_means[gi] = float(f[gi, pi])
            j_rows[gi] = j_series[gi, pi]
            f_rows[gi] = f_series[gi, pi]
    if with_series:
        return j_means, f_means, j_rows, f_rows
    return j_means, f_means


def evaluate_davis(gt_by_sequence: Dict[str, Sequence[np.ndarray]],
                   pred_by_sequence: Dict[str, Sequence[np.ndarray]],
                   bound_th: float = 0.008) -> Dict[str, float]:
    """Global J&F over sequences (per-object scores pooled, then averaged),
    with J / F recall and decay."""
    all_j: List[float] = []
    all_f: List[float] = []
    j_recalls: List[float] = []
    f_recalls: List[float] = []
    j_decays: List[float] = []
    f_decays: List[float] = []
    for seq, gt in gt_by_sequence.items():
        preds = pred_by_sequence.get(seq, [])
        j_means, f_means, j_rows, f_rows = evaluate_davis_sequence(
            gt, preds, bound_th, with_series=True)
        all_j.extend(j_means)
        all_f.extend(f_means)
        j_recalls.extend(_recall(r) for r in j_rows)
        f_recalls.extend(_recall(r) for r in f_rows)
        j_decays.extend(_decay(r) for r in j_rows)
        f_decays.extend(_decay(r) for r in f_rows)
    j_mean = float(np.mean(all_j)) if all_j else 0.0
    f_mean = float(np.mean(all_f)) if all_f else 0.0
    return {"J_mean": j_mean, "F_mean": f_mean,
            "J&F": (j_mean + f_mean) / 2.0,
            "J_recall": float(np.mean(j_recalls)) if j_recalls else 0.0,
            "F_recall": float(np.mean(f_recalls)) if f_recalls else 0.0,
            "J_decay": float(np.mean(j_decays)) if j_decays else 0.0,
            "F_decay": float(np.mean(f_decays)) if f_decays else 0.0}


def load_davis_results_dir(results_dir: str) -> List[np.ndarray]:
    """One sequence's indexed-palette PNGs (the DAVIS writer's
    ``results/<seq>/``) as one ``[T, H, W]`` bool volume per proposal id,
    in increasing id order."""
    import os

    from PIL import Image

    frames = sorted(fn for fn in os.listdir(results_dir) if fn.endswith(".png"))
    vol = np.stack([np.array(Image.open(os.path.join(results_dir, fn))) for fn in frames])
    ids = sorted(int(v) for v in np.unique(vol) if v != 0)
    return [(vol == i) for i in ids]
