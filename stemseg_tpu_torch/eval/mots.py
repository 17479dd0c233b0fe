"""CLEAR-MOTS for KITTI-MOTS (sMOTSA, MOTSA, MOTSP), the protocol of the
MOTS paper and its ``mots_tools`` scorer, in float64 numpy on the host.

* In each frame the ground-truth and hypothesis masks are matched by mask
  IoU with Hungarian assignment; a pair is a TP when its IoU exceeds 0.5.
* An id switch is a TP whose ground-truth track was last matched to
  another hypothesis id.
* An unmatched hypothesis that lies more than half inside the frame's
  ignore region is not a FP.
* ``sMOTSA = (soft_TP - FP - IDS) / num_gt`` with ``soft_TP`` the sum of
  the TPs' IoUs, ``MOTSA = (TP - FP - IDS) / num_gt``,
  ``MOTSP = soft_TP / TP``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
from scipy.optimize import linear_sum_assignment


def _mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    a = a.astype(bool)
    b = b.astype(bool)
    inter = float(np.logical_and(a, b).sum())
    union = float(np.logical_or(a, b).sum())
    return inter / union if union > 0 else 0.0


def evaluate_mots(gt_frames: Sequence[Dict[int, np.ndarray]],
                  hyp_frames: Sequence[Dict[int, np.ndarray]],
                  ignore_frames: Optional[Sequence[Optional[np.ndarray]]] = None
                  ) -> Dict[str, float]:
    """Scores one sequence, or sequences concatenated with disjoint track ids.

    :param gt_frames: per frame, ``{gt track id: [H, W] mask}``
    :param hyp_frames: per frame, ``{hypothesis track id: [H, W] mask}``
    :param ignore_frames: per frame, an ignore-region mask or None
    :return: ``{sMOTSA, MOTSA, MOTSP, TP, FP, FN, IDS, soft_TP, num_gt}``
    """
    if len(gt_frames) != len(hyp_frames):
        raise ValueError(f"{len(gt_frames)} ground-truth frames against "
                         f"{len(hyp_frames)} hypothesis frames")
    if ignore_frames is None:
        ignore_frames = [None] * len(gt_frames)

    tp = fp = fn = ids = 0
    soft_tp = 0.0
    num_gt = 0
    last_match: Dict[int, int] = {}  # gt track -> hypothesis id of its last match

    for gt, hyp, ignore in zip(gt_frames, hyp_frames, ignore_frames):
        g_ids = sorted(gt)
        h_ids = sorted(hyp)
        num_gt += len(g_ids)

        iou = np.zeros((len(g_ids), len(h_ids)))
        for i, gi in enumerate(g_ids):
            for j, hj in enumerate(h_ids):
                iou[i, j] = _mask_iou(gt[gi], hyp[hj])

        matched_h: set = set()
        matched_g: set = set()
        if g_ids and h_ids:
            rows, cols = linear_sum_assignment(-iou)
            for i, j in zip(rows, cols):
                if iou[i, j] > 0.5:
                    tp += 1
                    soft_tp += float(iou[i, j])
                    matched_g.add(g_ids[i])
                    matched_h.add(h_ids[j])
                    prev = last_match.get(g_ids[i])
                    if prev is not None and prev != h_ids[j]:
                        ids += 1
                    last_match[g_ids[i]] = h_ids[j]

        fn += len(g_ids) - len(matched_g)

        for hj in h_ids:
            if hj in matched_h:
                continue
            if ignore is not None:
                m = hyp[hj].astype(bool)
                area = float(m.sum())
                if area > 0 and float((m & ignore.astype(bool)).sum()) / area > 0.5:
                    continue  # inside the ignore region: not a FP
            fp += 1

    return {
        "sMOTSA": (soft_tp - fp - ids) / num_gt if num_gt else 0.0,
        "MOTSA": (tp - fp - ids) / num_gt if num_gt else 0.0,
        "MOTSP": soft_tp / tp if tp else 0.0,
        "TP": tp, "FP": fp, "FN": fn, "IDS": ids,
        "soft_TP": soft_tp, "num_gt": num_gt,
    }


def parse_mots_txt(path: str):
    """A KITTI-MOTS txt of ``frame id class h w rle`` lines (the writer's
    ``results/<seq>.txt``) as ``(frames, track_class)``: per frame
    ``{track id: mask}``, and ``{track id: class}`` from the class column.
    The scorer is per class, so the caller filters by ``track_class``."""
    from stemseg_tpu_torch.utils import rle

    frames: Dict[int, Dict[int, np.ndarray]] = {}
    track_class: Dict[int, int] = {}
    max_t = -1
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split(" ")
            if len(parts) < 6:
                continue
            t, tid, cls = int(parts[0]), int(parts[1]), int(parts[2])
            h, w = int(parts[3]), int(parts[4])
            counts = " ".join(parts[5:])
            frames.setdefault(t, {})[tid] = rle.decode({"size": [h, w], "counts": counts})
            track_class[tid] = cls
            max_t = max(max_t, t)
    return [frames.get(t, {}) for t in range(max_t + 1)], track_class
