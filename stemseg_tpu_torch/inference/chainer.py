"""Cross-window track stitching (the online chainer).

Labels are dense ``[T, H, W]`` int32 maps on the device (-1 = outlier/bg).
The pass has three phases, so that the host waits for the device once:

1. every window is clustered into its own block of raw ids
   (``1 + i * K``), and the intersection counts between its clusters and
   the raw labels already committed on its overlap frames are queued as a
   one-hot product (exact integers in float32);
2. on the host, raw ids fold into global track ids (intersections add up
   over the disjoint pixel sets of the committed chunks) and the Hungarian
   assignment on ``1 - IoU`` runs per window, every pair accepted;
3. each committed chunk's ids are rewritten once and the volume crosses to
   the host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

OUTLIER_LABEL = -1


def _pad_ids(ids: Sequence[int], multiple: int = 8) -> List[int]:
    """Pad an id list with -2 (an id that never occurs) to a multiple."""
    n = len(ids)
    target = ((n + multiple - 1) // multiple) * multiple
    return list(ids) + [-2] * (target - n)


def _intersection_counts(existing: torch.Tensor, new: torch.Tensor,
                         cand1: torch.Tensor, cand2: torch.Tensor):
    """Pixel intersections ``[C1, C2]`` and per-id pixel counts between two
    candidate id sets on the overlap frames."""
    a = existing.reshape(-1)
    b = new.reshape(-1)
    onehot1 = (a[None, :] == cand1[:, None]).float()
    onehot2 = (b[None, :] == cand2[:, None]).float()
    return onehot1 @ onehot2.T, onehot1.sum(dim=1), onehot2.sum(dim=1)


def _relabel(labels: torch.Tensor, src_ids: Sequence[int],
             dst_ids: Sequence[int]) -> torch.Tensor:
    """labels == src_ids[k] -> dst_ids[k]."""
    out = labels
    for s, d in zip(src_ids, dst_ids):
        out = torch.where(labels == s, d, out)
    return out


def fold_and_associate(jobs) -> Tuple[Dict[int, int], Dict[int, List[Tuple[int, int]]]]:
    """Host-side phase 2.

    :param jobs: ``(window_idx, cand1, cand2, inter, n1, n2)`` in window
        order, numpy float32 ``inter`` [len(cand1)+, len(cand2)] and counts;
        padded rows of ``cand1`` must have ``n1 == 0``
    :return: (raw id -> global id, associations per window)
    """
    gmap: Dict[int, int] = {}
    assoc_by_window: Dict[int, List[Tuple[int, int]]] = {}

    for i, cand1, cand2, inter, n1, n2 in jobs:
        inter = np.asarray(inter)[:len(cand1)]
        n1 = np.asarray(n1)[:len(cand1)]
        n2 = np.asarray(n2)

        global_rows: Dict[int, np.ndarray] = {}
        global_counts: Dict[int, float] = {}
        for r, raw in enumerate(cand1):
            if n1[r] <= 0:
                continue
            g = gmap.get(raw, raw)
            if g in global_rows:
                global_rows[g] = global_rows[g] + inter[r]
                global_counts[g] += float(n1[r])
            else:
                global_rows[g] = inter[r].copy()
                global_counts[g] = float(n1[r])

        present_new = [c for c, raw in enumerate(cand2) if n2[c] > 0]
        if not global_rows or not present_new:
            continue

        g_ids = sorted(global_rows)
        inter_g = np.stack([global_rows[g] for g in g_ids])[:, present_new]
        ng = np.asarray([global_counts[g] for g in g_ids])
        nn = n2[present_new]
        union = ng[:, None] + nn[None, :] - inter_g
        iou = np.where(union > 0, inter_g / np.maximum(union, 1.0), 0.0)

        rows, cols = linear_sum_assignment(1.0 - iou)
        assoc = [(g_ids[r], cand2[present_new[c]]) for r, c in zip(rows, cols)]
        assoc_by_window[i] = assoc
        for g, new_raw in assoc:
            gmap[new_raw] = g
    return gmap, assoc_by_window


def track_stats(labels: np.ndarray) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Per-track pixel counts and lifetimes of a dense [T, H, W] volume."""
    counts: Dict[int, int] = {}
    first: Dict[int, int] = {}
    last: Dict[int, int] = {}
    for t in range(labels.shape[0]):
        ids, cnt = np.unique(labels[t], return_counts=True)
        for iid, c in zip(ids.tolist(), cnt.tolist()):
            counts[iid] = counts.get(iid, 0) + c
            first.setdefault(iid, t)
            last[iid] = t
    lifetimes = {iid: last[iid] - first[iid] for iid in counts}
    return counts, lifetimes


class OnlineChainer:
    """Clusters each window and stitches labels across windows.

    ``cluster_fn(embeddings, bandwidths, seediness, fg_mask, label_start)``
    returns a ``ClusterResult`` whose ``labels`` is a dense [Tw, H, W] int32
    map with ids in ``[label_start, label_start + max_instances)``.
    """

    def __init__(self, cluster_fn, max_instances: int = 20):
        self.cluster_fn = cluster_fn
        self.max_instances = max_instances

    def process(self, fg_masks: torch.Tensor, windows: List[dict]):
        """:param fg_masks: [T, H, W] bool on the windows' device
        :param windows: dicts of ``frames`` (unique sorted ids),
            ``embeddings`` [Tw,H,W,E], ``bandwidths`` [Tw,H,W,V],
            ``seediness`` [Tw,H,W]
        :return: (labels [T,H,W] int32 numpy, counts, lifetimes,
            per-window ClusterResult list)
        """
        dev = fg_masks.device
        num_frames = fg_masks.shape[0]
        k = self.max_instances

        metas = []
        chunks: List[Tuple[List[int], torch.Tensor]] = []  # (frames, raw labels)
        committed_by: Dict[int, int] = {}  # frame -> chunk index
        chunk_window: List[int] = []       # chunk index -> window index
        assoc_jobs = []

        prev_frames: List[int] = []
        for i, win in enumerate(windows):
            frames = list(win["frames"])
            window_fg = fg_masks[torch.tensor(frames, device=dev)]
            label_start = 1 + i * k
            result = self.cluster_fn(win["embeddings"], win["bandwidths"],
                                     win["seediness"], window_fg, label_start)
            metas.append(result)

            if i == 0:
                new_frames = frames
                chunk_rows = result.labels
            else:
                overlap = sorted(set(frames) & set(prev_frames))
                cur_overlap = result.labels[
                    torch.tensor([frames.index(t) for t in overlap], device=dev)]
                src_chunks = sorted({committed_by[t] for t in overlap})
                existing = torch.stack(
                    [chunks[committed_by[t]][1][chunks[committed_by[t]][0].index(t)]
                     for t in overlap])
                cand1 = sorted({c for ci in src_chunks
                                for c in range(1 + chunk_window[ci] * k,
                                               1 + (chunk_window[ci] + 1) * k)})
                cand2 = list(range(label_start, label_start + k))
                counts = _intersection_counts(
                    existing, cur_overlap,
                    torch.tensor(_pad_ids(cand1), device=dev),
                    torch.tensor(cand2, device=dev))
                assoc_jobs.append((i, cand1, cand2, counts))

                new_frames = [t for t in frames if t not in overlap]
                chunk_rows = result.labels[
                    torch.tensor([frames.index(t) for t in new_frames], device=dev)]

            ci = len(chunks)
            chunks.append((new_frames, chunk_rows))
            chunk_window.append(i)
            for t in new_frames:
                committed_by[t] = ci
            prev_frames = frames

        gmap, _ = fold_and_associate(
            (i, cand1, cand2, *(c.cpu().numpy() for c in counts))
            for i, cand1, cand2, counts in assoc_jobs)

        final_rows: List[Optional[torch.Tensor]] = [None] * num_frames
        for ci, (frames, rows) in enumerate(chunks):
            wi = chunk_window[ci]
            lut = [(raw, gmap[raw]) for raw in range(1 + wi * k, 1 + (wi + 1) * k)
                   if gmap.get(raw, raw) != raw]
            if lut:
                rows = _relabel(rows, [s for s, _ in lut], [d for _, d in lut])
            for row_i, t in enumerate(frames):
                final_rows[t] = rows[row_i]

        labels = torch.stack(final_rows).cpu().numpy()
        counts, lifetimes = track_stats(labels)
        return labels, counts, lifetimes, metas
