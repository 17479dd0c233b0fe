"""Plain float32 inference of one sequence: sliding windows, window
averaging and the fg masks, sequential seeded clustering, cross-window
chaining with scipy's Hungarian, and the writers' masks at the raw frame
size.

Written from the published STEm-Seg inference (github.com/sabarim/STEm-Seg,
``stemseg/inference``) as the system under test states its semantics; a
frozen copy, in plain PyTorch, NumPy and SciPy, importing nothing of the
system under test. Departures from the published code, shared with the
system under test: the clustering's thresholds are compared in float32; the
window averages accumulate in float32; the association is done once a
sequence over global ids folded from the windows' raw ids (the published
chainer does it window by window over the same ids, which gives the same
assignment). The IoU of the association is float64 here, float32 on the
fused path: the two can differ only where two assignments' costs differ by
less than float32's epsilon.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from .model import FREE_DIMS, Model

OUTLIER = -1


def resize_params(h0: int, w0: int, min_dim: int, max_dim: int) -> Tuple[int, int]:
    """Network input (h, w) before the /32 padding; Python's ``round``."""
    scale = min_dim / float(min(h0, w0))
    if max(h0, w0) * scale > max_dim:
        scale = max_dim / float(max(h0, w0))
    return round(scale * h0), round(scale * w0)


def pad32(x: int) -> int:
    return int(math.ceil(x / 32)) * 32


def windows_of(n: int, t: int, overlap: int) -> List[List[int]]:
    if n < t:
        raise ValueError("the reference takes sequences of at least one window")
    out = [list(range(s, s + t)) for s in range(0, n - t + 1, t - overlap)]
    if out[-1][-1] != n - 1:
        out.append(list(range(n - t, n)))
    return out


def preprocess(raw: torch.Tensor, hw: Tuple[int, int], icfg: Dict) -> torch.Tensor:
    """uint8 ``[K, H0, W0, 3]`` BGR -> float32 ``[K, 3, H, W]``, /32 padded."""
    x = F.interpolate(raw.permute(0, 3, 1, 2).float(), size=hw, mode="bilinear",
                      align_corners=False, antialias=False)
    if icfg["normalize_to_unit_scale"]:
        x = x / 255.0
    mean = torch.tensor(icfg["image_mean"], device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(icfg["image_std"], device=x.device).view(1, 3, 1, 1)
    x = (x - mean) / std
    if not icfg["bgr_input"]:
        x = x.flip(1)
    return F.pad(x, (0, pad32(hw[1]) - hw[1], 0, pad32(hw[0]) - hw[0]))


def cluster(emb, bw, seed, fg, k: int, primary: float, secondary: float,
            min_seed: float) -> torch.Tensor:
    """Sequential seeded clustering of ``P`` points (``emb``, ``bw`` ``[P, E]``
    with the free dims' bandwidths appended); slots ``0..k-1`` or -1. The
    seed is the first highest-seediness available point; the stop below
    ``min_seed`` is final; leftover points of the last active iteration's
    availability go to their farthest cluster when within ``secondary``."""
    p = emb.shape[0]
    labels = torch.full((p,), -1, dtype=torch.int32, device=emb.device)
    best_d = torch.full((p,), float("-inf"), device=emb.device)
    best_k = torch.zeros(p, dtype=torch.int32, device=emb.device)
    avail_last, any_cluster = fg, False
    for i in range(k):
        avail = (labels == -1) & fg
        avail_last = avail
        scores = torch.where(avail, seed, float("-inf"))
        idx = int(torch.argmax(scores))
        if not bool(avail.any()) or not bool(scores[idx] >= torch.tensor(min_seed)):
            break
        d = torch.sqrt((((emb - emb[idx]) ** 2) * bw[idx]).sum(dim=1))
        labels = torch.where((torch.exp(-0.5 * d) > primary) & avail, i, labels)
        dm = torch.where(avail, d, 1e8)
        upd = dm > best_d
        best_k = torch.where(upd, i, best_k)
        best_d = torch.where(upd, dm, best_d)
        any_cluster = True
    if any_cluster and bool(avail_last.any()):
        labels = torch.where((torch.exp(-0.5 * best_d) > secondary) & avail_last, best_k, labels)
    return labels


class SequenceResult:
    def __init__(self, labels: np.ndarray, multiclass: Optional[torch.Tensor]):
        self.labels = labels  # [T, h, w] int32 global track ids, -1 outlier
        self.multiclass = multiclass  # [T, h, w, C] window-averaged logits (YT-VIS)


@torch.no_grad()
def infer_sequence(model: Model, cfg: Dict, frames: np.ndarray, overlap: int,
                   semseg_logits: bool, seediness_thresh: float = 0.25) -> SequenceResult:
    """One sequence of raw uint8 ``[T, H0, W0, 3]`` BGR frames -> its track
    labels at a quarter of the network input, and with a semseg head its
    averaged multiclass logits (for the YT-VIS class vote)."""
    dev = next(model.parameters()).device
    icfg, ccfg = cfg["input"], cfg["clustering"]
    mode = cfg["model"]["embedding_dim_mode"]
    e_size = cfg["model"]["embeddings"]["embedding_size"]
    n_free = FREE_DIMS.get(mode, 0)
    v = e_size - n_free
    free_bw = [1.0 / (s * s) for s in cfg["training"]["losses"]["embedding"]["free_dim_stds"]]
    k = ccfg["max_instances"]
    n, t = frames.shape[0], icfg["num_frames"]
    hw = resize_params(frames.shape[1], frames.shape[2], icfg["min_dim"], icfg["max_dim"])
    wins = windows_of(n, t, overlap)

    # pass 1: the heads of every window; the per-frame averages
    feats: Dict[int, List[torch.Tensor]] = {}
    acc = cnt = None
    per_window = []
    for wi, win in enumerate(wins):
        new = [f for f in win if f not in feats]
        if new:
            raw = torch.from_numpy(np.ascontiguousarray(frames[new])).to(dev)
            out = model.backbone(preprocess(raw, hw, icfg))
            for j, f in enumerate(new):
                feats[f] = [o[j] for o in out]
        clip = [torch.stack([feats[f][s] for f in win], dim=1)[None] for s in range(4)][::-1]
        emb_out, seed, sem = model.heads(clip)
        emb_out = emb_out[0].permute(1, 2, 3, 0)
        emb = emb_out[..., :e_size]
        bw = torch.exp(emb_out[..., e_size:e_size + v]) * 10.0
        seed = emb_out[..., e_size + v] if seed is None else seed[0, 0]
        wmap = sem[0].permute(1, 2, 3, 0) if sem is not None else seed
        if acc is None:
            acc = torch.zeros((n,) + wmap.shape[1:], device=dev)
            cnt = torch.zeros(n, device=dev)
        idx = torch.tensor(win, device=dev)
        acc[idx] += wmap
        cnt[idx] += 1.0
        per_window.append((emb, bw, seed))
        # a frame no later window holds leaves the cache
        later = {f for w in wins[wi + 1:] for f in w}
        for f in [f for f in feats if f not in later]:
            del feats[f]
    mean = acc / cnt.view((-1,) + (1,) * (acc.dim() - 1))
    multiclass = None
    if cfg["model"]["use_semseg_head"]:
        if mean.shape[-1] > 2:
            fg = torch.sigmoid(mean[..., -1]) > 0.5
            multiclass = mean[..., :-1] if semseg_logits else torch.softmax(mean[..., :-1], -1)
        else:
            fg = torch.softmax(mean, dim=-1)[..., 1] > 0.5
    else:
        fg = mean > seediness_thresh

    # pass 2: clustering into raw id blocks, association on the overlaps
    committed: Dict[int, np.ndarray] = {}  # frame -> raw ids
    gmap: Dict[int, int] = {}
    prev: List[int] = []
    for wi, (win, (emb, bw, seed)) in enumerate(zip(wins, per_window)):
        p = emb.shape[0] * emb.shape[1] * emb.shape[2]
        bw_full = torch.cat([bw.reshape(p, v)] + [torch.full((p, 1), b, device=dev)
                                                  for b in free_bw], dim=1)
        lab = cluster(emb.reshape(p, e_size), bw_full, seed.reshape(p),
                      fg[torch.tensor(win, device=dev)].reshape(p), k,
                      ccfg["primary_prob_threshold"], ccfg["secondary_prob_threshold"],
                      ccfg["min_seediness_prob"])
        if ccfg["secondary_assignment"] != "reference":
            raise ValueError("the reference holds the published secondary assignment only")
        base = 1 + wi * k
        lab = torch.where(lab >= 0, lab + base, -1).reshape(emb.shape[:3]).cpu().numpy()
        overlap_frames = [f for f in win if f in set(prev)]
        if overlap_frames:
            old = remap(np.stack([committed[f] for f in overlap_frames]), gmap)
            new = lab[[win.index(f) for f in overlap_frames]]
            g_ids, gi = np.unique(old, return_inverse=True)
            n_ids, ni = np.unique(new, return_inverse=True)
            inter = np.bincount(gi.ravel() * len(n_ids) + ni.ravel(),
                                minlength=len(g_ids) * len(n_ids)).reshape(len(g_ids), -1)
            keep_g, keep_n = g_ids != OUTLIER, n_ids != OUTLIER
            inter = inter[keep_g][:, keep_n].astype(np.float64)
            g_ids, n_ids = g_ids[keep_g].tolist(), n_ids[keep_n].tolist()
            if g_ids and n_ids:
                ng = np.bincount(gi.ravel(), minlength=len(keep_g))[keep_g].astype(np.float64)
                nn_ = np.bincount(ni.ravel(), minlength=len(keep_n))[keep_n].astype(np.float64)
                union = ng[:, None] + nn_[None, :] - inter
                iou = np.where(union > 0, inter / np.maximum(union, 1.0), 0.0)
                rows, cols = linear_sum_assignment(1.0 - iou)
                for r, c in zip(rows, cols):
                    gmap[n_ids[c]] = g_ids[r]
        for j, f in enumerate(win):
            if f not in committed:
                committed[f] = lab[j]
        prev = win
    labels = remap(np.stack([committed[f] for f in range(n)]), gmap)
    return SequenceResult(labels.astype(np.int32), multiclass)


def remap(ids: np.ndarray, gmap: Dict[int, int]) -> np.ndarray:
    """``ids`` (-1 and raw ids) with each raw id replaced by its global id."""
    if not gmap:
        return ids
    lut = np.arange(-1, max(int(ids.max()), max(gmap)) + 1)
    for raw, g in gmap.items():
        lut[raw + 1] = g
    return lut[ids + 1]


def lifetimes(labels: np.ndarray) -> Dict[int, int]:
    first, last = {}, {}
    for t in range(labels.shape[0]):
        for i in np.unique(labels[t]).tolist():
            first.setdefault(i, t)
            last[i] = t
    return {i: last[i] - first[i] for i in first}


def pixel_counts(labels: np.ndarray) -> Dict[int, int]:
    ids, cnt = np.unique(labels, return_counts=True)
    return dict(zip(ids.tolist(), cnt.tolist()))


def kept_tracks(labels: np.ndarray, max_tracks: int) -> List[int]:
    """The ``max_tracks`` longest-lived tracks; ties in order of first
    appearance, frame by frame, by id within a frame."""
    life = lifetimes(labels)
    return [i for i, _ in sorted(life.items(), key=lambda x: x[1], reverse=True)
            if i != OUTLIER][:max_tracks]


def masks_at_raw(labels_t: torch.Tensor, kept: List[int], raw_hw: Tuple[int, int],
                 cfg: Dict) -> torch.Tensor:
    """One frame's kept tracks ``[K, H0, W0]`` bool: the quarter-scale masks
    upsampled 4x, the /32 padding cropped, resized to the raw size, > 0.5."""
    icfg = cfg["input"]
    h, w = resize_params(raw_hw[0], raw_hw[1], icfg["min_dim"], icfg["max_dim"])
    ids = torch.tensor(kept, device=labels_t.device, dtype=labels_t.dtype).view(-1, 1, 1)
    x = (labels_t[None] == ids).float()[:, None]
    x = F.interpolate(x, size=(labels_t.shape[0] * 4, labels_t.shape[1] * 4), mode="bilinear",
                      align_corners=False)[:, :, :h, :w]
    x = F.interpolate(x, size=tuple(raw_hw), mode="bilinear", align_corners=False)
    return x[:, 0] > 0.5


def index_maps(labels: np.ndarray, kept: List[int], raw_hw, cfg: Dict,
               device) -> np.ndarray:
    """Per frame, kept track n as index n + 1 at the raw size, later ones
    over earlier ones: what the DAVIS writer's PNGs hold."""
    out = np.zeros((labels.shape[0],) + tuple(raw_hw), np.uint8)
    lab = torch.from_numpy(labels).to(device)
    for t in range(labels.shape[0]):
        if kept:
            full = masks_at_raw(lab[t], kept, raw_hw, cfg)
            idx = torch.zeros(tuple(raw_hw), dtype=torch.uint8, device=device)
            for j in range(len(kept)):
                idx = torch.where(full[j], j + 1, idx)
            out[t] = idx.cpu().numpy()
    return out


def davis_index_maps(labels: np.ndarray, raw_hw, cfg: Dict, max_tracks: int,
                     device) -> np.ndarray:
    """The DAVIS writer's PNGs: the kept tracks by lifetime."""
    return index_maps(labels, kept_tracks(labels, max_tracks), raw_hw, cfg, device)


def ytvis_instances(labels: np.ndarray, multiclass: torch.Tensor, raw_hw, cfg: Dict,
                    max_tracks: int, device) -> Tuple[np.ndarray, List[Dict]]:
    """What the YT-VIS writer's ``results.json`` holds for one sequence:
    its kept tracks' masks as ``index_maps``, and per kept track its score
    (pixels over the largest kept track's) and its class (softmax of the
    mean logits over its pixels, background dropped, argmax + 1)."""
    kept = kept_tracks(labels, max_tracks)
    if not kept:
        return np.zeros((labels.shape[0],) + tuple(raw_hw), np.uint8), []
    counts = pixel_counts(labels)
    lab = torch.from_numpy(labels).to(device)
    sums = torch.zeros((len(kept), multiclass.shape[-1] - 1), dtype=torch.float64, device=device)
    areas = torch.zeros(len(kept), dtype=torch.float64, device=device)
    ids = torch.tensor(kept, device=device, dtype=lab.dtype).view(-1, 1, 1)
    for t in range(labels.shape[0]):
        onehot = (lab[t][None] == ids).reshape(len(kept), -1).double()
        areas += onehot.sum(dim=1)
        sums += onehot @ multiclass[t][..., 1:].reshape(onehot.shape[1], -1).double()
    probs = torch.softmax(sums / areas.clamp(min=1.0)[:, None], dim=1).cpu().numpy()
    top = float(max(counts[i] for i in kept))
    return index_maps(labels, kept, raw_hw, cfg, device), [
        {"score": counts[i] / top, "category_id": int(np.argmax(probs[j])) + 1}
        for j, i in enumerate(kept)]
