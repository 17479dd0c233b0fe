"""Sequential seeded clustering of one window: the two CUDA kernels, their
plain PyTorch version, and the dispatch between them.

Contract (shared by all three, and by the JAX package's Pallas kernels):

* inputs ``emb [P, E]`` and ``bw [P, E]`` float32 (free-dim bandwidths
  already appended), ``seed [P]`` float32, ``fg [P]`` bool; E <= 8,
  1 <= K <= 32;
* outputs ``labels [P]`` int32 (cluster slot or -1) and ``meta [32, 128]``
  float32, row k = [centre (E) | bandwidth (E) | 0 ... | seed prob | valid]
  for an active iteration k, zeros otherwise.

``cluster_points`` sends a window to ``cluster_points_single`` when its
state would fit the TPU kernel's 14 MB VMEM budget and to
``cluster_points_tiled`` otherwise: the same rule as the JAX package, so a
window reaches the counterpart of the kernel it reaches there. A wrapper
given CPU tensors runs ``cluster_points_reference``; given CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from stemseg_tpu_torch.ops import build

K_PAD = 32
META_COLS = 128
VMEM_BUDGET_BYTES = 14 * 1024 * 1024
TILED_POINT_LIMIT = 16 * 1024 * 1024
MAX_E_DIMS = 8

# launches per wrapper (the plain version counts its calls)
launch_counts = {"cluster_points_single": 0, "cluster_points_tiled": 0,
                 "cluster_points_reference": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def single_block_supported(n_points: int, max_instances: int, e_dims: int) -> bool:
    """The TPU single-block kernel keeps (2E inputs + seed + fg + labels +
    best_d + best_idx + avail_last) 4-byte planes resident: (2E + 6) * 4
    bytes per point must fit the 14 MB budget."""
    return (n_points * (2 * e_dims + 6) * 4 <= VMEM_BUDGET_BYTES
            and max_instances <= K_PAD)


def cluster_points_reference(emb, bw, seed, fg, *, e_dims: int, max_instances: int,
                             primary: float, secondary: float, min_seediness: float,
                             reference_secondary: bool
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eager PyTorch transcription of the JAX package's ``clustering._cluster``
    with the kernels' (labels, meta) outputs. Comparisons with the float
    thresholds happen in float32, as in JAX."""
    launch_counts["cluster_points_reference"] += 1
    dev = emb.device
    p = emb.shape[0]
    fg = fg.bool()
    min_seed = torch.tensor(min_seediness, dtype=torch.float32, device=dev)

    labels = torch.full((p,), -1, dtype=torch.int32, device=dev)
    meta = torch.zeros(K_PAD, META_COLS, dtype=torch.float32, device=dev)
    best_d = torch.full((p,), float("-inf") if reference_secondary else float("inf"),
                        dtype=torch.float32, device=dev)
    best_idx = torch.zeros(p, dtype=torch.int32, device=dev)
    avail_last = fg
    any_cluster = False
    cols = [emb[:, e] for e in range(e_dims)]

    for k in range(max_instances):
        # the stop is sticky: once an iteration is inactive nothing changes,
        # and that iteration's availability mask is the one kept
        avail = (labels == -1) & fg
        avail_last = avail
        scores = torch.where(avail, seed, float("-inf"))
        idx = int(torch.argmax(scores))  # first occurrence of the max
        max_score = scores[idx]
        if not bool(avail.any()) or not bool(max_score >= min_seed):
            break
        center, cbw = emb[idx], bw[idx]
        d2 = torch.zeros(p, dtype=torch.float32, device=dev)
        for e in range(e_dims):
            d2 = d2 + (cols[e] - center[e]) ** 2 * cbw[e]
        d = torch.sqrt(d2)
        match = (torch.exp(-0.5 * d) > primary) & avail
        labels = torch.where(match, k, labels)
        d_masked = torch.where(avail, d, 1e8)
        upd = d_masked > best_d if reference_secondary else d_masked < best_d
        best_idx = torch.where(upd, k, best_idx)
        best_d = torch.where(upd, d_masked, best_d)
        meta[k, :e_dims] = center
        meta[k, e_dims:2 * e_dims] = cbw
        meta[k, META_COLS - 2] = max_score
        meta[k, META_COLS - 1] = 1.0
        any_cluster = True

    if any_cluster and bool(avail_last.any()):
        gate = avail_last if reference_secondary else (labels == -1) & fg
        update = (torch.exp(-0.5 * best_d) > secondary) & gate
        labels = torch.where(update, best_idx, labels)
    return labels, meta


_ARGTYPES = [ctypes.c_void_p] * 10 + [
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _c_function(symbol: str):
    fn = getattr(build.load("cluster"), symbol)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch(symbol: str, emb, bw, seed, fg, *, e_dims, max_instances, primary,
            secondary, min_seediness, reference_secondary):
    p = emb.shape[0]
    if not (emb.is_cuda and bw.is_cuda and seed.is_cuda and fg.is_cuda):
        raise ValueError("all inputs must be CUDA tensors")
    if (emb.dtype, bw.dtype, seed.dtype, fg.dtype) != (
            torch.float32, torch.float32, torch.float32, torch.bool):
        raise TypeError("emb, bw, seed must be float32 and fg bool")
    if emb.shape != (p, e_dims) or bw.shape != (p, e_dims) or seed.shape != (p,) \
            or fg.shape != (p,):
        raise ValueError(f"shapes emb {tuple(emb.shape)} bw {tuple(bw.shape)} seed "
                         f"{tuple(seed.shape)} fg {tuple(fg.shape)} for E={e_dims}")
    if not (1 <= e_dims <= MAX_E_DIMS and 1 <= max_instances <= K_PAD
            and 1 <= p <= TILED_POINT_LIMIT):
        raise ValueError(f"unsupported problem: P={p} E={e_dims} K={max_instances}")
    emb, bw, seed, fg = (t.contiguous() for t in (emb, bw, seed, fg))
    dev = emb.device
    with torch.cuda.device(dev):
        labels = torch.empty(p, dtype=torch.int32, device=dev)
        best_d = torch.empty(p, dtype=torch.float32, device=dev)
        best_idx = torch.empty(p, dtype=torch.int32, device=dev)
        avail_last = torch.empty(p, dtype=torch.uint8, device=dev)
        keys = torch.zeros(K_PAD, dtype=torch.int64, device=dev)
        meta = torch.zeros(K_PAD, META_COLS, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _c_function(symbol)(
            emb.data_ptr(), bw.data_ptr(), seed.data_ptr(), fg.data_ptr(),
            labels.data_ptr(), best_d.data_ptr(), best_idx.data_ptr(),
            avail_last.data_ptr(), keys.data_ptr(), meta.data_ptr(),
            p, e_dims, max_instances, primary, secondary, min_seediness,
            int(bool(reference_secondary)), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed to launch: CUDA error {err}")
    return labels, meta


def cluster_points_single(emb, bw, seed, fg, **kwargs):
    """Counterpart of ``_cluster_kernel``: one cooperative launch."""
    if emb.device.type == "cpu":
        return cluster_points_reference(emb, bw, seed, fg, **kwargs)
    out = _launch("stemseg_cluster_single", emb, bw, seed, fg, **kwargs)
    launch_counts["cluster_points_single"] += 1
    return out


def cluster_points_tiled(emb, bw, seed, fg, **kwargs):
    """Counterpart of ``_cluster_kernel_tiled``: K+1 sweep launches."""
    if emb.device.type == "cpu":
        return cluster_points_reference(emb, bw, seed, fg, **kwargs)
    out = _launch("stemseg_cluster_tiled", emb, bw, seed, fg, **kwargs)
    launch_counts["cluster_points_tiled"] += 1
    return out


def cluster_points(emb, bw, seed, fg, *, e_dims: int, max_instances: int,
                   primary: float, secondary: float, min_seediness: float,
                   reference_secondary: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch one window on its point count (see the module docstring)."""
    kwargs = dict(e_dims=e_dims, max_instances=max_instances, primary=primary,
                  secondary=secondary, min_seediness=min_seediness,
                  reference_secondary=reference_secondary)
    if single_block_supported(emb.shape[0], max_instances, e_dims):
        return cluster_points_single(emb, bw, seed, fg, **kwargs)
    return cluster_points_tiled(emb, bw, seed, fg, **kwargs)
