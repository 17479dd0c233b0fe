"""Masked linear sum assignment: the CUDA kernel (``csrc/lsap.cu``), its
plain PyTorch version, and the dispatch between them.

``lsa_masked(cost, row_valid, col_valid)`` returns what scipy's
``linear_sum_assignment`` returns on the compacted matrix (valid rows x
valid columns), in the original index space: ``(col4row [R], row4col [C])``
int32, the matched column of each valid row and row of each valid column,
-1 where unmatched or invalid. Ties break as scipy breaks them (descending
``remaining``, the last unassigned achiever, transposed when tall); the
arithmetic is float32, as the JAX package's ``lsap.lsa_masked`` does it.
Given CPU tensors it runs ``lsa_masked_reference``; given CUDA tensors it
launches the kernel (at most 1024 rows and columns) or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from stemseg_tpu_torch.ops import build, launches

MAX_SIDE = 1024  # csrc/lsap.cu kMaxSide

# launches of the kernel's wrapper, as executions on the device (a CUDA graph's count
# at each replay: ``ops.launches``); the plain version counts its calls
launch_counts = {"lsa_masked": 0, "lsa_masked_reference": 0}


def _count(name: str) -> None:
    launches.bump(launch_counts, name)


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _solve_square(cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor,
                  stats: Optional[dict] = None):
    """scipy's solver on a [B, B] padded square matrix with #valid rows <=
    #valid columns; the loop state in float32 tensors, the control flow on
    the host. ``stats["steps"]`` counts the augmenting-path steps."""
    b = cost.shape[0]
    dev = cost.device
    iota = torch.arange(b, device=dev)
    inf = float("inf")
    n_valid_cols = int(col_valid.sum())
    desc = torch.sort(torch.where(col_valid, iota, -1), descending=True).values
    u = torch.zeros(b, dtype=torch.float32, device=dev)
    v = torch.zeros(b, dtype=torch.float32, device=dev)
    path = torch.full((b,), -1, dtype=torch.int64, device=dev)
    col4row = torch.full((b,), -1, dtype=torch.int64, device=dev)
    row4col = torch.full((b,), -1, dtype=torch.int64, device=dev)
    for cur in range(b):
        if not bool(row_valid[cur]):
            continue
        min_val = torch.zeros((), dtype=torch.float32, device=dev)
        sr = torch.zeros(b, dtype=torch.bool, device=dev)
        sc = torch.zeros(b, dtype=torch.bool, device=dev)
        spc = torch.full((b,), inf, dtype=torch.float32, device=dev)
        in_rem = col_valid.clone()
        remaining = desc.clone()
        n_rem, i, sink = n_valid_cols, cur, -1
        while sink == -1:
            if stats is not None:
                stats["steps"] = stats.get("steps", 0) + 1
            sr[i] = True
            r_all = min_val + cost[i] - u[i] - v
            upd = in_rem & (r_all < spc)
            spc = torch.where(upd, r_all, spc)
            path = torch.where(upd, i, path)
            pos_ok = iota < n_rem
            rem_c = remaining.clamp(min=0)
            spc_pos = torch.where(pos_ok, spc[rem_c], inf)
            lowest = spc_pos.min()
            if float(lowest) == inf:  # no column left: cannot happen on finite costs
                sink = -2
                break
            ach = pos_ok & (spc_pos == lowest)
            au = ach & (row4col[rem_c] == -1)
            index = int(iota[au].max()) if bool(au.any()) else int(iota[ach].min())
            j = int(remaining[index])
            row_j = int(row4col[j])
            min_val = lowest
            sc[j] = True
            in_rem[j] = False
            n_rem -= 1
            remaining[index] = remaining[n_rem]
            if row_j == -1:
                sink = j
            else:
                i = row_j
        if sink < 0:
            continue
        du = min_val - spc[col4row.clamp(min=0)]
        u = u + torch.where(sr & (iota != cur), du, 0.0)
        u[cur] = u[cur] + min_val
        v = v - torch.where(sc, min_val - spc, 0.0)
        j = sink
        while True:
            r = int(path[j])
            row4col[j] = r
            j, col4row[r] = int(col4row[r]), j
            if r == cur:
                break
    return col4row, row4col


def lsa_masked_reference(cost: torch.Tensor, row_valid: torch.Tensor, col_valid: torch.Tensor,
                         stats: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, on any device: the JAX package's
    ``lsap.lsa_masked`` with its loops on the host. ``stats`` (a dict), if
    given, receives the step count (``_solve_square``)."""
    _count("lsa_masked_reference")
    r_dim, c_dim = cost.shape
    b = max(r_dim, c_dim)
    dev = cost.device
    cost_sq = torch.zeros((b, b), dtype=torch.float32, device=dev)
    cost_sq[:r_dim, :c_dim] = cost
    rv = torch.zeros(b, dtype=torch.bool, device=dev)
    cv = torch.zeros(b, dtype=torch.bool, device=dev)
    rv[:r_dim] = row_valid
    cv[:c_dim] = col_valid
    if int(cv.sum()) < int(rv.sum()):
        row4col, col4row = _solve_square(cost_sq.T.contiguous(), cv, rv, stats)
    else:
        col4row, row4col = _solve_square(cost_sq, rv, cv, stats)
    return col4row[:r_dim].int(), row4col[:c_dim].int()


@functools.lru_cache(maxsize=None)
def _c_function():
    fn = build.load("lsap").stemseg_lsa_masked
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def lsa_masked(cost: torch.Tensor, row_valid: torch.Tensor,
               col_valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of the JAX package's ``lsap.lsa_masked`` (see the module
    docstring): one launch of one warp, no host sync."""
    if cost.device.type == "cpu":
        return lsa_masked_reference(cost, row_valid, col_valid)
    if not (cost.is_cuda and row_valid.is_cuda and col_valid.is_cuda):
        raise ValueError("all inputs must be CUDA tensors")
    if (cost.dtype, row_valid.dtype, col_valid.dtype) != (torch.float32, torch.bool, torch.bool):
        raise TypeError("cost must be float32 and the masks bool")
    r_dim, c_dim = cost.shape
    if row_valid.shape != (r_dim,) or col_valid.shape != (c_dim,) \
            or not (1 <= r_dim <= MAX_SIDE and 1 <= c_dim <= MAX_SIDE):
        raise ValueError(f"unsupported shapes: cost {tuple(cost.shape)} rows "
                         f"{tuple(row_valid.shape)} cols {tuple(col_valid.shape)}")
    cost, row_valid, col_valid = (t.contiguous() for t in (cost, row_valid, col_valid))
    dev = cost.device
    with torch.cuda.device(dev):
        col4row = torch.empty(r_dim, dtype=torch.int32, device=dev)
        row4col = torch.empty(c_dim, dtype=torch.int32, device=dev)
        err = _c_function()(cost.data_ptr(), row_valid.data_ptr(), col_valid.data_ptr(),
                            r_dim, c_dim, col4row.data_ptr(), row4col.data_ptr(),
                            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stemseg_lsa_masked failed to launch: CUDA error {err}")
    _count("lsa_masked")
    return col4row, row4col
