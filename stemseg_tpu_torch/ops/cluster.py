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
launches its kernel or raises. ``cluster_points_single`` keeps the window
in shared memory and raises above ``on_chip_capacity``;
``cluster_points_tiled`` takes any window up to ``TILED_POINT_LIMIT``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from stemseg_tpu_torch.ops import build, launches

K_PAD = 32
META_COLS = 128
VMEM_BUDGET_BYTES = 14 * 1024 * 1024
TILED_POINT_LIMIT = 16 * 1024 * 1024
MAX_E_DIMS = 8
# the CUDA kernels' shared-memory layout, as csrc/cluster.cu sizes it (its
# stemseg_cluster_capacity; chip_smoke.py holds the two equal): a fixed
# part, the streaming kernels' ring of 4 stages x 1024 threads x (E + 1)
# floats, and bytes per point kept on chip
FIXED_SMEM = 4096
RING_BYTES_PER_COLUMN = 4 * 1024 * 4

# launches per wrapper, as executions on the device (a CUDA graph's count
# at each replay: ``ops.launches``); the plain version counts its calls
launch_counts = {"cluster_points_single": 0, "cluster_points_tiled": 0,
                 "cluster_points_reference": 0}


def _count(name: str) -> None:
    launches.bump(launch_counts, name)


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
    _count("cluster_points_reference")
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


def on_chip_capacity(e_dims: int, resident: bool, n_sms: int, smem_per_block: int) -> int:
    """Most points whose per-point part the kernels keep in shared memory
    on a card with ``n_sms`` SMs and ``smem_per_block`` bytes a block may
    opt in to, one block per SM beside a fixed part of ``FIXED_SMEM``
    bytes. ``resident``: ``cluster_points_single``'s window, its embeddings
    (E f32) and seediness (f32) with the 9-byte state (best distance, best
    cluster, two list entries). Else ``cluster_points_tiled``'s state
    beside its cp.async ring; beyond it the state lives in a global scratch
    buffer of 13 bytes a point."""
    ring = 0 if resident else RING_BYTES_PER_COLUMN * (e_dims + 1)
    per_point = 4 * e_dims + 13 if resident else 9
    return n_sms * max(0, (smem_per_block - FIXED_SMEM - ring) // per_point)


_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SINGLE_ARGS = (_PTR,) * 7 + (_INT,) * 3 + (_FLOAT,) * 3 + (_INT, _PTR)
_TILED_ARGS = (_PTR,) * 8 + _SINGLE_ARGS[7:]
COUNTER_BYTES = 16  # the workspace's launch counter (csrc/cluster_exchange.cuh)


@functools.lru_cache(maxsize=None)
def _c_function(symbol: str, argtypes: tuple, restype=ctypes.c_int):
    fn = getattr(build.load("cluster"), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


@functools.lru_cache(maxsize=None)
def device_limits(index: int) -> Tuple[int, int]:
    """(SM count, shared memory a block may opt in to) of CUDA device
    ``index``."""
    sms, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _c_function("stemseg_cluster_limits", (_PTR, _PTR))(
            ctypes.addressof(sms), ctypes.addressof(smem))
    if err != 0:
        raise RuntimeError(f"device attributes: CUDA error {err}")
    return sms.value, smem.value


def library_capacity(e_dims: int, resident: bool, n_sms: int, smem_per_block: int) -> int:
    """``on_chip_capacity`` as the CUDA library computes it for its
    launches (builds the library)."""
    return _c_function("stemseg_cluster_capacity", (_INT,) * 4, ctypes.c_longlong)(
        e_dims, int(resident), n_sms, smem_per_block)


_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


def _records(index: int, stream: int) -> torch.Tensor:
    """Workspace of the kernels' record exchange on CUDA device ``index``
    and stream ``stream``: the launch counter, then a record of 16 (E + 1)
    bytes per block and iteration parity, and two decisions, at E = 8.
    Zeroed once and kept for the process, so that it holds nothing but zeros
    and the words these kernels wrote, as their exchange requires
    (csrc/cluster_exchange.cuh). A launch captured into a CUDA graph keeps
    the workspace of its capture stream; a workspace allocated during a
    capture would come from the graph's pool and be zeroed at every replay,
    so ``prepare_records`` must have made it before."""
    key = (index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the clustering kernels' workspace of the capture stream must "
                               "exist before the capture (ops.cluster.prepare_records)")
        sms = device_limits(index)[0]
        ws = torch.zeros(COUNTER_BYTES + (2 * sms + 2) * 16 * (MAX_E_DIMS + 1),
                         dtype=torch.uint8, device=torch.device("cuda", index))
        _workspaces[key] = ws
    return ws


def prepare_records(stream: torch.cuda.Stream) -> None:
    """Allocates the workspace of ``stream`` (on its device) now, outside
    any capture: call it before capturing the clustering on ``stream``."""
    with torch.cuda.stream(stream):
        _records(stream.device.index, stream.cuda_stream)


def _launch(resident: bool, emb, bw, seed, fg, *, e_dims, max_instances, primary,
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
    sms, smem = device_limits(dev.index)
    if resident and p > on_chip_capacity(e_dims, True, sms, smem):
        raise ValueError(f"cluster_points_single: P={p} exceeds the on-chip capacity "
                         f"{on_chip_capacity(e_dims, True, sms, smem)} at E={e_dims}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        labels = torch.empty(p, dtype=torch.int32, device=dev)
        meta = torch.empty(K_PAD, META_COLS, dtype=torch.float32, device=dev)
        ptrs = [t.data_ptr() for t in (emb, bw, seed, fg, labels, meta,
                                       _records(dev.index, stream))]
        if not resident:
            state = (torch.empty(13 * p, dtype=torch.uint8, device=dev)
                     if p > on_chip_capacity(e_dims, False, sms, smem) else None)
            ptrs.append(None if state is None else state.data_ptr())
        fn = _c_function("stemseg_cluster_single" if resident else "stemseg_cluster_tiled",
                         _SINGLE_ARGS if resident else _TILED_ARGS)
        err = fn(*ptrs, p, e_dims, max_instances, primary, secondary, min_seediness,
                 int(bool(reference_secondary)), stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed to launch: CUDA error {err}")
    return labels, meta


def sync_floor(n_points: int, iterations: int) -> None:
    """Launches the clustering kernels' synchronisation alone, on the
    current CUDA device and the grid the kernels use for ``n_points``:
    ``iterations`` block reductions, record exchanges and decodes at E = 4
    with no point work. A measuring aid (the kernels' latency floor); the
    clustering never calls it."""
    index = torch.cuda.current_device()
    stream = torch.cuda.current_stream(index).cuda_stream
    out = torch.empty(1, dtype=torch.int64, device=index)
    err = _c_function("stemseg_cluster_sync_floor", (_PTR, _PTR, _INT, _INT, _PTR))(
        _records(index, stream).data_ptr(), out.data_ptr(), n_points, iterations, stream)
    if err != 0:
        raise RuntimeError(f"stemseg_cluster_sync_floor failed to launch: CUDA error {err}")


def cluster_points_single(emb, bw, seed, fg, **kwargs):
    """Counterpart of ``_cluster_kernel``: one persistent cooperative launch
    with the window's points and state in shared memory. Raises when the
    window exceeds ``on_chip_capacity``."""
    if emb.device.type == "cpu":
        return cluster_points_reference(emb, bw, seed, fg, **kwargs)
    out = _launch(True, emb, bw, seed, fg, **kwargs)
    _count("cluster_points_single")
    return out


def cluster_points_tiled(emb, bw, seed, fg, **kwargs):
    """Counterpart of ``_cluster_kernel_tiled``: one persistent cooperative
    launch that streams the points on every sweep."""
    if emb.device.type == "cpu":
        return cluster_points_reference(emb, bw, seed, fg, **kwargs)
    out = _launch(False, emb, bw, seed, fg, **kwargs)
    _count("cluster_points_tiled")
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
