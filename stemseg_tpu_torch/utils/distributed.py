"""Process-level distributed helpers over ``torch.distributed``.

The port's counterpart of the JAX package's ``utils/distributed.py``. There
a process is a host that drives all its local devices; here a process is a
rank that drives one device (``cuda:LOCAL_RANK``, or the CPU), launched by
``torchrun`` (or any launcher that sets its variables). The ranks form the
JAX mesh's "data" axis.

``init_from_env`` reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``. Without ``RANK`` and ``WORLD_SIZE``
nothing is initialised and the world is this one process. The backend is
NCCL for CUDA devices and gloo for the CPU; ``backend`` overrides it (gloo
on CUDA tensors runs two ranks on one GPU, which NCCL refuses).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from stemseg_tpu_torch.utils.device import resolve_device

ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_from_env(device: str = "cuda", backend: Optional[str] = None) -> torch.device:
    """Join the process group the launcher's variables describe and return
    this rank's device: ``cuda:LOCAL_RANK`` for ``device="cuda"``, else
    ``device``; an NCCL group is bound to that card (``device_id``).
    Returns ``resolve_device(device)`` alone when the variables are not
    set. Raises if a CUDA device is asked for and there is none."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return resolve_device(device)
    missing = [k for k in ENV_KEYS if k not in os.environ]
    if missing:
        raise KeyError(f"distributed launch without {missing}")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        # NCCL is bound to the rank's card here, not at its first collective:
        # a barrier before any collective then cannot guess another card
        dist.init_process_group(
            backend,
            init_method=f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}",
            rank=rank, world_size=world, device_id=dev if backend == "nccl" else None)
    return dev


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def is_distributed() -> bool:
    return get_world_size() > 1


def collective_device(device: torch.device) -> torch.device:
    """Where a small tensor for a collective lives: ``device`` on NCCL, the
    CPU on gloo."""
    return device if dist.get_backend() == "nccl" else torch.device("cpu")


def synchronize() -> None:
    """Barrier across the ranks (a no-op without a process group)."""
    if is_initialized():
        dist.barrier()


def all_reduce_ints(values: Sequence[int], device: torch.device,
                    op: str = "sum") -> Tuple[int, ...]:
    """``values`` summed (``op="sum"``) or maximised (``"max"``) element by
    element over the ranks, in one collective; ``values`` themselves
    without a process group."""
    if not is_initialized():
        return tuple(values)
    t = torch.tensor(list(values), dtype=torch.int64, device=collective_device(device))
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op])
    return tuple(int(v) for v in t.tolist())


def pmean_dict(scalars: Dict[str, float]) -> Dict[str, float]:
    """The mean over the ranks of a dict of host scalars (the same keys on
    every rank)."""
    if not is_distributed():
        return dict(scalars)
    keys = sorted(scalars)
    t = torch.tensor([float(scalars[k]) for k in keys], dtype=torch.float64)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    dist.all_reduce(t)
    return {k: float(v) / get_world_size() for k, v in zip(keys, t.tolist())}
