"""The data-parallel layout over ``torch.distributed``.

The port's counterpart of the JAX package's ``parallel/mesh.py``. There one
controller shards the batch over a 1-D "data" mesh of devices and keeps the
parameters replicated; XLA compiles the gradient ``psum`` into the step.
Here each rank of the process group holds one device, a replica of the
model and its slice of the global batch, and the step all-reduces the
gradients itself (``training/step.py``). The model is not wrapped in
``DistributedDataParallel``: its reducer fires as ``.grad`` accumulates,
while the train step takes each micro-step's gradient with
``torch.autograd.grad`` to know its norm.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import torch
import torch.distributed as dist

from stemseg_tpu_torch.utils.distributed import get_world_size, is_initialized
from stemseg_tpu_torch.utils.profiling import span


def replicate(model: torch.nn.Module) -> None:
    """Broadcast ``model``'s parameters and buffers from rank 0, in place.
    Raises on a rank whose values differed from rank 0's, since replicas
    must start equal (every rank builds the model from the same seed and
    restores the same checkpoint). A no-op without a process group."""
    if not is_initialized() or get_world_size() == 1:
        return
    tensors = [t for t in (*model.parameters(), *model.buffers())]
    before = [t.detach().clone() for t in tensors]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)
    differ = [name for (name, _), t, b in zip(
        (*model.named_parameters(), *model.named_buffers()), tensors, before)
        if not torch.equal(t, b)]
    if differ:
        raise RuntimeError(f"rank {dist.get_rank()}: {len(differ)} tensors differ from "
                           f"rank 0's, the first {differ[0]}")


def shard_batch(global_indices: Sequence[int], rank: int, world: int) -> List[int]:
    """This rank's slice of a global batch of ``world * per_rank`` indices:
    rank ``r`` takes ``[r * per_rank, (r + 1) * per_rank)``, as the JAX
    mesh hands device ``r`` its rows."""
    n = len(global_indices)
    if n % world:
        raise ValueError(f"a global batch of {n} does not split over {world} ranks")
    per_rank = n // world
    return list(global_indices[rank * per_rank:(rank + 1) * per_rank])


def all_reduce_sum_(tensors: Iterable[torch.Tensor]) -> None:
    """Sum ``tensors`` over the ranks, in place: per dtype one flat bucket
    (one ``torch.cat``, the span ``all_reduce.pack``), one
    ``dist.all_reduce`` (``all_reduce.exchange``), and a copy back
    (``all_reduce.unpack``). A no-op without a process group."""
    if not is_initialized():
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            with span("all_reduce.pack"):
                flat = torch.cat([t.reshape(-1) for t in group])
            with span("all_reduce.exchange"):
                dist.all_reduce(flat)
            with span("all_reduce.unpack"):
                offset = 0
                for t in group:
                    t.copy_(flat[offset:offset + t.numel()].view_as(t))
                    offset += t.numel()
