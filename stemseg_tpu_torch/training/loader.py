"""The training loader and the copy of each batch to the device.

``make_data_loader`` is a ``torch.utils.data.DataLoader`` over the port's
batch sampler and ``collate_fn``: worker processes build the collated
batches ahead of the step, in sampler order, and a worker's exception is
raised in the trainer. ``collate_batch`` hands ``DEVICE_KEYS`` over as
tensors, so that ``pin_memory`` page-locks them and ``to_device`` copies
them with ``non_blocking=True`` on the current stream.

The workers also find which instance rows the embedding loss keeps (those
with a pixel at the loss's size, ``step.kept_rows``), from the host's copy
of the masks: ``kept_rows`` travels with the other device keys and
``kept_counts`` stays on the host, so the step never reads them back.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.data import DataLoader

from stemseg_tpu_torch.data.collate import collate_fn
from stemseg_tpu_torch.training.step import kept_rows

DEVICE_KEYS = ("images", "masks", "ignore_masks", "category_ids", "kept_rows")


def kept_instances(masks: np.ndarray, scale: int, filled: Optional[Sequence[int]] = None
                   ) -> Tuple[np.ndarray, List[int]]:
    """Each sequence's rows of ``masks`` [N, I, T, H, W] that keep a pixel at
    the loss's ``scale`` (``step.kept_rows``): [N, I] int64 with those rows
    first, ascending, then zeros; and their N counts.

    :param filled: each sequence's count of rows that the collate filled;
        the rows after them are padding and are not read (None: all rows)
    """
    rows = np.zeros(masks.shape[:2], np.int64)
    counts = []
    for i in range(masks.shape[0]):
        kept = kept_rows(masks[i] if filled is None else masks[i, :filled[i]], scale)
        rows[i, :len(kept)] = kept
        counts.append(len(kept))
    return rows, counts


def loader_batch(batch: Dict[str, np.ndarray], scale: int,
                 filled: Optional[Sequence[int]] = None) -> dict:
    """A collated batch (``collate_fn``'s numpy arrays) as the loader hands
    it over: ``DEVICE_KEYS`` as tensors, ``kept_rows`` among them, and
    ``kept_counts`` (``kept_instances``)."""
    rows, counts = kept_instances(batch["masks"], scale, filled)
    batch = dict(batch, kept_rows=rows, kept_counts=counts)
    for k in DEVICE_KEYS:
        batch[k] = torch.from_numpy(batch[k])
    return batch


def collate_batch(samples: List[dict], max_instances: int, scale: int,
                  overflow: str = "ignore") -> dict:
    """``collate_fn`` as ``loader_batch`` hands it over.

    :param scale: the loss's targets' downscale (``step.target_scale``)"""
    batch = collate_fn(samples, max_instances, overflow=overflow)
    return loader_batch(batch, scale,
                        filled=[min(len(s["masks"]), max_instances) for s in samples])


def make_data_loader(dataset, batch_sampler, max_instances: int, scale: int,
                     overflow: str = "ignore", num_workers: int = 4,
                     pin_memory: bool = False) -> DataLoader:
    """:param batch_sampler: iterable of index lists (e.g.
    ``IterationBasedBatchSampler``)
    :param scale: the loss's targets' downscale (``step.target_scale``)
    :param num_workers: worker processes; 0 builds each batch in the caller
    """
    return DataLoader(dataset, batch_sampler=batch_sampler,
                      collate_fn=partial(collate_batch, max_instances=max_instances,
                                         scale=scale, overflow=overflow),
                      num_workers=num_workers, pin_memory=pin_memory)


def to_device(batch: dict, device: torch.device) -> dict:
    """``DEVICE_KEYS`` copied to ``device`` with ``non_blocking=True``, and
    ``kept_counts`` as host ints."""
    out = {k: batch[k].to(device, non_blocking=True) for k in DEVICE_KEYS}
    out["kept_counts"] = tuple(batch["kept_counts"])
    return out
