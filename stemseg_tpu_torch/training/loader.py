"""The training loader and the copy of each batch to the device.

``make_data_loader`` is a ``torch.utils.data.DataLoader`` over the port's
batch sampler and ``collate_fn``: worker processes build the collated
batches ahead of the step, in sampler order, and a worker's exception is
raised in the trainer. ``collate_batch`` hands ``DEVICE_KEYS`` over as
tensors, so that ``pin_memory`` page-locks them and ``to_device`` copies
them with ``non_blocking=True`` on the current stream.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, List

import torch
from torch.utils.data import DataLoader

from stemseg_tpu_torch.data.collate import collate_fn

DEVICE_KEYS = ("images", "masks", "ignore_masks", "category_ids")


def collate_batch(samples: List[dict], max_instances: int, overflow: str = "ignore") -> dict:
    """``collate_fn`` with ``DEVICE_KEYS`` as tensors."""
    batch = collate_fn(samples, max_instances, overflow=overflow)
    for k in DEVICE_KEYS:
        batch[k] = torch.from_numpy(batch[k])
    return batch


def make_data_loader(dataset, batch_sampler, max_instances: int, overflow: str = "ignore",
                     num_workers: int = 4, pin_memory: bool = False) -> DataLoader:
    """:param batch_sampler: iterable of index lists (e.g.
    ``IterationBasedBatchSampler``)
    :param num_workers: worker processes; 0 builds each batch in the caller
    """
    return DataLoader(dataset, batch_sampler=batch_sampler,
                      collate_fn=partial(collate_batch, max_instances=max_instances,
                                         overflow=overflow),
                      num_workers=num_workers, pin_memory=pin_memory)


def to_device(batch: dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: batch[k].to(device, non_blocking=True) for k in DEVICE_KEYS}
