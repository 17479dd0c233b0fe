"""Deterministic samplers: an epoch-seeded permutation sliced per replica,
batching, and iteration-based batching with resume, as in the JAX
package's ``data/samplers.py`` (the same numpy ``default_rng(epoch)``
stream, so both trainers see the same indices); and the seed of each
sample of a dataset stream.

One difference: a resumed ``IterationBasedBatchSampler`` continues the
stream an uninterrupted run would have seen (the pass that ``start_iter``
falls in, reseeded as that pass was, with its first batches skipped). The
JAX package's, like the reference's, starts a new pass reseeded with
``start_iter``, so its resumed runs see other batches than its
uninterrupted ones.
"""

from __future__ import annotations

import math
import random
from typing import Iterator, List, Tuple

import numpy as np


def sample_seed(seed: int, index: int) -> int:
    """The seed of sample ``index`` of a dataset stream seeded with ``seed``
    (the synthetic clips' formula): each sample draws only from generators
    made from it, so a sample does not depend on which worker process builds
    it, nor on the samples built before it."""
    return (seed * 1_000_003 + index) % (2 ** 31 - 1)


def sample_generators(seed: int, index: int) -> Tuple[random.Random, np.random.RandomState]:
    """The ``random.Random`` and ``np.random.RandomState`` of sample
    ``index``, both seeded with ``sample_seed(seed, index)``: the state that
    ``random.seed`` and ``np.random.seed`` give the global generators."""
    s = sample_seed(seed, index)
    return random.Random(s), np.random.RandomState(s)


class ShardedSampler:
    """Epoch-seeded permutation, padded to a multiple of ``num_replicas``,
    this replica's slice. ``set_epoch`` reseeds (the iteration-based wrapper
    calls it once per outer pass)."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0):
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} outside [0, {num_replicas})")
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(dataset_len / num_replicas))
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        indices = np.random.default_rng(self.epoch).permutation(self.dataset_len).tolist()
        indices += indices[: (self.total_size - len(indices))]
        offset = self.num_samples * self.rank
        return iter(indices[offset:offset + self.num_samples])

    def __len__(self):
        return self.num_samples


class BatchSampler:
    """Consecutive batches of ``batch_size`` indices; a last short batch is
    dropped."""

    def __init__(self, sampler, batch_size: int):
        self.sampler = sampler
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[List[int]]:
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []

    def __len__(self):
        return len(self.sampler) // self.batch_size


class IterationBasedBatchSampler:
    """Yields exactly ``num_iterations - start_iter`` batches, re-iterating
    the wrapped batch sampler and setting its epoch to the iteration at
    which each outer pass starts. From ``start_iter`` it yields what an
    uninterrupted run yields from that iteration on."""

    def __init__(self, batch_sampler: BatchSampler, num_iterations: int,
                 start_iter: int = 0):
        self.batch_sampler = batch_sampler
        self.num_iterations = num_iterations
        self.start_iter = start_iter

    def __iter__(self) -> Iterator[List[int]]:
        per_pass = len(self.batch_sampler)
        if per_pass == 0:
            return
        iteration = self.start_iter - self.start_iter % per_pass  # start of its pass
        while iteration < self.num_iterations:
            if hasattr(self.batch_sampler.sampler, "set_epoch"):
                self.batch_sampler.sampler.set_epoch(iteration)
            for batch in self.batch_sampler:
                iteration += 1
                if iteration > self.num_iterations:
                    return
                if iteration > self.start_iter:
                    yield batch

    def __len__(self):
        return self.num_iterations
