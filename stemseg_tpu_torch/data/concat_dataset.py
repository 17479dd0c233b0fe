"""Weighted mixing of training datasets, the JAX package's
``data/concat_dataset.py``. Dataset ``i`` gets ``round(weight_i * total)``
samples: a larger dataset is cut to that many through a ``SparseDataset``
(a seed-42 shuffle of its indices), a smaller one is repeated
``floor(quota / len)`` times plus linspace-rounded indices for the rest.

Sample ``index`` of the mix is built from generators made from
``sample_seed(seed, index)`` (``data/samplers.py``) and from nothing else,
so the stream does not depend on the worker processes that build it, and a
resumed run sees the samples of an uninterrupted one.
"""

from __future__ import annotations

import math
import random
from typing import List, Sequence

import numpy as np

from stemseg_tpu_torch.data.samplers import sample_generators


class SparseDataset:
    def __init__(self, dataset, num_samples: int):
        if not num_samples < len(dataset):
            raise ValueError(f"SparseDataset takes fewer than the dataset's {len(dataset)} "
                             f"samples, not {num_samples}")
        self.dataset = dataset
        self.num_samples = num_samples
        rng = random.Random(42)
        self.idxes = list(range(len(dataset)))
        rng.shuffle(self.idxes)

    def __len__(self):
        return self.num_samples

    def get(self, index, rng, np_rng):
        return self.dataset.get(self.idxes[index], rng, np_rng)


class ConcatDataset:
    def __init__(self, datasets: Sequence, total_samples: int, weights: List[float],
                 seed: int):
        if abs(sum(weights) - 1.0) >= 1e-6:
            raise ValueError(f"Sum of weights is {sum(weights)}. Should be 1")

        self.seed = seed
        self.id_mapping = []
        self.samples_per_dataset = []
        wrapped = []
        for i, (wt, ds) in enumerate(zip(weights, datasets)):
            if not 0.0 < wt <= 1.0:
                raise ValueError(f"weight {wt} of dataset {i} outside (0, 1]")
            quota = int(round(wt * total_samples))
            if quota == 0:
                raise ValueError(f"dataset {i} (weight {wt}) gets no sample of "
                                 f"{total_samples}")
            if quota < len(ds):
                ds = SparseDataset(ds, quota)
            wrapped.append(ds)

            idxes = list(range(len(ds))) * int(math.floor(quota / float(len(ds))))
            n_rem = quota - len(idxes)
            if n_rem > 0:
                idxes += np.round(np.linspace(0, len(ds) - 1, n_rem)).astype(int).tolist()
            self.id_mapping.extend((i, j) for j in idxes)
            self.samples_per_dataset.append(quota)

        self.datasets = wrapped
        self.weights = weights
        if len(self.id_mapping) != total_samples:
            raise ValueError(f"the quotas {self.samples_per_dataset} add up to "
                             f"{len(self.id_mapping)}, not {total_samples}")

    def __len__(self):
        return len(self.id_mapping)

    def __getitem__(self, index):
        ds_idx, sample_idx = self.id_mapping[index]
        return self.datasets[ds_idx].get(sample_idx, *sample_generators(self.seed, index))
