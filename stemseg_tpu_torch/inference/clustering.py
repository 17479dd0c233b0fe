"""Sequential seeded clustering of one window's spatio-temporal embeddings.

``cluster_window`` flattens the window, appends the free dims' fixed
bandwidths ``1 / std^2`` to the learned ones, runs ``ops.cluster_points``
(a CUDA kernel for CUDA tensors, the plain PyTorch version for CPU
tensors) and shifts the cluster slots to globally unique labels starting at
``label_start``. The semantics are the reference ``SequentialClustering``'s
as the JAX package keeps them: sticky stop below ``min_seediness_prob``,
the seed pixel's own bandwidth, ``sqrt`` distance, farthest-cluster
secondary assignment in "reference" mode and the stale availability mask.

``ClusterTimeLog`` (``--profile_clustering``) buckets each call's duration
by its point count, as the reference's ``ClustererBase`` does.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from stemseg_tpu_torch.ops import cluster_points
from stemseg_tpu_torch.utils.device import synchronize


class ClusterTimeLog:
    """Clustering durations (seconds) by point count. Timing a window
    synchronises the device before and after it, so the log is kept only
    when asked for."""

    def __init__(self):
        self._time_log = defaultdict(list)

    def record(self, n_points: int, duration: float) -> None:
        self._time_log[int(n_points)].append(duration)

    @property
    def average_time(self) -> float:
        times = [t for v in self._time_log.values() for t in v]
        return sum(times) / len(times) if times else 0.0

    def summary(self) -> Dict[int, Tuple[int, float]]:
        """{point count: (calls, mean seconds)}, by point count."""
        return {p: (len(v), sum(v) / len(v)) for p, v in sorted(self._time_log.items())}


class ClusterParams(NamedTuple):
    primary_prob_thresh: float = 0.5
    secondary_prob_thresh: float = 0.3
    min_seediness_prob: float = 0.8
    max_instances: int = 20
    n_free_dims: int = 0
    free_dim_stds: Tuple[float, ...] = ()
    secondary_assignment: str = "reference"  # or "nearest"


class ClusterResult(NamedTuple):
    labels: torch.Tensor       # [T, H, W] int32; -1 = bg / unassigned
    centers: torch.Tensor      # [max_instances, E]
    bandwidths: torch.Tensor   # [max_instances, E] (incl. free dims)
    valid: torch.Tensor        # [max_instances] bool
    seed_probs: torch.Tensor   # [max_instances]


def cluster_window(embeddings: torch.Tensor, bandwidths: torch.Tensor,
                   seediness: torch.Tensor, fg_mask: torch.Tensor,
                   params: ClusterParams, label_start: int = 1,
                   time_log: Optional[ClusterTimeLog] = None) -> ClusterResult:
    """:param embeddings: [T, H, W, E] (grid offsets included), any float
        dtype (clustered in float32)
    :param bandwidths: [T, H, W, E - n_free] activated (exp * 10)
    :param seediness: [T, H, W]
    :param fg_mask: [T, H, W] bool
    :param time_log: if given, the call's duration is recorded under its
        point count, between two device synchronisations
    :return: labels [T, H, W], ``label_start + k`` for slot k, -1 elsewhere
    """
    if time_log is None:
        return _cluster_window(embeddings, bandwidths, seediness, fg_mask, params,
                               label_start)
    synchronize(fg_mask.device)
    start = time.perf_counter()
    result = _cluster_window(embeddings, bandwidths, seediness, fg_mask, params, label_start)
    synchronize(fg_mask.device)
    time_log.record(fg_mask.numel(), time.perf_counter() - start)
    return result


def _cluster_window(embeddings, bandwidths, seediness, fg_mask, params: ClusterParams,
                    label_start) -> ClusterResult:
    """``label_start``: an int, or a 0-d integer tensor on the device."""
    shape = fg_mask.shape
    e = embeddings.shape[-1]
    flat_emb = embeddings.reshape(-1, e).float()
    flat_bw = bandwidths.reshape(-1, bandwidths.shape[-1]).float()
    p = flat_emb.shape[0]
    if params.free_dim_stds:
        # filled on the device: no host-to-device copy, so a CUDA graph can
        # hold the call
        free_bw = [torch.full((p, 1), 1.0 / (s * s), dtype=torch.float32, device=flat_bw.device)
                   for s in params.free_dim_stds]
        flat_bw = torch.cat([flat_bw] + free_bw, dim=-1)

    labels, meta = cluster_points(
        flat_emb, flat_bw, seediness.reshape(-1).float(), fg_mask.reshape(-1).bool(),
        e_dims=e, max_instances=params.max_instances,
        primary=params.primary_prob_thresh,
        secondary=params.secondary_prob_thresh,
        min_seediness=params.min_seediness_prob,
        reference_secondary=params.secondary_assignment == "reference")
    k = params.max_instances
    labels = torch.where(labels >= 0, labels + label_start, -1)
    return ClusterResult(labels=labels.reshape(shape), centers=meta[:k, :e],
                         bandwidths=meta[:k, e:2 * e], valid=meta[:k, -1] > 0.5,
                         seed_probs=meta[:k, -2])
