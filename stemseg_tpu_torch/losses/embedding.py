"""Spatio-temporal embedding loss, in the port's channels-first layout.

The same loss as the JAX package's ``losses/embedding.py``, term for term:

* instance centres = masked mean of the raw embeddings;
* bandwidth activation ``exp(b) * 10`` applied per pixel *before* the
  per-instance mean;
* free dims get fixed bandwidths ``1/std²`` appended;
* prob map ``exp(-0.5 Σ (e - c)² · bw)`` over the whole clip;
* Lovász hinge on ``2p - 1`` over all T·H·W pixels, per instance;
* seediness: fg MSE against the detached probs per instance; bg MSE
  against 0 with ignore pixels zeroed but still counted in the mean;
* bandwidth smoothness = masked variance of the *raw* bandwidths, averaged
  over the instances present;
* normalisers: Lovász ÷ total instances, smoothness ÷ batch size N,
  seediness ÷ (total instances + 1); a batch without instances gives 0;
* a sequence without instances adds nothing, not even its bg seediness.

Only the instance rows that have a pixel at the loss's size take part in
the per-instance work, which is what the JAX package's masking amounts to:
it computes every row and zeroes the terms of the empty ones. Which rows
those are is a fact of the targets, known on the host before the step
(``training/loader.py`` finds them while it collates), so the caller hands
them in as ``kept_rows`` and ``kept_counts`` and the loss reads nothing
back from the device. One loop step per sequence; N is 1 per micro-step
on one card.

Data parallel: under the JAX mesh the normalisers are global (total
instances and N over the whole batch). A rank passes ``world_counts``,
which sums (instances, sequences) over the ranks; its terms are then its
own sums over those global normalisers, so the sum of the ranks' terms, and
of their gradients, is the loss of the global batch.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from stemseg_tpu_torch.losses.lovasz import lovasz_hinge
from stemseg_tpu_torch.utils.constants import LossConsts
from stemseg_tpu_torch.utils.profiling import count


class EmbeddingLossParams(NamedTuple):
    embedding_size: int = 3
    n_free_dims: int = 0
    free_dim_stds: Tuple[float, ...] = ()
    weight_lovasz: float = 1.0
    weight_variance_smoothness: float = 10.0
    weight_seediness: float = 1.0
    weight: float = 1.0


def free_bandwidths(params: EmbeddingLossParams, device) -> torch.Tensor:
    """[F] fixed bandwidths ``1/std²`` of the free dims, on ``device``: made
    once, where the loss is set up (a host list copied to a CUDA device
    makes the host wait)."""
    return torch.tensor([1.0 / (s ** 2) for s in params.free_dim_stds],
                        dtype=torch.float32, device=device)


def _per_sequence(emb, bw, seed, masks, ignore, free_bw, rows
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Loss terms of one sequence.

    :param emb: [E, T, H, W] embeddings (grid offset already added)
    :param bw: [V, T, H, W] raw (pre-activation) bandwidths
    :param seed: [T, H, W] seediness
    :param masks: [I, T, H, W] float instance masks, all-zero rows allowed
    :param ignore: [T, H, W] float ignore mask
    :param free_bw: [F] fixed bandwidths of the free dims
    :param rows: [n] the rows of ``masks`` that have a pixel, ascending,
        n > 0
    :return: (lovasz_sum, seediness_sum, smoothness_mean)
    """
    p = seed.numel()
    n = rows.shape[0]
    m = masks.reshape(masks.shape[0], p)
    counts = m.sum(dim=1)
    m, counts = m.index_select(0, rows), counts.index_select(0, rows)
    e_flat, bw_flat, s = emb.reshape(-1, p), bw.reshape(-1, p), seed.reshape(p)
    v = bw_flat.shape[0]

    centers = (m @ e_flat.T) / counts[:, None]  # [n, E]
    bw_mean_act = (m @ (torch.exp(bw_flat) * 10.0).T) / counts[:, None]  # [n, V]
    bw_mean_raw = (m @ bw_flat.T) / counts[:, None]

    sq_dev = (bw_flat[None] - bw_mean_raw[:, :, None]) ** 2  # [n, V, P]
    smooth_i = (m[:, None] * sq_dev).sum(dim=(1, 2)) / (counts * v)
    smoothness = smooth_i.sum() / n

    full_bw = torch.cat([bw_mean_act, free_bw.expand(n, -1)], dim=1)  # [n, E]
    d2 = ((e_flat[None] - centers[:, :, None]) ** 2 * full_bw[:, :, None]).sum(dim=1)
    probs = torch.exp(-0.5 * d2)  # [n, P]

    lovasz_sum = lovasz_hinge(probs * 2.0 - 1.0, m).sum()

    fg_mse = ((m * (s[None] - probs.detach()) ** 2).sum(dim=1) / counts).sum()
    bg = 1.0 - m.amax(dim=0)  # pixels in no instance
    bg_sq = torch.where(ignore.reshape(p) > 0, 0.0, s ** 2)
    bg_mse = (bg * bg_sq).sum() / bg.sum().clamp(min=1.0)
    return lovasz_sum, fg_mse + bg_mse, smoothness


def embedding_loss(embedding_map: torch.Tensor, masks: torch.Tensor,
                   ignore_masks: torch.Tensor, params: EmbeddingLossParams,
                   free_bw: torch.Tensor, kept_rows: torch.Tensor,
                   kept_counts: Sequence[int],
                   world_counts: Optional[Callable[[int, int], Tuple[int, int]]] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batch embedding loss.

    :param embedding_map: [N, C, T, H, W] with C = E + V + 1, channel order
        (emb | var | seed)
    :param masks: [N, I, T, H, W] float instance masks (padded I axis)
    :param ignore_masks: [N, T, H, W] float
    :param free_bw: ``free_bandwidths(params, device)``
    :param kept_rows: [N, I] int64 on the masks' device: sequence i's rows
        of ``masks`` that have a pixel, ascending, in its first
        ``kept_counts[i]`` entries
    :param kept_counts: N host ints, each sequence's count of such rows
    :param world_counts: ``(instances, sequences)`` of this batch -> their
        sums over the data-parallel ranks; None: this batch is the whole one
    :return: (total weighted loss, dict of the three terms)
    """
    e = params.embedding_size
    v = e - params.n_free_dims
    if embedding_map.shape[1] != e + v + 1:
        raise ValueError(f"Expected {e + v + 1} channels, got {embedding_map.shape[1]}")
    count("loss.host_selection", len(kept_counts))

    # a zero that keeps the graph, for a batch without instances
    zero = (embedding_map * 0.0).sum()
    lovasz_sum = seed_sum = smooth_sum = zero
    for i, n in enumerate(kept_counts):
        if n == 0:
            continue
        terms = _per_sequence(embedding_map[i, :e], embedding_map[i, e:e + v],
                              embedding_map[i, e + v], masks[i], ignore_masks[i], free_bw,
                              kept_rows[i, :n])
        lovasz_sum = lovasz_sum + terms[0]
        seed_sum = seed_sum + terms[1]
        smooth_sum = smooth_sum + terms[2]
    total_instances = sum(kept_counts)

    n_sequences = masks.shape[0]
    if world_counts is not None:
        total_instances, n_sequences = world_counts(total_instances, n_sequences)
    if total_instances == 0:
        lovasz = smoothness = seediness = zero
    else:
        lovasz = lovasz_sum / total_instances
        smoothness = smooth_sum / n_sequences
        seediness = seed_sum / (total_instances + 1.0)

    total = (lovasz * params.weight_lovasz
             + smoothness * params.weight_variance_smoothness
             + seediness * params.weight_seediness) * params.weight
    return total, {
        LossConsts.LOVASZ_LOSS: lovasz,
        LossConsts.VARIANCE_SMOOTHNESS: smoothness,
        LossConsts.SEEDINESS_LOSS: seediness,
    }
