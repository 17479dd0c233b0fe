"""Semantic-segmentation losses: multi-class cross entropy and foreground BCE.

The reference's cross entropy reduces ``F.cross_entropy`` to a scalar
*before* multiplying by the non-ignore mask and renormalising by its sum,
so the ignore mask is a no-op there; ``semseg_cross_entropy`` keeps that
plain mean per sequence, as the JAX package's default does. The fg BCE
masks properly: ignore pixels leave both the numerator and the
denominator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def semseg_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_masks: torch.Tensor) -> torch.Tensor:
    """Mean per-sequence cross entropy, averaged over the batch.

    :param logits: [N, num_classes, T, H, W]
    :param labels: [N, T, H, W] integer class ids
    :param ignore_masks: [N, T, H, W] (1 = ignore); a no-op, as in the
        reference
    """
    nll = F.cross_entropy(logits, labels.long(), reduction="none")  # [N, T, H, W]
    return nll.mean(dim=(1, 2, 3)).mean()


def foreground_bce(fg_logits: torch.Tensor, fg_masks: torch.Tensor,
                   ignore_masks: torch.Tensor) -> torch.Tensor:
    """BCE with logits of the foreground channel against (semseg > 0), ignore
    pixels excluded from the per-sequence mean.

    :param fg_logits: [N, T, H, W]
    :param fg_masks: [N, T, H, W] float targets in {0, 1}
    :param ignore_masks: [N, T, H, W]
    """
    bce = F.binary_cross_entropy_with_logits(fg_logits, fg_masks, reduction="none")
    keep = 1.0 - ignore_masks.to(bce.dtype)
    per_seq = (bce * keep).sum(dim=(1, 2, 3)) / keep.sum(dim=(1, 2, 3)).clamp(min=1.0)
    return per_seq.mean()
