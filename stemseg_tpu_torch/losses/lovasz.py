"""Lovász hinge loss (Berman 2018), batched over rows.

``lovasz_hinge(logits [I, P], labels [I, P]) -> [I]``: one binary Lovász
hinge per row. Errors ``1 - logits * signs`` are sorted in descending order
with a STABLE sort: ties keep index order, as the JAX package's
``lax.sort`` does, and the gradient depends on how ties are ordered (the
value does not). The Jaccard weights come from two cumulative sums of the
sorted labels; those sums are of 0/1 floats and exact below 2**24 points.

The backward is written out, as the JAX package's ``custom_vjp``:
``d loss / d logits_i = g * 1[errors_i > 0] * w[rank(i)] * (-signs_i)``
with the permutation held constant; ``w[rank(i)]`` is the Jaccard weight
scattered back through the permutation. Labels get no gradient.
"""

from __future__ import annotations

import torch


def lovasz_grad_from_sorted(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension with respect to the sorted errors.
    ``gt_sorted``: ``[..., P]`` 0/1 floats ordered by descending error."""
    gts = gt_sorted.sum(dim=-1, keepdim=True)
    intersection = gts - gt_sorted.cumsum(dim=-1)
    union = gts + (1.0 - gt_sorted).cumsum(dim=-1)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)


class LovaszHinge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        labels = labels.to(logits.dtype)
        signs = 2.0 * labels - 1.0
        errors = 1.0 - logits * signs
        errors_sorted, perm = torch.sort(errors, dim=-1, descending=True, stable=True)
        grad = lovasz_grad_from_sorted(labels.gather(-1, perm))
        ctx.save_for_backward(signs, errors, perm, grad)
        return (torch.relu(errors_sorted) * grad).sum(dim=-1)

    @staticmethod
    def backward(ctx, g):
        signs, errors, perm, grad = ctx.saved_tensors
        w = torch.empty_like(grad).scatter_(-1, perm, grad)  # w[perm[j]] = grad[j]
        # relu' at exactly 0 is 0
        d_logits = g[..., None] * torch.where(errors > 0, w, 0.0) * (-signs)
        return d_logits, None


def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """:param logits: ``[..., P]`` float logits
    :param labels: ``[..., P]`` 0/1 labels (float or int)
    :return: ``[...]`` one loss per row"""
    return LovaszHinge.apply(logits, labels)
