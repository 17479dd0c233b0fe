"""Optimizer, LR schedule and gradient clipping, with the JAX package's
``training/optim.py`` semantics:

* weight decay is *coupled* (added to the gradient before the momentum)
  and acts on every trainable parameter, norms and biases included:
  ``torch.optim.SGD(momentum, nesterov, dampening=0, weight_decay)`` is
  ``add_decayed_weights -> trace(nesterov)``; Adam (0.9, 0.999, 1e-8) with
  the same coupled decay is ``add_decayed_weights -> scale_by_adam``;
* frozen parameters (``requires_grad`` False) are left out of the
  optimizer: no update, no decay;
* ``clip_by_global_norm``: the optax form, ``g / norm`` when the global
  norm of the trainable gradients is 1 or more (``clip_grad_norm_`` adds
  1e-6 to the norm, which this does not);
* the LR schedule (``step``, ``exponential``, ``none``) is evaluated at the
  count of optimizer steps taken before the current one: the first update
  uses ``lr(0)``.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List

import torch

CLIP_MAX_NORM = 1.0


def make_lr_factor(tcfg) -> Callable[[int], float]:
    """``step -> lr / initial_lr`` for ``cfg.training``."""
    if tcfg.lr_decay_type == "step":
        boundaries = sorted(int(s) for s in tcfg.lr_decay_steps)
        return lambda step: tcfg.lr_decay_factor ** sum(step >= b for b in boundaries)
    if tcfg.lr_decay_type == "exponential":
        gamma = math.exp(math.log(tcfg.lr_exp_decay_factor) / float(tcfg.lr_exp_decay_steps))
        return lambda step: gamma ** max(step - tcfg.lr_exp_decay_start, 0)
    if tcfg.lr_decay_type == "none":
        return lambda step: 1.0
    raise ValueError(f"Invalid LR decay type {tcfg.lr_decay_type!r}")


def trainable_parameters(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    return [p for p in model.parameters() if p.requires_grad]


def make_optimizer(tcfg, params: Iterable[torch.nn.Parameter]):
    """(optimizer, scheduler) over ``params`` (the trainable ones)."""
    params = list(params)
    kind = tcfg.optimizer.lower()
    if kind == "sgd":
        opt = torch.optim.SGD(params, lr=tcfg.initial_lr, momentum=tcfg.momentum,
                              dampening=0.0, weight_decay=tcfg.weight_decay,
                              nesterov=tcfg.nesterov)
    elif kind == "adam":
        opt = torch.optim.Adam(params, lr=tcfg.initial_lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=tcfg.weight_decay)
    else:
        raise ValueError(f"Invalid optimizer choice {tcfg.optimizer!r}")
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, make_lr_factor(tcfg))


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of all elements (optax ``global_norm``)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t) for t in tensors]))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float = CLIP_MAX_NORM) -> None:
    """In place: each gradient becomes ``g / norm * max_norm`` when the global
    norm is ``max_norm`` or more, as optax's ``clip_by_global_norm``."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)
