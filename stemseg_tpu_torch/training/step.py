"""The train step: forward, losses, gradient, and an optimizer update every
``accumulate_steps`` micro-steps.

The same composition as the JAX package's ``training/step.py``:

* ``prepare_targets``: masks and ignore masks ÷4 by bilinear resize
  without antialiasing, then ``>= 1 - 1e-5`` (the reference's ``.byte()``
  truncation: a pixel stays set only where its whole neighbourhood is);
  the semseg label map is the per-pixel max of the covering instances'
  category ids;
* ``make_output_loss_fn``: embedding loss, plus fg BCE and cross entropy
  with a semseg head; metric keys ``LossConsts`` + ``total``; the model's
  outputs (bfloat16 under ``training.mixed_precision``) are cast to
  float32 first, so targets and losses are float32;
* ``TrainStep``: gradients are averaged over the micro-steps with the
  running mean of ``optax.MultiSteps`` (``acc + (g - acc) / (k + 1)``);
  clipping, weight decay and the LR act on that mean at the update;
  ``grad_norm`` is each micro-step's own gradient norm.

Data parallel (a process group is initialised): each rank's loss terms are
its share of the global batch's, so that their sum over the ranks is the
loss of the global batch. The embedding loss takes the global instance
count and batch size (``world_counts``, one small all-reduce a micro-step);
the semseg CE and the fg BCE are means of per-sequence terms, so with
equal per-rank batches the global mean is the mean of the ranks' means,
and each rank's is divided by the world size. Each micro-step's gradient
is summed over the ranks right after ``torch.autograd.grad``, together with
the loss terms, before its norm and the running mean: as JAX's ``psum``
inside each micro-step, before ``optax.MultiSteps`` averages them. So
``grad_norm`` and the logged terms are the global batch's. The heads use
FrozenBN and GroupNorm only: no batch statistics need syncing.

Tracing (``utils.profiling``, while a profiler records): a micro-step is
the span ``step`` (its id the micro-step's number, counted from 1) around
``step.forward``, ``step.loss``, ``step.backward``, ``step.all_reduce``
(with a process group), ``step.accumulate`` (the gradient's norm and its
running mean) and ``step.update`` (when the update is due), each also
timed on the CUDA stream.

Batch contract (device tensors): ``images`` [N, T, H, W, 3] float32,
normalised, padded to /32; ``masks`` [N, I, T, H, W] uint8 (padded
instance axis); ``ignore_masks`` [N, T, H, W] uint8; ``category_ids``
[N, I] int32 (0 for padding). Masks become float32 on the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from stemseg_tpu_torch.losses import (
    EmbeddingLossParams,
    embedding_loss,
    foreground_bce,
    semseg_cross_entropy,
)
from stemseg_tpu_torch.models.embedding_utils import get_nb_free_dims
from stemseg_tpu_torch.models.layers import resize_bilinear
from stemseg_tpu_torch.parallel import all_reduce_sum_
from stemseg_tpu_torch.training.optim import clip_by_global_norm_, global_norm
from stemseg_tpu_torch.utils.constants import LossConsts
from stemseg_tpu_torch.utils.distributed import all_reduce_ints, get_world_size, is_initialized
from stemseg_tpu_torch.utils.profiling import span


def _downscale_binary(x: torch.Tensor, scale: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    return (resize_bilinear(x, (h // scale, w // scale)) >= 1.0 - 1e-5).to(x.dtype)


def semseg_labels(masks: torch.Tensor, category_ids: torch.Tensor) -> torch.Tensor:
    """[N, I, T, H, W] masks, [N, I] ids -> [N, T, H, W] int64 label map."""
    cats = category_ids[:, :, None, None, None].to(masks.dtype)
    return (masks * cats).amax(dim=1).long()


def prepare_targets(masks: torch.Tensor, ignore_masks: torch.Tensor,
                    category_ids: torch.Tensor, scale: int = 4):
    """Float masks [N, I, T, H, W] and ignore masks [N, T, H, W] ÷``scale``,
    and the label map at that size."""
    masks_ds = _downscale_binary(masks, scale)
    ignore_ds = _downscale_binary(ignore_masks, scale)
    return masks_ds, ignore_ds, semseg_labels(masks_ds, category_ids)


def make_output_loss_fn(cfg, world_counts: Optional[Callable] = None,
                        world_size: int = 1) -> Callable:
    """The loss composition after the network forward: ``(out, batch) ->
    (total, metrics)``.

    :param world_counts: the embedding loss's sum of (instances, sequences)
        over the data-parallel ranks; None for one process
    :param world_size: the ranks; the CE and fg BCE are divided by it"""
    lcfg = cfg.training.losses
    emb_params = EmbeddingLossParams(
        embedding_size=cfg.model.embeddings.embedding_size,
        n_free_dims=get_nb_free_dims(cfg.model.embedding_dim_mode),
        free_dim_stds=tuple(lcfg.embedding.free_dim_stds),
        weight_lovasz=lcfg.embedding.weight_lovasz,
        weight_variance_smoothness=lcfg.embedding.weight_variance_smoothness,
        weight_seediness=lcfg.embedding.weight_seediness,
        weight=lcfg.embedding.weight,
    )
    # loss_at_full_res upscales the outputs 4x, so the targets stay full size
    target_scale = 1 if cfg.training.loss_at_full_res else 4
    use_semseg = cfg.model.use_semseg_head
    fg_channel = cfg.model.semseg.foreground_channel

    def output_loss_fn(out, batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        masks = batch["masks"].float()
        ignore = batch["ignore_masks"].float()
        if target_scale > 1:
            masks, ignore, labels = prepare_targets(masks, ignore, batch["category_ids"],
                                                    target_scale)
        else:
            labels = semseg_labels(masks, batch["category_ids"])

        total, metrics = embedding_loss(out["embeddings"].float(), masks, ignore, emb_params,
                                        world_counts=world_counts)
        metrics[LossConsts.EMBEDDING] = total
        if use_semseg:
            logits = out["semseg_masks"].float()
            if fg_channel:
                logits, fg_logits = logits[:, :-1], logits[:, -1]
                fg = foreground_bce(fg_logits, (labels > 0).float(), ignore) / world_size
                total = total + fg
                metrics[LossConsts.FOREGROUND] = fg
            ce = semseg_cross_entropy(logits, labels, ignore) / world_size
            total = total + ce * lcfg.weight_semseg
            metrics[LossConsts.SEMSEG] = ce
        metrics["total"] = total
        return total, metrics

    return output_loss_fn


class TrainStep:
    """One micro-step per call: forward, losses, this micro-step's gradient
    (``torch.autograd.grad``, so that its own norm can be taken), folded
    into the running mean in ``.grad``; after ``accumulate_steps`` calls,
    clip (``training.clip_gradients``), ``optimizer.step()``,
    ``scheduler.step()`` and clear the gradients. Returns the micro-step's
    metrics as 0-d device tensors. With a process group initialised, the
    gradient and the metrics are summed over the ranks (module docstring)."""

    def __init__(self, model, cfg, optimizer, scheduler, accumulate_steps: int = 1):
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.accumulate_steps = accumulate_steps
        self.params = [p for group in optimizer.param_groups for p in group["params"]]
        self.distributed = is_initialized()
        if self.distributed:
            device = next(model.parameters()).device
            self.loss_fn = make_output_loss_fn(
                cfg, world_counts=lambda *counts: all_reduce_ints(counts, device),
                world_size=get_world_size())
        else:
            self.loss_fn = make_output_loss_fn(cfg)
        self.clip = cfg.training.clip_gradients
        self.micro_step = 0
        self.calls = 0  # micro-steps run, the ``step`` spans' ids
        self.cuda = bool(self.params) and self.params[0].is_cuda

    def accumulate(self, grads) -> None:
        k = self.micro_step
        with torch.no_grad():
            for p, g in zip(self.params, grads):
                if k == 0:
                    p.grad = g
                else:
                    p.grad.add_((g - p.grad) / (k + 1))
        self.micro_step += 1

    def update(self) -> None:
        """The optimizer update on the averaged gradient, when it is due."""
        if self.micro_step < self.accumulate_steps:
            return
        if self.clip:
            with torch.no_grad():
                clip_by_global_norm_([p.grad for p in self.params])
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.micro_step = 0

    def __call__(self, batch) -> Dict[str, torch.Tensor]:
        self.calls += 1
        cuda = self.cuda
        with span("step", ident=self.calls):
            with span("step.forward", device=cuda):
                out = self.model(batch["images"].permute(0, 1, 4, 2, 3))
            with span("step.loss", device=cuda):
                total, metrics = self.loss_fn(out, batch)
            with span("step.backward", device=cuda):
                grads = torch.autograd.grad(total, self.params, allow_unused=True,
                                            materialize_grads=True)
            metrics = {k: v.detach() for k, v in metrics.items()}
            if self.distributed:  # (terms may share storage: "total" is the embedding loss's)
                with span("step.all_reduce", device=cuda):
                    metrics = {k: v.clone() for k, v in metrics.items()}
                    all_reduce_sum_([*grads, *metrics.values()])
            with span("step.accumulate", device=cuda):
                metrics["grad_norm"] = global_norm(grads)
                self.accumulate(grads)
            if self.micro_step >= self.accumulate_steps:
                with span("step.update", device=cuda):
                    self.update()
            return metrics
