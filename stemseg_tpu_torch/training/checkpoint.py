"""Whole-session checkpoints: save, restore, auto-resume, retention.

A checkpoint is ``{iter:06d}.pth`` in the model dir, a ``torch.save`` of
``{"model": state_dict, "optimizer", "scheduler", "step", "extra"}``.
``"model"`` is the key that ``models/weights.py:load_state_dict_file``
reads, so the inference CLI loads a trained checkpoint as it is. Files are
read with ``weights_only=True``. ``cleanup_old_checkpoints`` keeps the
newest ``keep`` files (the reference's glob never matched, so it kept all).
A session of the JAX package's trainer (a ``.ckpt``) is restored too:
its weights, its optax optimizer state and its LR schedule's count
(``training/optax_state.py``).
"""

from __future__ import annotations

import os
import re
from glob import glob
from typing import Any, Dict, Optional, Tuple

import torch

CKPT_PATTERN = re.compile(r"^(\d{6})\.pth$")


def save_checkpoint(model_dir: str, step: int, model, optimizer, scheduler,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    os.makedirs(model_dir, exist_ok=True)
    path = os.path.join(model_dir, f"{step:06d}.pth")
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                "scheduler": scheduler.state_dict(), "step": int(step),
                "extra": extra or {}}, path)
    return path


def restore_checkpoint(path: str, model, optimizer, scheduler) -> Tuple[Dict[str, Any], int]:
    """Loads a session into ``model``, ``optimizer`` and ``scheduler`` in
    place: one of this trainer's ``.pth`` files or a JAX trainer's ``.ckpt``.
    A ``.ckpt`` that cannot be read raises ``ValueError`` naming it.
    :return: (extra, step)"""
    if path.endswith(".ckpt"):
        from stemseg_tpu_torch.models.flax_msgpack import read_msgpack_file
        from stemseg_tpu_torch.training.optax_state import restore_jax_session

        try:
            payload = read_msgpack_file(path)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from e
        return restore_jax_session(payload, path, model, optimizer, scheduler)
    device = next(model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(ckpt["model"])
    optimizer.load_state_dict(ckpt["optimizer"])
    scheduler.load_state_dict(ckpt["scheduler"])
    return ckpt["extra"], int(ckpt["step"])


def find_latest_checkpoint(model_dir: str) -> Optional[str]:
    """The checkpoint with the highest iteration number, or None."""
    if not os.path.isdir(model_dir):
        return None
    steps = [int(m.group(1)) for m in map(CKPT_PATTERN.match, os.listdir(model_dir)) if m]
    return os.path.join(model_dir, f"{max(steps):06d}.pth") if steps else None


def cleanup_old_checkpoints(model_dir: str, keep: int) -> None:
    """Keep the newest ``keep`` checkpoints."""
    ckpts = sorted(glob(os.path.join(model_dir, "[0-9][0-9][0-9][0-9][0-9][0-9].pth")))
    for path in ckpts[:-keep] if keep > 0 else []:
        os.remove(path)
