"""Batch assembly: samples -> fixed-shape host arrays for the train step.

Images are zero-padded to a common H/W, rounded up to a multiple of 32,
and the instance axis is padded to
``max_instances``, as in the JAX package's ``data/collate.py``. Masks stay
uint8 (the step casts them to float32 on the device).

Samples with more than ``max_instances`` instances follow ``overflow``:
``"ignore"`` keeps the largest-area instances and folds the rest into the
ignore mask, ``"drop"`` keeps the first ``max_instances``, ``"error"``
raises.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from stemseg_tpu_torch.structures.geometry import pad_to_multiple


def _select_instances(masks: np.ndarray, category_ids: np.ndarray,
                      max_instances: int, overflow: str):
    """Apply the overflow policy; returns (masks, category_ids,
    overflow_mask or None) with at most ``max_instances`` instances."""
    n_inst = masks.shape[0]
    if n_inst <= max_instances:
        return masks, category_ids, None
    if overflow == "error":
        raise ValueError(
            f"sample has {n_inst} instances > max_instances={max_instances} "
            f"(set training.max_instances or instance_overflow)")
    if overflow == "drop":
        return masks[:max_instances], category_ids[:max_instances], None
    if overflow == "ignore":
        areas = masks.reshape(n_inst, -1).sum(axis=1)
        order = np.argsort(-areas, kind="stable")
        keep, spill = order[:max_instances], order[max_instances:]
        keep = np.sort(keep)  # keep the original relative order
        overflow_mask = (masks[spill].sum(axis=0) > 0).astype(np.uint8)
        return masks[keep], category_ids[keep], overflow_mask
    raise ValueError(f"unknown instance_overflow policy {overflow!r}")


def collate_fn(samples: List[Dict], max_instances: int = 8,
               overflow: str = "ignore") -> Dict[str, np.ndarray]:
    """:param samples: sample dicts (``images`` [T, H, W, 3] float32,
        ``masks`` [I, T, H, W] uint8, ``ignore_masks`` [T, H, W] uint8,
        ``category_ids`` [I], ``orig_dims``)
    :param max_instances: fixed instance-axis size
    :param overflow: "ignore" | "drop" | "error"
    :return: ``images`` [N, T, H, W, 3] float32, ``masks`` [N, I, T, H, W]
        uint8, ``ignore_masks`` [N, T, H, W] uint8, ``category_ids`` [N, I]
        int32, ``image_sizes``, ``orig_dims``
    """
    n = len(samples)
    t = samples[0]["images"].shape[0]
    max_h = max(s["images"].shape[1] for s in samples)
    max_w = max(s["images"].shape[2] for s in samples)
    ph, pw = pad_to_multiple(max_h, max_w)

    images = np.zeros((n, t, ph, pw, 3), np.float32)
    masks = np.zeros((n, max_instances, t, ph, pw), np.uint8)
    ignore = np.zeros((n, t, ph, pw), np.uint8)
    category_ids = np.zeros((n, max_instances), np.int32)
    image_sizes = []
    orig_dims = []

    for i, s in enumerate(samples):
        _, h, w, _ = s["images"].shape
        images[i, :, :h, :w] = s["images"]
        s_masks, s_cats, spill = _select_instances(
            np.asarray(s["masks"]), np.asarray(s["category_ids"]),
            max_instances, overflow)
        n_inst = s_masks.shape[0]
        masks[i, :n_inst, :, :h, :w] = s_masks
        ignore[i, :, :h, :w] = s["ignore_masks"]
        if spill is not None:
            ignore[i, :, :h, :w] |= spill.astype(np.uint8)
        category_ids[i, :n_inst] = s_cats
        image_sizes.append((h, w))
        orig_dims.append(s["orig_dims"])

    return {
        "images": images,
        "masks": masks,
        "ignore_masks": ignore,
        "category_ids": category_ids,
        "image_sizes": image_sizes,
        "orig_dims": orig_dims,
    }
