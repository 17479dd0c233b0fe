"""The Pascal-VOC palette used by the DAVIS PNG writer, and the mask
overlay of its visualisations and of the training loaders' debug CLI."""

from __future__ import annotations

import numpy as np


def create_color_map(n: int = 256) -> np.ndarray:
    """[n, 3] uint8; the color of index i bit-reverses i into 3 channels."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


def overlay_mask_on_image(image: np.ndarray, mask: np.ndarray, mask_color) -> np.ndarray:
    """``mask_color`` blended at 0.6 opacity onto the ``[H, W, 3]`` uint8
    ``image`` where the ``[H, W]`` ``mask`` is set."""
    masked = np.where(mask[..., None] > 0, np.asarray(mask_color, dtype=image.dtype), image)
    return (0.6 * masked + 0.4 * image).astype(np.uint8)
