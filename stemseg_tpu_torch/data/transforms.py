"""Host-side image transforms (numpy / cv2, channels-last), the JAX
package's ``data/transforms.py``: Caffe-style per-channel normalisation of
``[T, H, W, 3]`` float32 BGR with optional unit scale and channel flip, and
the training loaders' resizes. cv2's ``INTER_LINEAR`` samples at half-pixel
centres, as ``F.interpolate(mode='bilinear', align_corners=False)`` does."""

from __future__ import annotations

from typing import Sequence, Tuple

import cv2
import numpy as np


def scale_and_normalize_images(images: np.ndarray, means: Sequence[float],
                               scales: Sequence[float], invert_channels: bool,
                               normalize_to_unit_scale: bool) -> np.ndarray:
    """:param images: [T, H, W, 3] float32 (BGR as loaded by cv2)"""
    images = images.astype(np.float32)
    if normalize_to_unit_scale:
        images = images / 255.0
    images = (images - np.asarray(means, np.float32)) / np.asarray(scales, np.float32)
    if invert_channels:
        images = images[..., ::-1]
    return images


def resize_images(images: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize [T, H, W, C] -> [T, h, w, C]."""
    h, w = out_hw
    return np.stack([cv2.resize(im, (w, h), interpolation=cv2.INTER_LINEAR)
                     for im in images], axis=0)


def resize_mask(mask: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """Binary mask resize: bilinear on float32, then ``> 0.5``."""
    h, w = out_hw
    resized = cv2.resize(mask.astype(np.float32), (w, h), interpolation=cv2.INTER_LINEAR)
    return (resized > 0.5).astype(np.uint8)
