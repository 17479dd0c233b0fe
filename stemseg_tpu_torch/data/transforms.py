"""Host-side image normalisation (numpy, channels-last), the JAX package's
``data/transforms.py:scale_and_normalize_images``: Caffe-style per-channel
means and scales on ``[T, H, W, 3]`` float32 BGR, optional unit scale and
channel flip."""

from __future__ import annotations

from typing import Sequence

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
