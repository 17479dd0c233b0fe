"""Output geometry shared by the writers.

The un-pad / resize chain decides the final mask geometry, so it follows
the reference exactly:

1. upsample the 4x-scale masks to the network input size (bilinear,
   ``align_corners=False``), unless they are at that size already
   (``upscaled_inputs``, full-scale clustering);
2. crop the /32 zero padding (to the ``compute_resize_params`` dims);
3. resize bilinearly to the original image dims, threshold at 0.5.

``annotate_instance`` draws one instance and its label on a frame.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from stemseg_tpu_torch.models.layers import resize_bilinear
from stemseg_tpu_torch.structures.geometry import compute_resize_params
from stemseg_tpu_torch.utils.vis import overlay_mask_on_image


def masks_to_original_dims(masks: torch.Tensor, mask_scale: int,
                           image_dims: Tuple[int, int], min_dim: int,
                           max_dim: int, upscaled_inputs: bool = False) -> torch.Tensor:
    """[K, h, w] mask stack at network-output scale (or at the padded
    network input scale with ``upscaled_inputs``) -> [K, H_img, W_img] bool.

    :param image_dims: original (height, width)
    """
    image_height, image_width = image_dims
    resized_w, resized_h, _ = compute_resize_params((image_width, image_height),
                                                    min_dim, max_dim)
    scale = 1 if upscaled_inputs else mask_scale
    k, h, w = masks.shape
    if h * scale < resized_h or w * scale < resized_w:
        raise ValueError(f"network dims without padding ({resized_h},{resized_w}) "
                         f"exceed the padded dims ({h * scale},{w * scale})")
    x = masks.float()
    if not upscaled_inputs:
        x = resize_bilinear(x, (h * mask_scale, w * mask_scale))
    x = x[:, :resized_h, :resized_w]
    return resize_bilinear(x, (image_height, image_width)) > 0.5


def select_instances_to_keep(metric: Dict[int, int], outlier_label: int,
                             max_tracks: int) -> List[int]:
    """The top ``max_tracks`` track ids by ``metric``: lifetimes (DAVIS,
    YT-VIS) or pixel counts (KITTI-MOTS); ties keep their dict order."""
    kept = [iid for iid, _ in sorted(metric.items(), key=lambda x: x[1], reverse=True)
            if iid != outlier_label]
    return kept[:max_tracks]


def to_device(x, device: torch.device) -> torch.Tensor:
    """A tensor, or a copy of an array (read-only ones included), on ``device``."""
    return x.to(device) if torch.is_tensor(x) else torch.tensor(np.asarray(x), device=device)


def annotate_instance(image: np.ndarray, mask: np.ndarray, color, text: Optional[str] = None,
                      font_size: float = 0.5) -> np.ndarray:
    """``image`` (``[H, W, 3]`` uint8) with ``mask`` blended in ``color`` and,
    if given, ``text`` in white above the mask's top-left corner."""
    import cv2

    image = overlay_mask_on_image(image, mask.astype(bool), mask_color=color)
    if text:
        ys, xs = np.nonzero(mask)
        if len(ys):
            org = (int(xs.min()), max(int(ys.min()) - 2, 10))
            cv2.putText(image, text, org, cv2.FONT_HERSHEY_SIMPLEX, font_size,
                        (255, 255, 255), 1, cv2.LINE_AA)
    return image
