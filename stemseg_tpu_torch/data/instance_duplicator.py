"""Copy-paste augmentation for single-instance clips, the JAX package's
``data/instance_duplicator.py``: the instance is optionally flipped inside
its box, shifted by a fraction of its own size (the direction constrained
by where it touches the frame's border, so that the copy stays visible),
pasted over every frame, and the original is occluded where the copy lands.
Returns ``(None, None)`` when duplication is infeasible or anything raises;
the caller then keeps the original clip. Its ``random`` draws come from the
caller's ``rng``.
"""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

import cv2
import numpy as np


def bbox_from_mask(mask: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
    """(x_min, y_min, x_max, y_max), max exclusive; None for an empty mask."""
    cols = np.any(mask, axis=0)
    rows = np.any(mask, axis=1)
    if not cols.any():
        return None
    return (int(cols.argmax()), int(rows.argmax()),
            int(len(cols) - np.flip(cols).argmax()), int(len(rows) - np.flip(rows).argmax()))


class InstanceDuplicator:
    def __call__(self, images: List[np.ndarray], masks: List[np.ndarray], rng: random.Random):
        """:param images: T frames [H, W, 3] BGR uint8
        :param masks: T single-instance masks [H, W] uint8
        :return: (new_images, [modified_original_masks, duplicate_masks]), or
            (None, None)"""
        try:
            return self._augment(images, masks, rng)
        except Exception as err:  # the reference's broad catch: keep the clip
            print("Exception occurred trying to duplicate instance")
            print(err)
            return None, None

    @staticmethod
    def _augment(images, masks, rng):
        boxes = [bbox_from_mask(m) for m in masks]
        touches = dict(left=False, right=False, top=False, bottom=False)
        horiz_mult = vert_mult = None

        for mask, bbox in zip(masks, boxes):
            if bbox is None:
                continue
            h, w = mask.shape
            xmin, ymin, xmax, ymax = bbox
            touches["left"] |= xmin == 0
            touches["right"] |= xmax == w
            touches["top"] |= ymin == 0
            touches["bottom"] |= ymax == h

            # a wide instance at a border may only move further out; a narrow
            # one near a border only inward
            if xmax - xmin > 0.4 * w:
                if xmin == 0:
                    horiz_mult = -1.0
                elif xmax == w:
                    horiz_mult = 1.0
            elif xmax - xmin < 0.2 * w:
                xc = (xmin + xmax) / 2.0
                if xc < w * 0.25:
                    horiz_mult = 1.0
                elif xc > w * 0.75:
                    horiz_mult = -1.0

            if ymax - ymin > 0.4 * h:
                if ymin == 0:
                    vert_mult = -1.0
                elif ymax == h:
                    vert_mult = 1.0
            elif ymax - ymin < 0.2 * h:
                yc = (ymin + ymax) / 2.0
                if yc < h * 0.25:
                    vert_mult = 1.0
                elif yc > h * 0.75:
                    vert_mult = -1.0

        if touches["left"] and touches["right"]:
            return None, None
        flipping_feasible = not touches["left"] and not touches["right"]
        if touches["top"] and touches["bottom"]:
            vert_mult = 0.0
        if horiz_mult is None:
            horiz_mult = -1.0 if rng.random() < 0.5 else 1.0
        if vert_mult is None:
            vert_mult = -1.0 if rng.random() < 0.5 else 1.0
        flip = rng.random() < 0.5 if flipping_feasible else False

        new_images, modified_masks, duplicate_masks = [], [], []
        for image, mask, bbox in zip(images, masks, boxes):
            if image.shape[:2] != mask.shape:
                raise ValueError(f"frame {image.shape[:2]} and mask {mask.shape} differ")
            h, w = image.shape[:2]
            if bbox is None:
                new_images.append(image.copy())
                modified_masks.append(mask)
                duplicate_masks.append(mask.copy())
                continue

            xmin, ymin, xmax, ymax = bbox
            bw, bh = xmax - xmin, ymax - ymin
            src_img, src_mask = image, mask
            if flip:
                src_img, src_mask = image.copy(), mask.copy()
                src_img[ymin:ymax, xmin:xmax] = np.flip(src_img[ymin:ymax, xmin:xmax], axis=1)
                src_mask[ymin:ymax, xmin:xmax] = np.flip(src_mask[ymin:ymax, xmin:xmax], axis=1)

            shift_x = min(horiz_mult * (bw * 0.75 + rng.random() * 0.25 * bw), w * 0.3)
            shift_y = min(vert_mult * (bh * rng.random() * 0.25), h * 0.3)
            affine = np.array([[1.0, 0.0, shift_x], [0.0, 1.0, shift_y]], np.float32)
            shifted_img = cv2.warpAffine(src_img, affine, (w, h))
            shifted_mask = cv2.warpAffine(src_mask, affine, (w, h))

            new_images.append(np.where(shifted_mask[..., None] > 0, shifted_img, image))
            duplicate_masks.append(shifted_mask)
            modified_masks.append(np.where(shifted_mask > 0, 0, mask).astype(mask.dtype))

        return new_images, [modified_masks, duplicate_masks]
