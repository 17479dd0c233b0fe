"""Image -> pseudo-video augmentation (cv2), the JAX package's
``data/augmenter.py`` in the one configuration its loaders use (the image
clip loaders; the video loaders do not augment). Each call applies

1. a photometric jitter: one or both of {brightness add in [-40, 40], hue +
   saturation add in [-5, 5]} (both draw one value; brightness first when
   both are chosen);
2. one geometric transform shared by the image, the masks and the validity
   map: a perspective jitter (each corner moves inward by ``|N(0, 0.08)|``
   of the side, the quad stretched back to the full canvas) composed with an
   affine (translation of up to 10 % of the size, rotation, no scaling), as
   one homography; masks and the validity map warp with nearest-neighbour
   sampling;
3. motion blur with probability ``motion_blur_prob`` (a line kernel of 9 or
   11 pixels in a random direction).

Randomness comes from the caller: every ``random`` draw from ``rng`` (a
``random.Random``) and the perspective jitter from ``np_rng`` (a
``np.random.RandomState``), in the JAX package's order, so that generators
seeded with ``s`` give the bytes that the JAX augmenter gives after
``random.seed(s); np.random.seed(s)``.
"""

from __future__ import annotations

import math
import random
from typing import List

import cv2
import numpy as np


class ImageToSeqAugmenter:
    BRIGHTNESS_RANGE = (-40, 40)
    HUE_SATURATION_RANGE = (-5, 5)
    PERSPECTIVE_MAGNITUDE = 0.08
    TRANSLATE_RANGE = (-0.1, 0.1)
    MOTION_BLUR_KERNEL_SIZES = (9, 11)

    def __init__(self, rotation: float, motion_blur_prob: float):
        """:param rotation: the largest rotation, degrees either way"""
        self.rotation_range = (-rotation, rotation)
        self.motion_blur_prob = motion_blur_prob

    def _photometric(self, image: np.ndarray, rng: random.Random) -> np.ndarray:
        ops = ("brightness", "hue_sat")
        chosen = sorted(rng.sample(range(len(ops)), rng.randint(1, 2)))
        out = image
        for op in (ops[i] for i in chosen):
            if op == "brightness":
                shifted = out.astype(np.int16) + int(rng.uniform(*self.BRIGHTNESS_RANGE))
                out = np.clip(shifted, 0, 255).astype(np.uint8)
            else:
                val = int(rng.uniform(*self.HUE_SATURATION_RANGE))
                hsv = cv2.cvtColor(out, cv2.COLOR_BGR2HSV).astype(np.int16)
                hsv[..., 0] = (hsv[..., 0] + val) % 180
                hsv[..., 1] = np.clip(hsv[..., 1] + val, 0, 255)
                out = cv2.cvtColor(hsv.astype(np.uint8), cv2.COLOR_HSV2BGR)
        return out

    def _sample_geometric(self, h: int, w: int, rng: random.Random,
                          np_rng: np.random.RandomState) -> np.ndarray:
        """One 3x3 homography: the perspective jitter, then the affine."""
        full = np.float32([[0, 0], [w, 0], [w, h], [0, h]])
        jitter = np.abs(np_rng.normal(0, self.PERSPECTIVE_MAGNITUDE, (4, 2))) \
            .astype(np.float32) * np.float32([w, h])
        inward = np.float32([[1, 1], [-1, 1], [-1, -1], [1, -1]])
        perspective = cv2.getPerspectiveTransform(full + jitter * inward, full) \
            .astype(np.float64)

        tx = rng.uniform(*self.TRANSLATE_RANGE) * w
        ty = rng.uniform(*self.TRANSLATE_RANGE) * h
        angle = rng.uniform(*self.rotation_range)
        rot33 = np.vstack([cv2.getRotationMatrix2D((w / 2.0, h / 2.0), angle, 1.0), [0, 0, 1]])
        rot33[0, 2] += tx
        rot33[1, 2] += ty
        return rot33 @ perspective

    @staticmethod
    def _warp(image: np.ndarray, mat: np.ndarray, interp: int) -> np.ndarray:
        h, w = image.shape[:2]
        return cv2.warpPerspective(image, mat, (w, h), flags=interp,
                                   borderMode=cv2.BORDER_CONSTANT, borderValue=0)

    def _motion_blur(self, image: np.ndarray, rng: random.Random) -> np.ndarray:
        if rng.random() >= self.motion_blur_prob:
            return image
        ksize = rng.choice(self.MOTION_BLUR_KERNEL_SIZES)
        angle = rng.uniform(0, 360)
        kernel = np.zeros((ksize, ksize), np.float32)
        c = (ksize - 1) / 2.0
        dx, dy = math.cos(math.radians(angle)), math.sin(math.radians(angle))
        for i in range(ksize):
            x, y = int(round(c + (i - c) * dx)), int(round(c + (i - c) * dy))
            if 0 <= x < ksize and 0 <= y < ksize:
                kernel[y, x] = 1.0
        kernel /= max(kernel.sum(), 1.0)
        return cv2.filter2D(image, -1, kernel)

    def __call__(self, image: np.ndarray, masks: List[np.ndarray], rng: random.Random,
                 np_rng: np.random.RandomState):
        """:param image: [H, W, 3] uint8 BGR
        :param masks: list of [H, W] uint8 / bool masks
        :return: (image, masks, invalid [H, W] bool)"""
        h, w = image.shape[:2]
        out = self._photometric(image, rng)
        mat = self._sample_geometric(h, w, rng, np_rng)
        out = self._warp(out, mat, cv2.INTER_LINEAR)
        valid = self._warp(np.ones((h, w), np.uint8), mat, cv2.INTER_NEAREST)
        out = self._motion_blur(out, rng)
        aug_masks = [self._warp(np.asarray(m, np.uint8), mat, cv2.INTER_NEAREST) for m in masks]
        return out, aug_masks, valid == 0
