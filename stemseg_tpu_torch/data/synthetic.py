"""Synthetic moving-blob clips, so that the whole training loop (loader ->
step -> logging -> checkpoint -> resume) runs without a dataset on disk.

Each clip holds 1 to ``max_instances`` solid-colour ellipses drifting over
a textured background, with exact instance masks: the heads can lower
their losses on it. Sample ``i`` is drawn from
``RandomState(sample_seed(seed, i))`` in the same order as
the JAX package's ``data/synthetic.py``, so the two datasets give
byte-identical samples, and a resumed run replays the stream exactly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from stemseg_tpu_torch.data.samplers import sample_seed
from stemseg_tpu_torch.data.transforms import scale_and_normalize_images


class SyntheticBlobDataset:
    """Deterministic moving-ellipse clips at a fixed size.

    :param input_cfg: ``cfg.input`` (num_frames, min_dim/max_dim,
        normalisation constants)
    :param total_samples: dataset length
    :param height/width: clip size; default the (min_dim, max_dim) bucket
    :param max_instances: blobs per clip drawn uniformly from
        [1, max_instances]
    :param seed: stream seed
    """

    def __init__(self, input_cfg, total_samples: int,
                 height: int = None, width: int = None,
                 max_instances: int = 4, seed: int = 0):
        self.input_cfg = input_cfg
        self.total_samples = int(total_samples)
        self.height = int(height or input_cfg.min_dim)
        self.width = int(width or input_cfg.max_dim)
        self.max_instances = max_instances
        self.seed = seed

    def __len__(self) -> int:
        return self.total_samples

    def __getitem__(self, index: int) -> Dict:
        icfg = self.input_cfg
        t, h, w = icfg.num_frames, self.height, self.width
        rng = np.random.RandomState(sample_seed(self.seed, index))

        # textured background: low-frequency colour gradient + pixel noise
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        bg = np.stack([
            60 + 50 * np.sin(2 * np.pi * (xx * rng.uniform(0.5, 2.0) / w
                                          + rng.uniform(0, 1)))
            for _ in range(3)], axis=-1)
        bg += rng.randn(h, w, 3).astype(np.float32) * 8.0

        n_inst = rng.randint(1, self.max_instances + 1)
        images = np.broadcast_to(bg, (t, h, w, 3)).copy()
        masks = np.zeros((n_inst, t, h, w), np.uint8)

        for n in range(n_inst):
            a = rng.uniform(0.06, 0.16) * min(h, w)   # semi-axes (px)
            b = rng.uniform(0.06, 0.16) * min(h, w)
            cy0 = rng.uniform(0.2, 0.8) * h
            cx0 = rng.uniform(0.2, 0.8) * w
            vy = rng.uniform(-0.02, 0.02) * h          # drift per frame
            vx = rng.uniform(-0.02, 0.02) * w
            theta = rng.uniform(0, np.pi)
            ct, st = np.cos(theta), np.sin(theta)
            # bright, saturated colour well apart from the background band
            color = rng.uniform(150, 255, size=3).astype(np.float32)
            color[rng.randint(3)] = rng.uniform(0, 60)

            for f in range(t):
                cy = cy0 + vy * f
                cx = cx0 + vx * f
                u = (xx - cx) * ct + (yy - cy) * st
                v = -(xx - cx) * st + (yy - cy) * ct
                inside = (u / a) ** 2 + (v / b) ** 2 <= 1.0
                masks[n, f][inside] = 1
                images[f][inside] = color * rng.uniform(0.92, 1.08)

        np.clip(images, 0, 255, out=images)
        images = scale_and_normalize_images(
            images, icfg.image_mean, icfg.image_std,
            not icfg.bgr_input, icfg.normalize_to_unit_scale)

        return {
            "images": np.ascontiguousarray(images, np.float32),
            "masks": masks,
            "ignore_masks": np.zeros((t, h, w), np.uint8),
            "category_ids": np.ones(n_inst, np.int32),
            "orig_dims": (w, h),
            "meta": {},
        }
