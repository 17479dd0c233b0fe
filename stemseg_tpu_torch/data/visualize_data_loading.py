"""Debug CLI: training clips as annotated JPEGs, as the JAX package's
``data/visualize_data_loading.py`` writes them (headless, no windows):

    python -m stemseg_tpu_torch.data.visualize_data_loading --cfg davis_1 \\
        -o OUT --num_samples 10

One directory per sample, one JPEG per frame: the instance masks in the VOC
palette and the ignore mask in grey over the denormalised frame. The
dataset comes from ``create_training_dataset`` with the config's
``training.mode`` and its environment variables.
"""

from __future__ import annotations

import argparse
import os

import cv2
import numpy as np

from stemseg_tpu_torch.utils.vis import create_color_map, overlay_mask_on_image

SEED = 0


def denormalize(images: np.ndarray, mean, std, bgr_input: bool,
                unit_scale: bool) -> np.ndarray:
    """Invert ``scale_and_normalize_images`` for display (BGR uint8)."""
    out = images.copy()
    if not bgr_input:
        out = out[..., ::-1]
    out = out * np.asarray(std, np.float32) + np.asarray(mean, np.float32)
    if unit_scale:
        out = out * 255.0
    return np.clip(out, 0, 255).astype(np.uint8)


def render_sample(sample: dict, input_cfg, out_dir: str):
    os.makedirs(out_dir, exist_ok=True)
    cmap = create_color_map()
    images = denormalize(sample["images"], input_cfg.image_mean, input_cfg.image_std,
                         input_cfg.bgr_input, input_cfg.normalize_to_unit_scale)
    masks = sample["masks"]  # [N, T, H, W]
    for t in range(images.shape[0]):
        frame = overlay_mask_on_image(images[t], sample["ignore_masks"][t] > 0,
                                      mask_color=(128, 128, 128))
        for n in range(masks.shape[0]):
            frame = overlay_mask_on_image(frame, masks[n, t] > 0,
                                          mask_color=tuple(int(c) for c in cmap[n + 1]))
        cv2.imwrite(os.path.join(out_dir, f"{t:05d}.jpg"), frame)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Visualize training samples")
    parser.add_argument("--cfg", required=True, help="preset name or YAML / JSON path")
    parser.add_argument("--output_dir", "-o", required=True)
    parser.add_argument("--num_samples", type=int, default=4)
    args = parser.parse_args(argv)

    from stemseg_tpu_torch.config import load_config, load_preset
    from stemseg_tpu_torch.training.datasets import create_training_dataset

    cfg = load_config(args.cfg) if os.path.exists(args.cfg) else load_preset(args.cfg)
    dataset = create_training_dataset(cfg, args.num_samples, seed=SEED)
    for i in range(args.num_samples):
        sample = dataset[i]
        render_sample(sample, cfg.input, os.path.join(args.output_dir, f"sample_{i:03d}"))
        print(f"sample {i}: images {sample['images'].shape}, "
              f"{sample['masks'].shape[0]} instances")
    print(f"Wrote visualizations to {args.output_dir}")


if __name__ == "__main__":
    main()
