"""Training dataset per ``training.mode``.

``synthetic``: moving-blob clips (``data/synthetic.py``), byte-identical to
the JAX package's, with no dataset on disk. The real-data modes mix COCO,
YouTube-VIS, DAVIS, Pascal VOC, Mapillary and KITTI-MOTS clips; their
loaders are not ported yet, and they raise rather than train on something
else.
"""

from __future__ import annotations

REAL_MODES = ("davis", "youtube_vis", "kitti_mots")


def _synthetic_dataset(cfg, total_samples: int, print_fn):
    from stemseg_tpu_torch.data.synthetic import SyntheticBlobDataset

    print_fn("Creating SYNTHETIC training dataset (moving blobs, no data on disk)...")
    scfg = cfg.data.synthetic
    return SyntheticBlobDataset(cfg.input, total_samples,
                                height=scfg.height or None,
                                width=scfg.width or None,
                                max_instances=scfg.max_instances,
                                seed=scfg.seed)


def create_training_dataset(cfg, total_samples: int, print_fn=print):
    mode = cfg.training.mode
    if mode == "synthetic":
        return _synthetic_dataset(cfg, total_samples, print_fn)
    if mode in REAL_MODES:
        raise NotImplementedError(
            f"training.mode {mode!r}: the real-dataset loaders (video_dataset, "
            "video_loaders, image_clip_loaders, augmenter, instance_duplicator, "
            "concat_dataset, training paths) are not ported yet (ROADMAP A20); "
            "use training.mode: synthetic")
    raise ValueError(f"Invalid training mode: {mode!r}")
