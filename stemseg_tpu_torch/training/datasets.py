"""Training dataset per ``training.mode``, as the JAX package's
``training/datasets.py`` builds it:

* ``davis``: COCO (.25) + YouTube-VIS (.35) + DAVIS (.3) + Pascal VOC (.1),
  category-agnostic;
* ``youtube_vis``: COCO (.3) + Pascal VOC (.1) + YouTube-VIS (.6), 40
  classes;
* ``kitti_mots``: Mapillary and / or KITTI-MOTS by the config's weights;
* ``synthetic``: moving-blob clips (``data/synthetic.py``), no data on disk.

The weights are the config's. Dataset roots come from environment
variables (``data/paths.py``). The datasets are built in the JAX factory's
order from one ``random.Random(seed)``, so their subsequences are the ones
the JAX factory samples after ``random.seed(seed)``; sample ``i`` of the mix
draws from generators made from ``(seed, i)``.
"""

from __future__ import annotations

import random

from stemseg_tpu_torch.data.paths import (
    CocoPaths,
    DavisUnsupervisedPaths,
    KITTIMOTSPaths,
    MapillaryPaths,
    PascalVOCPaths,
    YoutubeVISPaths,
)


def _davis_dataset(cfg, total_samples: int, print_fn, seed: int):
    from stemseg_tpu_torch.data import (
        CocoDataLoader,
        ConcatDataset,
        DavisDataLoader,
        PascalVOCDataLoader,
        YoutubeVISDataLoader,
    )

    print_fn("Creating training dataset for Davis...")
    if cfg.input.num_classes != 2:
        raise ValueError(f"davis mode needs input.num_classes 2, not {cfg.input.num_classes}")
    dcfg, ycfg = cfg.data.davis, cfg.data.youtube_vis
    rng = random.Random(seed)
    datasets = [
        CocoDataLoader(CocoPaths.images_dir(), CocoPaths.ids_file(), cfg.input,
                       category_agnostic=True),
        YoutubeVISDataLoader(
            YoutubeVISPaths.training_base_dir(), YoutubeVISPaths.train_vds_file(), cfg.input,
            int(round(total_samples * dcfg.youtube_vis_weight)), rng,
            frame_gap_lower=ycfg.frame_gap_lower, frame_gap_upper=ycfg.frame_gap_upper,
            category_agnostic=True,
            single_instance_duplication=ycfg.single_instance_duplication),
        # the DAVIS quota follows the run's length, not total_samples
        DavisDataLoader(
            DavisUnsupervisedPaths.trainval_base_dir(), DavisUnsupervisedPaths.train_vds_file(),
            cfg.input,
            int(round(cfg.training.max_iterations * cfg.training.batch_size
                      * dcfg.davis_weight)), rng,
            frame_gap_lower=dcfg.frame_gap_lower, frame_gap_upper=dcfg.frame_gap_upper),
        PascalVOCDataLoader(PascalVOCPaths.images_dir(), PascalVOCPaths.ids_file(), cfg.input,
                            category_agnostic=True),
    ]
    weights = [dcfg.coco_weight, dcfg.youtube_vis_weight, dcfg.davis_weight,
               dcfg.pascal_voc_weight]
    print_fn("Training datasets: Coco, YouTubeVIS, Davis, PascalVOC")
    return ConcatDataset(datasets, total_samples, weights, seed=seed)


def _youtube_vis_dataset(cfg, total_samples: int, print_fn, seed: int):
    from stemseg_tpu_torch.data import (
        CocoDataLoader,
        ConcatDataset,
        PascalVOCDataLoader,
        YoutubeVISDataLoader,
    )

    print_fn("Creating training dataset for YouTube-VIS...")
    if cfg.input.num_classes != 41:
        raise ValueError(f"youtube_vis mode needs input.num_classes 41, "
                         f"not {cfg.input.num_classes}")
    ycfg = cfg.data.youtube_vis
    datasets = [
        CocoDataLoader(CocoPaths.images_dir(), CocoPaths.ids_file(), cfg.input,
                       category_agnostic=False),
        PascalVOCDataLoader(PascalVOCPaths.images_dir(), PascalVOCPaths.ids_file(), cfg.input,
                            category_agnostic=False),
        YoutubeVISDataLoader(
            YoutubeVISPaths.training_base_dir(), YoutubeVISPaths.train_vds_file(), cfg.input,
            int(round(total_samples * ycfg.youtube_vis_weight)), random.Random(seed),
            frame_gap_lower=ycfg.frame_gap_lower, frame_gap_upper=ycfg.frame_gap_upper,
            category_agnostic=False,
            single_instance_duplication=ycfg.single_instance_duplication),
    ]
    weights = [ycfg.coco_weight, ycfg.pascal_voc_weight, ycfg.youtube_vis_weight]
    print_fn("Training datasets: Coco, PascalVOC, YouTubeVIS")
    return ConcatDataset(datasets, total_samples, weights, seed=seed)


def _kitti_mots_dataset(cfg, total_samples: int, print_fn, seed: int):
    from stemseg_tpu_torch.data import ConcatDataset, MapillaryDataLoader, MOTSDataLoader

    print_fn("Creating training dataset for KITTI-MOTS...")
    if cfg.input.num_classes != 3:
        raise ValueError(f"kitti_mots mode needs input.num_classes 3, "
                         f"not {cfg.input.num_classes}")
    kcfg = cfg.data.kitti_mots
    datasets, weights, names = [], [], []
    if kcfg.mapillary_weight > 0.0:
        datasets.append(MapillaryDataLoader(MapillaryPaths.images_dir(),
                                            MapillaryPaths.ids_file(), cfg.input))
        weights.append(kcfg.mapillary_weight)
        names.append("Mapillary")
    if kcfg.kitti_mots_weight > 0.0:
        datasets.append(MOTSDataLoader(
            KITTIMOTSPaths.train_images_dir(), KITTIMOTSPaths.train_vds_file(), cfg.input,
            int(round(total_samples * kcfg.kitti_mots_weight)), random.Random(seed),
            frame_gap_lower=kcfg.frame_gap_lower, frame_gap_upper=kcfg.frame_gap_upper))
        weights.append(kcfg.kitti_mots_weight)
        names.append("KITTI-MOTS")
    print_fn(f"Training datasets: {', '.join(names)}")
    return ConcatDataset(datasets, total_samples, weights, seed=seed)


def _synthetic_dataset(cfg, total_samples: int, print_fn, seed: int):
    from stemseg_tpu_torch.data.synthetic import SyntheticBlobDataset

    print_fn("Creating SYNTHETIC training dataset (moving blobs, no data on disk)...")
    scfg = cfg.data.synthetic
    return SyntheticBlobDataset(cfg.input, total_samples,
                                height=scfg.height or None,
                                width=scfg.width or None,
                                max_instances=scfg.max_instances,
                                seed=scfg.seed)


FACTORIES = {
    "davis": _davis_dataset,
    "youtube_vis": _youtube_vis_dataset,
    "kitti_mots": _kitti_mots_dataset,
    "synthetic": _synthetic_dataset,
}


def create_training_dataset(cfg, total_samples: int, seed: int, print_fn=print):
    """:param seed: the real modes' construction and per-sample seed (the
    synthetic mode keeps ``data.synthetic.seed``)"""
    mode = cfg.training.mode
    if mode not in FACTORIES:
        raise ValueError(f"Invalid training mode: {mode!r}")
    return FACTORIES[mode](cfg, total_samples, print_fn, seed)
