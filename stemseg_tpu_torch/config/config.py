"""Typed, immutable configuration tree (the port's own copy).

Field for field the same tree as the JAX package's ``config/config.py``:
frozen dataclasses whose defaults mirror the reference ``defaults.yaml``,
a strict recursive ``merge`` that rejects unknown keys, and ``to_dict``.
The presets ship as JSON so that no YAML parser is needed to load them;
``load_config`` imports ``yaml`` only when it is handed a ``config.yaml``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple

PRESETS_DIR = os.path.join(os.path.dirname(__file__), "presets")


class ConfigError(ValueError):
    pass


def _as_tuple(value):
    if isinstance(value, (list, tuple)):
        return tuple(_as_tuple(v) for v in value)
    return value


def merge(cfg, overrides: Mapping[str, Any]):
    """Strictly merge a nested mapping of overrides into a config dataclass,
    returning a new instance. Keys match case-insensitively; unknown keys
    raise ``ConfigError``."""
    if not dataclasses.is_dataclass(cfg):
        raise ConfigError(f"Cannot merge into non-dataclass {type(cfg)!r}")

    fields_by_key = {f.name.lower(): f for f in dataclasses.fields(cfg)}
    updates = {}
    for key, value in overrides.items():
        norm = key.lower()
        if norm not in fields_by_key:
            raise ConfigError(
                f"Unknown config key {key!r} for {type(cfg).__name__} "
                f"(valid: {sorted(fields_by_key)})")
        f = fields_by_key[norm]
        current = getattr(cfg, f.name)
        if dataclasses.is_dataclass(current):
            if not isinstance(value, Mapping):
                raise ConfigError(
                    f"Config key {key!r} expects a nested mapping, got {value!r}")
            updates[f.name] = merge(current, value)
        else:
            if isinstance(value, Mapping):
                raise ConfigError(
                    f"Config key {key!r} is a leaf, got nested mapping {value!r}")
            updates[f.name] = _as_tuple(value)
    return dataclasses.replace(cfg, **updates)


def to_dict(cfg) -> dict:
    """Export a config dataclass tree as plain nested dicts."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = to_dict(v)
        elif isinstance(v, tuple):
            out[f.name] = list(v)
        else:
            out[f.name] = v
    return out


@dataclass(frozen=True)
class InputConfig:
    image_mean: Tuple[float, float, float] = (102.9801, 115.9465, 122.7717)
    image_std: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    normalize_to_unit_scale: bool = False
    min_dim: int = 800
    max_dim: int = 1333
    bgr_input: bool = True
    num_frames: int = 8
    num_classes: int = 2


@dataclass(frozen=True)
class EmbeddingLossConfig:
    weight_regularization: float = 0.001
    weight_lovasz: float = 1.0
    weight_variance_smoothness: float = 10.0
    weight_seediness: float = 1.0
    weight: float = 1.0
    free_dim_stds: Tuple[float, ...] = ()


@dataclass(frozen=True)
class LossesConfig:
    semseg: str = "cross_entropy"
    weight_semseg: float = 1.0
    embedding: EmbeddingLossConfig = field(default_factory=EmbeddingLossConfig)


@dataclass(frozen=True)
class TrainingConfig:
    mode: str = ""
    loss_at_full_res: bool = False
    freeze_backbone: bool = False
    mixed_precision: bool = False
    batch_size: int = 2
    weight_decay: float = 0.0001
    max_iterations: int = 120000
    accumulate_gradients: bool = True
    max_samples_per_chip: int = 1
    clip_gradients: bool = False
    optimizer: str = "SGD"
    initial_lr: float = 0.001
    lr_decay_type: str = "step"
    lr_decay_steps: Tuple[int, ...] = (20000, 50000)
    lr_decay_factor: float = 0.1
    lr_exp_decay_factor: float = 0.001
    lr_exp_decay_start: int = 40000
    lr_exp_decay_steps: int = 60000
    momentum: float = 0.9
    nesterov: bool = True
    losses: LossesConfig = field(default_factory=LossesConfig)
    max_instances: int = 0
    instance_overflow: str = "ignore"


@dataclass(frozen=True)
class BackboneConfig:
    pretrained_weights: str = "mask_rcnn_R_101_FPN_backbone.pth"
    type: str = "R-101-FPN"
    freeze_at_stage: int = 2


@dataclass(frozen=True)
class ResNetsConfig:
    backbone_out_channels: int = 256
    num_groups: int = 1
    res2_out_channels: int = 256
    stem_out_channels: int = 64
    stride_in_1x1: bool = True
    width_per_group: int = 64


@dataclass(frozen=True)
class FPNConfig:
    use_gn: bool = False
    use_relu: bool = False


@dataclass(frozen=True)
class EmbeddingsHeadConfig:
    head_type: str = "squeeze_expand_decoder"
    inter_channels: Tuple[int, ...] = (256, 256, 128, 128)
    scale: Tuple[int, ...] = (32, 16, 8, 4)
    embedding_size: int = 3
    tanh_activation: bool = True
    # the reference never wires TIME_SCALE into the decoder's buffer, which
    # stays 1.0 unless a checkpoint overwrites it
    time_scale: float = 1.0
    normalization_layer: str = "gn"
    gn_num_groups: int = 32
    pool_type: str = "avg"


@dataclass(frozen=True)
class SemsegHeadConfig:
    head_type: str = "squeeze_expand_decoder"
    feature_scale: Tuple[int, ...] = (4, 8, 16, 32)
    inter_channels: Tuple[int, ...] = (256, 256, 128, 128)
    normalization_layer: str = "gn"
    gn_num_groups: int = 32
    pool_type: str = "avg"
    foreground_channel: bool = True


@dataclass(frozen=True)
class SeedinessHeadConfig:
    head_type: str = "squeeze_expand_decoder"
    feature_scale: Tuple[int, ...] = (32, 16, 8, 4)
    inter_channels: Tuple[int, ...] = (256, 256, 128, 128)
    normalization_layer: str = "gn"
    gn_num_groups: int = 32
    pool_type: str = "avg"


@dataclass(frozen=True)
class ModelConfig:
    use_semseg_head: bool = True
    use_seediness_head: bool = False
    embedding_dim_mode: str = "xyt"
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    resnets: ResNetsConfig = field(default_factory=ResNetsConfig)
    fpn: FPNConfig = field(default_factory=FPNConfig)
    embeddings: EmbeddingsHeadConfig = field(default_factory=EmbeddingsHeadConfig)
    semseg: SemsegHeadConfig = field(default_factory=SemsegHeadConfig)
    seediness: SeedinessHeadConfig = field(default_factory=SeedinessHeadConfig)


@dataclass(frozen=True)
class DavisDataConfig:
    frame_gap_lower: int = 16
    frame_gap_upper: int = 16
    single_instance_duplication: bool = False
    max_inference_tracks: int = 20
    inference_frame_overlap: int = 6
    coco_weight: float = 0.25
    pascal_voc_weight: float = 0.1
    youtube_vis_weight: float = 0.35
    davis_weight: float = 0.3


@dataclass(frozen=True)
class YoutubeVISDataConfig:
    frame_gap_lower: int = 8
    frame_gap_upper: int = 8
    single_instance_duplication: bool = True
    max_inference_tracks: int = 10
    inference_frame_overlap: int = 4
    coco_weight: float = 0.3
    pascal_voc_weight: float = 0.1
    youtube_vis_weight: float = 0.6


@dataclass(frozen=True)
class KittiMOTSDataConfig:
    frame_gap_lower: int = 8
    frame_gap_upper: int = 8
    train_seqs: Tuple[str, ...] = (
        "0000", "0001", "0003", "0004", "0005", "0009", "0011",
        "0012", "0015", "0017", "0019", "0020", "0050",
    )
    val_seqs: Tuple[str, ...] = (
        "0002", "0006", "0007", "0008", "0010", "0013", "0014", "0016", "0018",
    )
    inference_frame_overlap: int = 4
    max_inference_tracks: int = 1000
    mapillary_weight: float = 0.0
    kitti_mots_weight: float = 1.0


@dataclass(frozen=True)
class SyntheticDataConfig:
    height: int = 0
    width: int = 0
    max_instances: int = 4
    seed: int = 0


@dataclass(frozen=True)
class DataConfig:
    davis: DavisDataConfig = field(default_factory=DavisDataConfig)
    youtube_vis: YoutubeVISDataConfig = field(default_factory=YoutubeVISDataConfig)
    kitti_mots: KittiMOTSDataConfig = field(default_factory=KittiMOTSDataConfig)
    synthetic: SyntheticDataConfig = field(default_factory=SyntheticDataConfig)


@dataclass(frozen=True)
class ClusteringConfig:
    min_seediness_prob: float = 0.8
    primary_prob_threshold: float = 0.5
    secondary_prob_threshold: float = 0.3
    # "reference" assigns leftovers to the farthest cluster above the
    # secondary threshold (the reference's .max over distances); "nearest"
    # to the closest one
    secondary_assignment: str = "reference"
    max_instances: int = 20


@dataclass(frozen=True)
class Config:
    input: InputConfig = field(default_factory=InputConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    clustering: ClusteringConfig = field(default_factory=ClusteringConfig)


def resolve_max_instances(cfg: Config) -> int:
    """Instance-axis pad size of training batches: ``training.max_instances``
    when set (> 0); else 30 for kitti_mots (Mapillary keeps up to 30
    instances an image) and 16 for the other modes."""
    if cfg.training.max_instances > 0:
        return cfg.training.max_instances
    return 30 if cfg.training.mode == "kitti_mots" else 16


def save_config(cfg: Config, path: str) -> None:
    """Write ``cfg`` as YAML (the ``config.yaml`` the inference CLI reads
    beside a checkpoint, and the JAX package's ``load_config`` too)."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(to_dict(cfg), f, sort_keys=False)


def load_config(path_or_overrides, base: Optional[Config] = None) -> Config:
    """Build a ``Config`` from a mapping of overrides, a ``.json`` file or a
    ``.yaml`` file, merged strictly on top of ``base`` (or the defaults)."""
    base = base if base is not None else Config()
    if isinstance(path_or_overrides, Mapping):
        overrides = path_or_overrides
    elif str(path_or_overrides).endswith(".json"):
        with open(path_or_overrides, "r") as f:
            overrides = json.load(f)
    else:
        import yaml

        with open(path_or_overrides, "r") as f:
            overrides = yaml.safe_load(f) or {}
    return merge(base, overrides)


def load_preset(name: str) -> Config:
    """Load a named run preset (e.g. 'davis_1', 'youtube_vis')."""
    path = os.path.join(PRESETS_DIR, name + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"No preset named {name!r} in {PRESETS_DIR}")
    return load_config(path)
