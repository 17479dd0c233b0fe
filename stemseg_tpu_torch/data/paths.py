"""Dataset locations from environment variables, as in the JAX package's
``data/paths.py``: the image roots ``COCO_TRAIN_IMAGES_DIR``,
``PASCAL_VOC_IMAGES_DIR``, ``MAPILLARY_IMAGES_DIR``, ``DAVIS_BASE_DIR``,
``YOUTUBE_VIS_BASE_DIR`` (its ``train`` and ``valid`` folders) and
``KITTIMOTS_BASE_DIR``, and the annotation JSONs under
``STEMSEG_JSON_ANNOTATIONS_DIR``."""

from __future__ import annotations

import os


def _require_env(name: str) -> str:
    value = os.environ.get(name)
    if value is None:
        raise KeyError(f"Required environment variable {name!r} is not set")
    return value


def _ann_file(name: str) -> str:
    return os.path.join(_require_env("STEMSEG_JSON_ANNOTATIONS_DIR"), name)


class CocoPaths:
    @staticmethod
    def images_dir():
        return _require_env("COCO_TRAIN_IMAGES_DIR")

    @staticmethod
    def ids_file():
        return _ann_file("coco_train.json")


class YoutubeVISPaths:
    @staticmethod
    def training_base_dir():
        return os.path.join(_require_env("YOUTUBE_VIS_BASE_DIR"), "train")

    @staticmethod
    def train_vds_file():
        return _ann_file("youtube_vis_train.json")

    @staticmethod
    def val_base_dir():
        return os.path.join(_require_env("YOUTUBE_VIS_BASE_DIR"), "valid")

    @staticmethod
    def val_vds_file():
        return _ann_file("youtube_vis_val.json")


class DavisUnsupervisedPaths:
    @staticmethod
    def trainval_base_dir():
        return _require_env("DAVIS_BASE_DIR")

    @staticmethod
    def train_vds_file():
        return _ann_file("davis_train.json")

    @staticmethod
    def val_vds_file():
        return _ann_file("davis_val.json")


class KITTIMOTSPaths:
    @staticmethod
    def train_images_dir():
        return _require_env("KITTIMOTS_BASE_DIR")

    @staticmethod
    def train_vds_file():
        return _ann_file("kittimots_train.json")

    @staticmethod
    def val_vds_file():
        return _ann_file("kittimots_val.json")


class MapillaryPaths:
    @staticmethod
    def images_dir():
        return _require_env("MAPILLARY_IMAGES_DIR")

    @staticmethod
    def ids_file():
        return _ann_file("mapillary_train.json")


class PascalVOCPaths:
    @staticmethod
    def images_dir():
        return _require_env("PASCAL_VOC_IMAGES_DIR")

    @staticmethod
    def ids_file():
        return _ann_file("pascal_voc_train.json")
