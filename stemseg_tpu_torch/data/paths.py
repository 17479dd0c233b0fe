"""Dataset locations from environment variables (the inference part): the
image roots ``DAVIS_BASE_DIR``, ``YOUTUBE_VIS_BASE_DIR`` (its ``valid``
folder) and ``KITTIMOTS_BASE_DIR``, and the annotation JSONs under
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


class DavisUnsupervisedPaths:
    @staticmethod
    def trainval_base_dir():
        return _require_env("DAVIS_BASE_DIR")

    @staticmethod
    def val_vds_file():
        return _ann_file("davis_val.json")


class YoutubeVISPaths:
    @staticmethod
    def val_base_dir():
        return os.path.join(_require_env("YOUTUBE_VIS_BASE_DIR"), "valid")

    @staticmethod
    def val_vds_file():
        return _ann_file("youtube_vis_val.json")


class KITTIMOTSPaths:
    @staticmethod
    def train_images_dir():
        return _require_env("KITTIMOTS_BASE_DIR")

    @staticmethod
    def val_vds_file():
        return _ann_file("kittimots_val.json")
