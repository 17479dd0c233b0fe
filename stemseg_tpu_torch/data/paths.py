"""Dataset locations from environment variables (the DAVIS part): the image
root ``DAVIS_BASE_DIR`` and the annotation JSONs under
``STEMSEG_JSON_ANNOTATIONS_DIR``."""

from __future__ import annotations

import os


def _require_env(name: str) -> str:
    value = os.environ.get(name)
    if value is None:
        raise KeyError(f"Required environment variable {name!r} is not set")
    return value


class DavisUnsupervisedPaths:
    @staticmethod
    def trainval_base_dir():
        return _require_env("DAVIS_BASE_DIR")

    @staticmethod
    def val_vds_file():
        return os.path.join(_require_env("STEMSEG_JSON_ANNOTATIONS_DIR"), "davis_val.json")
