"""Loss and model-output key names, the same strings as the JAX package's
``utils/constants.py``, so that both trainers log the same metric keys; and
the port's own data directories."""

import os


class LossConsts:
    EMBEDDING = "total_embedding"
    LOVASZ_LOSS = "lovasz"
    VARIANCE_SMOOTHNESS = "var_smoothness"
    SEEDINESS_LOSS = "seediness"
    SEMSEG = "semseg"
    FOREGROUND = "fg"


class ModelOutputConsts:
    EMBEDDINGS = "embeddings"
    SEMSEG_MASKS = "semseg_masks"


class RepoPaths:
    @staticmethod
    def package_dir():
        return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    @staticmethod
    def dataset_meta_info_dir():
        """The category tables ``{coco,pascal_voc,mapillary}.json``."""
        return os.path.join(RepoPaths.package_dir(), "data", "metainfo")
