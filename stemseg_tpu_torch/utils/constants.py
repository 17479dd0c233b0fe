"""Loss and model-output key names, the same strings as the JAX package's
``utils/constants.py``, so that both trainers log the same metric keys."""


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
