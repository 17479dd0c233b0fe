from stemseg_tpu_torch.losses.embedding import (  # noqa: F401
    EmbeddingLossParams,
    embedding_loss,
    free_bandwidths,
)
from stemseg_tpu_torch.losses.lovasz import lovasz_hinge  # noqa: F401
from stemseg_tpu_torch.losses.semseg import (  # noqa: F401
    foreground_bce,
    semseg_cross_entropy,
)
