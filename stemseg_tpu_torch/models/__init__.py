from stemseg_tpu_torch.models.builder import STEmSegModel, build_model  # noqa: F401
from stemseg_tpu_torch.models.weights import (  # noqa: F401
    init_random_weights,
    load_state_dict_file,
    state_dict_from_jax,
)
