from stemseg_tpu_torch.config.config import (  # noqa: F401
    Config,
    load_config,
    load_preset,
    merge,
    to_dict,
)
