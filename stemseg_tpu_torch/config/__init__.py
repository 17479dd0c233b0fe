from stemseg_tpu_torch.config.config import (  # noqa: F401
    Config,
    load_config,
    load_preset,
    merge,
    resolve_max_instances,
    save_config,
    to_dict,
)
