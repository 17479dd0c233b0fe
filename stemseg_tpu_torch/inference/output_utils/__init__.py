from stemseg_tpu_torch.inference.output_utils.davis import DavisOutputGenerator  # noqa: F401
