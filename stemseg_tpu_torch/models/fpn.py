"""Feature Pyramid Network: lateral 1x1 convs, 3x3 output convs and a
bilinear (half-pixel) 2x top-down path; 4 levels, finest first. The convs
compute in ``dtype`` (None: the input's)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from stemseg_tpu_torch.models.layers import make_conv, upsample_bilinear


class FPN(nn.Module):
    def __init__(self, in_channels_list: Sequence[int], out_channels: int = 256,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_levels = len(in_channels_list)
        for i, c in enumerate(in_channels_list):
            self.add_module(f"fpn_inner{i + 1}",
                            make_conv(c, out_channels, (1, 1), dtype=dtype))
            self.add_module(f"fpn_layer{i + 1}",
                            make_conv(out_channels, out_channels, (3, 3), dtype=dtype))

    def forward(self, features: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        inner = [getattr(self, f"fpn_inner{i + 1}") for i in range(self.num_levels)]
        layer = [getattr(self, f"fpn_layer{i + 1}") for i in range(self.num_levels)]

        last_inner = inner[-1](features[-1])
        results = [layer[-1](last_inner)]
        for idx in range(self.num_levels - 2, -1, -1):
            top_down = upsample_bilinear(last_inner, 2.0)
            last_inner = inner[idx](features[idx]) + top_down
            results.insert(0, layer[idx](last_inner))
        return tuple(results)
