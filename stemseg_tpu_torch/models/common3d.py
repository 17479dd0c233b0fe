"""Temporal pooling / upsampling schedules of the 3D decoders, as pure
functions of the clip length, and the 3D atrous pyramid of the dilated
decoder trunk."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from stemseg_tpu_torch.models.layers import make_conv


def get_pooling_flags(num_frames: int) -> List[bool]:
    """Which of the decoder's three pooling slots pool temporally (True) and
    which are the identity (False)."""
    if num_frames == 2:
        return [False, False, False]
    if num_frames == 4:
        return [True, False, False]
    if num_frames == 8:
        return [True, True, False]
    if num_frames in (16, 24, 32):
        return [True, True, True]
    raise NotImplementedError(f"No temporal pooling schedule for num_frames={num_frames}")


def get_temporal_scales(num_frames: int) -> List[int]:
    """Per-stage temporal upsample factors of the 32->16->8->4 cascade."""
    if num_frames == 2:
        return [1, 1, 1]
    if num_frames == 4:
        return [1, 1, 2]
    if num_frames == 8:
        return [1, 2, 2]
    if num_frames in (16, 24, 32):
        return [2, 2, 2]
    raise NotImplementedError(f"No temporal scale schedule for num_frames={num_frames}")


class AtrousPyramid3D(nn.Module):
    """3D ASPP on ``[N, C, T, H, W]``: parallel bias-free 3x3x3 convs, one
    per dilation rate (padded to keep the size), and a bias-free 1x1x1
    conv, concatenated along the channels; with ``out_channels`` then a
    ReLU and a bias-free 1x1x1 projection. Keys: ``atrous_convs.<i>.weight``
    (the 1x1x1 conv last), ``conv_out.1.weight``."""

    def __init__(self, in_channels: int, pyramid_channels: int,
                 dilation_rates: Sequence[Tuple[int, int, int]],
                 out_channels: Optional[int] = None, include_1x1_conv: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        convs = [make_conv(in_channels, pyramid_channels, (3, 3, 3), dilation=rate,
                           bias=False, dtype=dtype) for rate in dilation_rates]
        if include_1x1_conv:
            convs.append(make_conv(in_channels, pyramid_channels, (1, 1, 1), bias=False,
                                   dtype=dtype))
        self.atrous_convs = nn.ModuleList(convs)
        self.conv_out = nn.Sequential(
            nn.ReLU(), make_conv(pyramid_channels * len(convs), out_channels, (1, 1, 1),
                                 bias=False, dtype=dtype)) if out_channels else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_out(torch.cat([conv(x) for conv in self.atrous_convs], dim=1))
