"""ResNet-50/101 backbone body with FrozenBatchNorm.

Module names are the reference state-dict keys (``stem.conv1``,
``layer{i}.{j}.conv{1,2,3}``, ``layer{i}.{j}.downsample.{0,1}``), so a
reference ``.pth`` loads with ``load_state_dict`` as it is.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from stemseg_tpu_torch.models.layers import FrozenBatchNorm, make_conv, max_pool_2d


class StageSpec(NamedTuple):
    index: int
    block_count: int
    return_features: bool


RESNET50_FPN_STAGES = tuple(StageSpec(i, c, True) for i, c in ((1, 3), (2, 4), (3, 6), (4, 3)))
RESNET101_FPN_STAGES = tuple(StageSpec(i, c, True) for i, c in ((1, 3), (2, 4), (3, 23), (4, 3)))

STAGE_SPECS = {
    "R-50-FPN": RESNET50_FPN_STAGES,
    "R-101-FPN": RESNET101_FPN_STAGES,
    # ResNeXt-101: same stage layout, grouped width from the config
    "X-101-FPN": RESNET101_FPN_STAGES,
}


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with FrozenBN and a projection shortcut
    when the channel count changes. ``stride_in_1x1`` puts the stride on the
    first 1x1 conv (the convention of the pretrained Mask R-CNN weights).
    The convs compute in ``dtype`` (None: the input's)."""

    def __init__(self, in_channels: int, bottleneck_channels: int,
                 out_channels: int, num_groups: int = 1,
                 stride_in_1x1: bool = True, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        stride_1x1, stride_3x3 = (stride, 1) if stride_in_1x1 else (1, stride)
        self.conv1 = make_conv(in_channels, bottleneck_channels, (1, 1),
                               stride=(stride_1x1, stride_1x1), bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(bottleneck_channels)
        self.conv2 = make_conv(bottleneck_channels, bottleneck_channels, (3, 3),
                               stride=(stride_3x3, stride_3x3), padding=(1, 1),
                               groups=num_groups, bias=False, dtype=dtype)
        self.bn2 = FrozenBatchNorm(bottleneck_channels)
        self.conv3 = make_conv(bottleneck_channels, out_channels, (1, 1), bias=False,
                               dtype=dtype)
        self.bn3 = FrozenBatchNorm(out_channels)
        self.downsample = None
        if in_channels != out_channels:
            self.downsample = nn.Sequential(
                make_conv(in_channels, out_channels, (1, 1),
                          stride=(stride, stride), bias=False, dtype=dtype),
                FrozenBatchNorm(out_channels))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Stem(nn.Module):
    """7x7/2 conv + FrozenBN + ReLU + 3x3/2 max pool."""

    def __init__(self, out_channels: int = 64, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = make_conv(3, out_channels, (7, 7), stride=(2, 2),
                               padding=(3, 3), bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(out_channels)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return max_pool_2d(x, (3, 3), (2, 2), (1, 1))


class ResNet(nn.Module):
    """Stem + 4 stages; returns every stage's map (strides 4, 8, 16, 32)."""

    def __init__(self, stage_specs: Sequence[StageSpec] = RESNET101_FPN_STAGES,
                 num_groups: int = 1, width_per_group: int = 64,
                 stem_out_channels: int = 64, res2_out_channels: int = 256,
                 stride_in_1x1: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.stem = Stem(stem_out_channels, dtype=dtype)
        self.stage_specs = tuple(stage_specs)
        in_channels = stem_out_channels
        for spec in self.stage_specs:
            factor = 2 ** (spec.index - 1)
            bottleneck_channels = num_groups * width_per_group * factor
            out_channels = res2_out_channels * factor
            first_stride = 1 if spec.index == 1 else 2
            blocks = []
            for block_idx in range(spec.block_count):
                blocks.append(Bottleneck(
                    in_channels, bottleneck_channels, out_channels,
                    num_groups=num_groups, stride_in_1x1=stride_in_1x1,
                    stride=first_stride if block_idx == 0 else 1, dtype=dtype))
                in_channels = out_channels
            self.add_module(f"layer{spec.index}", nn.Sequential(*blocks))

    def forward(self, x) -> List[torch.Tensor]:
        x = self.stem(x)
        outputs = []
        for spec in self.stage_specs:
            x = getattr(self, f"layer{spec.index}")(x)
            if spec.return_features:
                outputs.append(x)
        return outputs
