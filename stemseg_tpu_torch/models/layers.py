"""Primitive layers shared by the backbone and the 3D decoders.

Tensors are channels-first, as cuDNN wants them: ``[N, C, H, W]`` for
frames and ``[N, C, T, H, W]`` for video clips.

Mixed precision follows the JAX package's ``dtype`` field, not autocast:
the parameters stay float32 and a layer built with a compute dtype
(``dtype=torch.bfloat16``) casts to it in its forward.

* ``FrozenBatchNorm``: the four batch-norm statistics are fixed buffers, so
  the layer is a per-channel multiply-add in the input's dtype; ``eps`` is 0
  as in the reference.
* ``make_conv``: a 2D or 3D conv whose default padding is
  ``dilation * (k - 1) // 2`` per spatial dim, symmetric; with a compute
  dtype it casts its input, weight and bias to it.
* ``group_norm``: GroupNorm with eps 1e-5, always in float32 (the
  following conv casts back to the compute dtype).
* the 3D pools are stride-(2,1,1) temporal pools with zero padding counted
  in the average (``count_include_pad=True``, PyTorch's default).
* the resizes use the half-pixel convention (``align_corners=False``)
  without antialiasing, also when they downsample.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class FrozenBatchNorm(nn.Module):
    """``x * scale + shift`` with ``scale = weight * rsqrt(running_var + eps)``
    and ``shift = bias - running_mean * scale``, per channel (dim 1)."""

    def __init__(self, num_features: int, eps: float = 0.0):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        view = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.view(view).to(x.dtype) + shift.view(view).to(x.dtype)


class _ComputeDtypeConv:
    """Casts the input, weight and bias to ``compute_dtype`` (when set) before
    the convolution, as a flax ``Conv(dtype=...)`` does."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x):
        d = self.compute_dtype
        if d is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(d)
        return self._conv_forward(x.to(d), self.weight.to(d), bias)


class Conv2d(_ComputeDtypeConv, nn.Conv2d):
    pass


class Conv3d(_ComputeDtypeConv, nn.Conv3d):
    pass


def make_conv(in_channels: int, out_channels: int, kernel_size: Sequence[int],
              stride: Optional[Sequence[int]] = None,
              padding: Optional[Sequence[int]] = None,
              dilation: Optional[Sequence[int]] = None,
              groups: int = 1, bias: bool = True,
              dtype: Optional[torch.dtype] = None) -> nn.Module:
    """A 2D or 3D conv by the length of ``kernel_size``, computing in
    ``dtype`` (None: the input's)."""
    kernel_size = tuple(kernel_size)
    nd = len(kernel_size)
    stride = tuple(stride) if stride else (1,) * nd
    dilation = tuple(dilation) if dilation else (1,) * nd
    if padding is None:
        padding = tuple(d * (k - 1) // 2 for k, d in zip(kernel_size, dilation))
    cls = {2: Conv2d, 3: Conv3d}[nd]
    conv = cls(in_channels, out_channels, kernel_size, stride=stride,
               padding=tuple(padding), dilation=dilation, groups=groups,
               bias=bias)
    conv.compute_dtype = dtype
    return conv


class GroupNorm(nn.GroupNorm):
    """``nn.GroupNorm`` in float32: a bfloat16 input is normalised in float32
    and the result stays float32, the promotion of the input with the
    float32 affine that flax's GroupNorm applies when it has no dtype (the
    JAX heads build theirs so)."""

    def forward(self, x):
        return super().forward(x.float())


def group_norm(num_groups: int, num_channels: int) -> GroupNorm:
    return GroupNorm(num_groups, num_channels, eps=1e-5)


def _pad(x: torch.Tensor, padding: Sequence[int], value: float) -> torch.Tensor:
    # explicit padding: PyTorch's pools reject inputs smaller than the
    # window before padding (e.g. a 2-row map at the 32x scale)
    pads = []
    for p in reversed(padding):
        pads += [p, p]
    return F.pad(x, pads, value=value)


def avg_pool_3d(x: torch.Tensor, window: Tuple[int, int, int],
                strides: Tuple[int, int, int],
                padding: Tuple[int, int, int]) -> torch.Tensor:
    """AvgPool3d whose divisor is the full window, padded zeros included."""
    return F.avg_pool3d(_pad(x, padding, 0.0), window, strides)


def max_pool_3d(x: torch.Tensor, window: Tuple[int, int, int],
                strides: Tuple[int, int, int],
                padding: Tuple[int, int, int]) -> torch.Tensor:
    return F.max_pool3d(_pad(x, padding, float("-inf")), window, strides)


def max_pool_2d(x: torch.Tensor, window: Tuple[int, int],
                strides: Tuple[int, int], padding: Tuple[int, int]) -> torch.Tensor:
    return F.max_pool2d(_pad(x, padding, float("-inf")), window, strides)


def upsample_trilinear(x: torch.Tensor,
                       scale_factor: Tuple[float, float, float]) -> torch.Tensor:
    """Trilinear upsample of ``[N, C, T, H, W]``; output size is
    ``floor(in * scale)`` per dim."""
    t, h, w = x.shape[-3:]
    size = (int(t * scale_factor[0]), int(h * scale_factor[1]),
            int(w * scale_factor[2]))
    return F.interpolate(x, size=size, mode="trilinear", align_corners=False)


def upsample_bilinear(x: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Bilinear upsample of ``[N, C, H, W]`` (the FPN top-down path)."""
    h, w = x.shape[-2:]
    size = (int(h * scale_factor), int(w * scale_factor))
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False)


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of ``[..., H, W]`` to exactly ``out_hw``, half-pixel
    convention, no antialiasing (also when it downsamples)."""
    lead, (h, w) = x.shape[:-2], x.shape[-2:]
    y = F.interpolate(x.reshape(-1, 1, h, w), size=tuple(out_hw),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.reshape(*lead, *out_hw)
