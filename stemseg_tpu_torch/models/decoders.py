"""3D squeeze-expand decoders: the embedding, seediness and semseg heads.

All three heads share one topology over the 4 FPN maps lifted to clips
``[N, C, T, H, W]``, coarsest first:

* per-scale "squeeze" blocks of Conv3d(3x3x3) + norm + ReLU + a temporal
  stride-(2,1,1) pool; the 32x block has 3 such slots, 16x has 2, 8x one,
  4x a single conv without pool. Which slots pool follows the clip length.
* with ``trunk_type="squeeze_expand_dilated_decoder"`` the 32x and 16x
  blocks are 3D atrous pyramids (``AtrousPyramid3D``: rates (1,3,3),
  (1,6,6), (1,9,9) at 32x, (1,4,4), (1,8,8), (1,12,12) at 16x, 64 channels
  each, projected to the block's width) + norm + ReLU + a temporal-only
  (3,1,1) pool, in the same slots; no preset selects this trunk.
* an "expand" cascade: trilinear upsample by (t_scale, 2, 2), concat with
  the next finer map, bias-free 1x1x1 conv. It is computed as
  ``up(conv_a(a)) + conv_b(b)`` with the two slices of the one weight: a
  1x1x1 conv and a trilinear interpolation commute, so the ``a`` half runs
  at the coarse resolution.

Module names are the reference state-dict keys: ``block_32x.4.weight`` is
the second conv of the 32x block (each slot is conv, norm, ReLU, pool),
``conv_16.weight`` the first expand conv; in the dilated trunk
``block_32x.0.atrous_convs.1.weight`` is the 32x block's first pyramid's
second rate.

With a compute ``dtype`` every conv of a head computes in it, and the
expand step casts both of its inputs to it, as the JAX ``FuseConv`` does;
the GroupNorms stay float32, as the JAX heads' do.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from stemseg_tpu_torch.models.common3d import (
    AtrousPyramid3D,
    get_pooling_flags,
    get_temporal_scales,
)
from stemseg_tpu_torch.models.embedding_utils import (
    add_spatiotemporal_offset,
    get_nb_embedding_dims,
    get_nb_free_dims,
)
from stemseg_tpu_torch.models.layers import (
    avg_pool_3d,
    group_norm,
    make_conv,
    max_pool_3d,
    upsample_trilinear,
)


TRUNK_TYPES = ("squeeze_expand_decoder", "squeeze_expand_dilated_decoder")
ASPP_RATES = {"block_32x": ((1, 3, 3), (1, 6, 6), (1, 9, 9)),
              "block_16x": ((1, 4, 4), (1, 8, 8), (1, 12, 12))}


class TemporalPool(nn.Module):
    """Stride (2,1,1), avg or max; a 3x3x3 window padded 1, or in the
    dilated trunk's pyramid blocks a (3,1,1) window padded (1,0,0)."""

    def __init__(self, pool_type: str, window=(3, 3, 3), padding=(1, 1, 1)):
        super().__init__()
        if pool_type not in ("avg", "max"):
            raise ValueError(f"Unknown pool type {pool_type!r}")
        self.pool_type = pool_type
        self.window = tuple(window)
        self.padding = tuple(padding)

    def forward(self, x):
        pool = avg_pool_3d if self.pool_type == "avg" else max_pool_3d
        return pool(x, self.window, (2, 1, 1), self.padding)


def _norm(norm_type: str, gn_groups: int, channels: int) -> nn.Module:
    if norm_type == "gn":
        return group_norm(gn_groups, channels)
    if norm_type == "none":
        return nn.Identity()
    raise ValueError(f"Unknown normalization layer {norm_type!r}")


def _fuse(conv: nn.Conv3d, a: torch.Tensor, b: torch.Tensor,
          t_scale: float) -> torch.Tensor:
    in_a = a.shape[1]
    weight = conv.weight
    if conv.compute_dtype is not None:
        a, b, weight = (t.to(conv.compute_dtype) for t in (a, b, weight))
    ya = F.conv3d(a, weight[:, :in_a])
    yb = F.conv3d(b, weight[:, in_a:])
    return upsample_trilinear(ya, (t_scale, 2.0, 2.0)) + yb


class SqueezeExpandDecoder(nn.Module):
    """The shared trunk, plain or dilated (``trunk_type``). Input: 4 maps
    coarsest first (32x, 16x, 8x, 4x), each ``[N, C_in, T, H_s, W_s]``.
    Output ``[N, inter[-1], T, H/4, W/4]``."""

    def __init__(self, in_channels: int,
                 inter_channels: Tuple[int, int, int, int] = (256, 256, 128, 128),
                 num_frames: int = 8, norm_type: str = "gn", gn_groups: int = 32,
                 pool_type: str = "avg", dtype: Optional[torch.dtype] = None,
                 trunk_type: str = "squeeze_expand_decoder"):
        super().__init__()
        if trunk_type not in TRUNK_TYPES:
            raise ValueError(f"Unknown trunk type {trunk_type!r}; expected one of {TRUNK_TYPES}")
        dilated = trunk_type == "squeeze_expand_dilated_decoder"
        c32, c16, c8, c4 = inter_channels
        pool_flags = get_pooling_flags(num_frames)
        self.t_scales = get_temporal_scales(num_frames)

        def block(n_slots, ch, pool=True, rates=None):
            layers, c_in = [], in_channels
            for slot in range(n_slots):
                if rates is None:
                    layers.append(make_conv(c_in, ch, (3, 3, 3), dtype=dtype))
                    slot_pool = TemporalPool(pool_type)
                else:
                    layers.append(AtrousPyramid3D(c_in, 64, rates, ch, dtype=dtype))
                    slot_pool = TemporalPool(pool_type, (3, 1, 1), (1, 0, 0))
                layers += [_norm(norm_type, gn_groups, ch), nn.ReLU()]
                if pool:
                    layers.append(slot_pool if pool_flags[slot] else nn.Identity())
                c_in = ch
            return nn.Sequential(*layers)

        self.block_32x = block(3, c32, rates=ASPP_RATES["block_32x"] if dilated else None)
        self.block_16x = block(2, c16, rates=ASPP_RATES["block_16x"] if dilated else None)
        self.block_8x = block(1, c8)
        self.block_4x = block(1, c4, pool=False)
        self.conv_16 = make_conv(c32 + c16, c16, (1, 1, 1), bias=False, dtype=dtype)
        self.conv_8 = make_conv(c16 + c8, c8, (1, 1, 1), bias=False, dtype=dtype)
        self.conv_4 = make_conv(c8 + c4, c4, (1, 1, 1), bias=False, dtype=dtype)

    def trunk(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(feats) != 4:
            raise ValueError(f"Expected 4 feature maps, got {len(feats)}")
        f32, f16, f8, f4 = feats
        x = _fuse(self.conv_16, self.block_32x(f32), self.block_16x(f16),
                  self.t_scales[0])
        x = _fuse(self.conv_8, x, self.block_8x(f8), self.t_scales[1])
        return _fuse(self.conv_4, x, self.block_4x(f4), self.t_scales[2])


class EmbeddingDecoder(SqueezeExpandDecoder):
    """Trunk + ``conv_embedding`` (optionally ``tanh(0.25 x)``) plus the
    coordinate grid, ``conv_variance`` and an optional fused
    ``conv_seediness``. Output ``[N, E + V (+1), T, H/4, W/4]``, channel
    order (emb | var | seed)."""

    def __init__(self, in_channels: int,
                 inter_channels: Tuple[int, int, int, int] = (256, 256, 128, 128),
                 embedding_size: int = 3, embedding_dim_mode: str = "xyt",
                 tanh_activation: bool = True, seediness_output: bool = True,
                 num_frames: int = 8, norm_type: str = "gn", gn_groups: int = 32,
                 pool_type: str = "avg", dtype: Optional[torch.dtype] = None,
                 trunk_type: str = "squeeze_expand_decoder"):
        super().__init__(in_channels, inter_channels, num_frames, norm_type,
                         gn_groups, pool_type, dtype, trunk_type)
        self.embedding_dim_mode = embedding_dim_mode
        self.tanh_activation = tanh_activation
        c = inter_channels[-1]
        n_free = get_nb_free_dims(embedding_dim_mode)
        self.conv_embedding = make_conv(
            c, get_nb_embedding_dims(embedding_dim_mode), (1, 1, 1), bias=False, dtype=dtype)
        self.conv_variance = make_conv(c, embedding_size - n_free, (1, 1, 1), dtype=dtype)
        self.conv_seediness = (make_conv(c, 1, (1, 1, 1), bias=False, dtype=dtype)
                               if seediness_output else None)
        # 1.0 unless a checkpoint overwrites it
        self.register_buffer("time_scale", torch.tensor(1.0))

    def forward(self, feats_coarsest_first: Sequence[torch.Tensor]) -> torch.Tensor:
        x = self.trunk(feats_coarsest_first)
        embeddings = self.conv_embedding(x)
        if self.tanh_activation:
            embeddings = torch.tanh(embeddings * 0.25)
        embeddings = add_spatiotemporal_offset(embeddings, self.time_scale,
                                               self.embedding_dim_mode)
        outs = [embeddings, self.conv_variance(x)]
        if self.conv_seediness is not None:
            outs.append(torch.sigmoid(self.conv_seediness(x)))
        return torch.cat(outs, dim=1)


class SeedinessDecoder(SqueezeExpandDecoder):
    """Separate seediness head (DAVIS configs): trunk + 1-channel sigmoid,
    whose output conv is named ``conv_out``."""

    def __init__(self, in_channels: int,
                 inter_channels: Tuple[int, int, int, int] = (256, 256, 128, 128),
                 num_frames: int = 8, norm_type: str = "gn", gn_groups: int = 32,
                 pool_type: str = "avg", dtype: Optional[torch.dtype] = None,
                 trunk_type: str = "squeeze_expand_decoder"):
        super().__init__(in_channels, inter_channels, num_frames, norm_type,
                         gn_groups, pool_type, dtype, trunk_type)
        self.conv_out = make_conv(inter_channels[-1], 1, (1, 1, 1), bias=False, dtype=dtype)

    def forward(self, feats_coarsest_first: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.sigmoid(self.conv_out(self.trunk(feats_coarsest_first)))


class SemsegDecoder(SqueezeExpandDecoder):
    """Semantic segmentation head (YT-VIS and KITTI-MOTS configs): trunk + a
    bias-free ``conv_out`` with ``num_classes`` (+1 foreground) logit
    channels, no activation."""

    def __init__(self, in_channels: int, num_classes: int,
                 inter_channels: Tuple[int, int, int, int] = (256, 256, 128, 128),
                 foreground_channel: bool = True, num_frames: int = 8,
                 norm_type: str = "gn", gn_groups: int = 32, pool_type: str = "avg",
                 dtype: Optional[torch.dtype] = None,
                 trunk_type: str = "squeeze_expand_decoder"):
        super().__init__(in_channels, inter_channels, num_frames, norm_type,
                         gn_groups, pool_type, dtype, trunk_type)
        out_channels = num_classes + 1 if foreground_channel else num_classes
        self.conv_out = make_conv(inter_channels[-1], out_channels, (1, 1, 1), bias=False,
                                  dtype=dtype)

    def forward(self, feats_coarsest_first: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.conv_out(self.trunk(feats_coarsest_first))
