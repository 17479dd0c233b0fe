"""Model assembly: backbone (ResNet body + FPN) and the 3D heads.

The module tree is named after the reference state dict (``backbone.body``,
``backbone.fpn``, ``embedding_head``, ``seediness_head``, ``semseg_head``),
so a reference ``.pth`` loads with ``load_state_dict`` and
``stemseg_tpu.models.converter.convert_state_dict`` maps ``state_dict()``
into the JAX package's variables. The streaming engine calls the backbone
once per frame and the heads once per window, so the model offers the two
halves instead of one forward.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from stemseg_tpu_torch.config import Config
from stemseg_tpu_torch.models.decoders import (
    EmbeddingDecoder,
    SeedinessDecoder,
    SemsegDecoder,
)
from stemseg_tpu_torch.models.fpn import FPN
from stemseg_tpu_torch.models.resnet import STAGE_SPECS, ResNet
from stemseg_tpu_torch.utils.device import resolve_device


class Backbone(nn.Module):
    def __init__(self, body: ResNet, fpn: FPN):
        super().__init__()
        self.body = body
        self.fpn = fpn

    def forward(self, x):
        return self.fpn(self.body(x))


class STEmSegModel(nn.Module):
    """Backbone + FPN + embedding head (seediness fused as its last channel,
    or a separate seediness head) + optional semseg head."""

    def __init__(self, cfg: Config):
        super().__init__()
        m = cfg.model
        r = m.resnets
        specs = STAGE_SPECS[m.backbone.type]
        body = ResNet(specs, num_groups=r.num_groups,
                      width_per_group=r.width_per_group,
                      stem_out_channels=r.stem_out_channels,
                      res2_out_channels=r.res2_out_channels,
                      stride_in_1x1=r.stride_in_1x1)
        stage_channels = [r.res2_out_channels * 2 ** (s.index - 1) for s in specs]
        self.backbone = Backbone(body, FPN(stage_channels, r.backbone_out_channels))

        c = r.backbone_out_channels
        e = m.embeddings
        self.embedding_head = EmbeddingDecoder(
            c, tuple(e.inter_channels), e.embedding_size, m.embedding_dim_mode,
            e.tanh_activation, seediness_output=not m.use_seediness_head,
            num_frames=cfg.input.num_frames, norm_type=e.normalization_layer,
            gn_groups=e.gn_num_groups, pool_type=e.pool_type)
        s = m.seediness
        self.seediness_head = SeedinessDecoder(
            c, tuple(s.inter_channels), num_frames=cfg.input.num_frames,
            norm_type=s.normalization_layer, gn_groups=s.gn_num_groups,
            pool_type=s.pool_type) if m.use_seediness_head else None
        g = m.semseg
        self.semseg_head = SemsegDecoder(
            c, cfg.input.num_classes, tuple(g.inter_channels),
            foreground_channel=g.foreground_channel, num_frames=cfg.input.num_frames,
            norm_type=g.normalization_layer, gn_groups=g.gn_num_groups,
            pool_type=g.pool_type) if m.use_semseg_head else None

    def backbone_features(self, frames: torch.Tensor) -> List[torch.Tensor]:
        """``[K, 3, H, W]`` preprocessed frames -> 4 maps, finest first."""
        return list(self.backbone(frames))

    def heads(self, clip_feats_coarsest_first: Sequence[torch.Tensor]):
        """4 clip maps ``[N, C, T, h_s, w_s]`` coarsest first ->
        (embedding head output, seediness or None, semseg logits or None),
        each ``[N, C', T, h, w]``."""
        feats = clip_feats_coarsest_first
        emb = self.embedding_head(feats)
        seed = self.seediness_head(feats) if self.seediness_head is not None else None
        semseg = self.semseg_head(feats) if self.semseg_head is not None else None
        return emb, seed, semseg


def build_model(cfg: Config, device="cuda") -> STEmSegModel:
    """The model in eval mode on ``device`` (raises if CUDA is asked for and
    missing). Weights are PyTorch's default init until loaded."""
    dev = resolve_device(device)
    return STEmSegModel(cfg).to(dev).eval()
