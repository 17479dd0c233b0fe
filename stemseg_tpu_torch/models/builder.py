"""Model assembly: backbone (ResNet body + FPN) and the 3D heads.

The module tree is named after the reference state dict (``backbone.body``,
``backbone.fpn``, ``embedding_head``, ``seediness_head``, ``semseg_head``),
so a reference ``.pth`` loads with ``load_state_dict`` and
``stemseg_tpu.models.converter.convert_state_dict`` maps ``state_dict()``
into the JAX package's variables. The streaming engine calls the backbone
once per frame and the heads once per window (``backbone_features``,
``heads``); the trainer calls ``forward`` on whole clips.

A model built ``for_training`` freezes what the JAX package freezes: the
stem and the stages below ``freeze_at_stage`` (``requires_grad_(False)``,
so autograd prunes their backward as the JAX ``stop_gradient`` does), or
the whole backbone, FPN included, with ``freeze_backbone``; and with
``training.loss_at_full_res`` it upscales both outputs 4x.

``dtype`` is the compute dtype of every conv (None: float32), as the JAX
package's ``build_model(..., dtype=)``: the parameters and buffers stay
float32 (so their gradients are float32) and the layers cast in their
forward; the heads' GroupNorms run in float32, as the JAX heads' do. A
model built ``for_training`` with ``training.mixed_precision`` computes in
bfloat16. The outputs are in the compute dtype.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from stemseg_tpu_torch.config import Config
from stemseg_tpu_torch.models.decoders import (
    EmbeddingDecoder,
    SeedinessDecoder,
    SemsegDecoder,
)
from stemseg_tpu_torch.models.fpn import FPN
from stemseg_tpu_torch.models.layers import upsample_trilinear
from stemseg_tpu_torch.models.resnet import STAGE_SPECS, ResNet
from stemseg_tpu_torch.utils.constants import ModelOutputConsts as ModelOutput
from stemseg_tpu_torch.utils.device import resolve_device


class Backbone(nn.Module):
    """ResNet body + FPN. With ``remat`` the body's activations are
    recomputed in the backward instead of kept (``torch.utils.checkpoint``)."""

    def __init__(self, body: ResNet, fpn: FPN, remat: bool = False):
        super().__init__()
        self.body = body
        self.fpn = fpn
        self.remat = remat

    def forward(self, x):
        if self.remat and torch.is_grad_enabled():
            return self.fpn(checkpoint(self.body, x, use_reentrant=False))
        return self.fpn(self.body(x))


class STEmSegModel(nn.Module):
    """Backbone + FPN + embedding head (seediness fused as its last channel,
    or a separate seediness head) + optional semseg head."""

    def __init__(self, cfg: Config, for_training: bool = False, remat: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.compute_dtype = dtype
        m = cfg.model
        r = m.resnets
        specs = STAGE_SPECS[m.backbone.type]
        body = ResNet(specs, num_groups=r.num_groups,
                      width_per_group=r.width_per_group,
                      stem_out_channels=r.stem_out_channels,
                      res2_out_channels=r.res2_out_channels,
                      stride_in_1x1=r.stride_in_1x1, dtype=dtype)
        stage_channels = [r.res2_out_channels * 2 ** (s.index - 1) for s in specs]
        self.backbone = Backbone(body, FPN(stage_channels, r.backbone_out_channels, dtype),
                                 remat=remat)

        c = r.backbone_out_channels
        e = m.embeddings
        self.embedding_head = EmbeddingDecoder(
            c, tuple(e.inter_channels), e.embedding_size, m.embedding_dim_mode,
            e.tanh_activation, seediness_output=not m.use_seediness_head,
            num_frames=cfg.input.num_frames, norm_type=e.normalization_layer,
            gn_groups=e.gn_num_groups, pool_type=e.pool_type, dtype=dtype)
        s = m.seediness
        self.seediness_head = SeedinessDecoder(
            c, tuple(s.inter_channels), num_frames=cfg.input.num_frames,
            norm_type=s.normalization_layer, gn_groups=s.gn_num_groups,
            pool_type=s.pool_type, dtype=dtype) if m.use_seediness_head else None
        g = m.semseg
        self.semseg_head = SemsegDecoder(
            c, cfg.input.num_classes, tuple(g.inter_channels),
            foreground_channel=g.foreground_channel, num_frames=cfg.input.num_frames,
            norm_type=g.normalization_layer, gn_groups=g.gn_num_groups,
            pool_type=g.pool_type, dtype=dtype) if m.use_semseg_head else None

        self.output_resize_scale = 4.0 if for_training and cfg.training.loss_at_full_res else 1.0
        self.freeze_backbone = for_training and cfg.training.freeze_backbone
        if for_training:
            freeze_at_stage = m.backbone.freeze_at_stage
            if freeze_at_stage >= 1:
                body.stem.requires_grad_(False)
            for i in range(1, freeze_at_stage):
                getattr(body, f"layer{i}").requires_grad_(False)
            if self.freeze_backbone:
                self.backbone.requires_grad_(False)

    def forward(self, images: torch.Tensor) -> Dict[str, Optional[torch.Tensor]]:
        """Training forward of whole clips ``[N, T, 3, H, W]`` (preprocessed,
        padded to /32): ``embeddings`` ``[N, E + V + 1, T, h, w]`` (channel
        order emb | var | seed) and ``semseg_masks`` ``[N, classes (+1), T,
        h, w]`` or None, at a quarter of the input size, or at full size
        with ``loss_at_full_res``.

        ``TrainStep`` makes these two calls itself, with its span
        ``step.backbone`` around the first: what this method adds to them
        goes there too."""
        return self.clip_heads(self.clip_features(images))

    def clip_features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """Backbone + FPN on all ``N·T`` frames of ``[N, T, 3, H, W]`` clips
        -> 4 maps ``[N, C, T, h_s, w_s]``, coarsest first."""
        n, t = images.shape[:2]
        with torch.set_grad_enabled(torch.is_grad_enabled() and not self.freeze_backbone):
            feats = self.backbone(images.reshape(n * t, *images.shape[2:]))
        return [f.reshape(n, t, *f.shape[1:]).permute(0, 2, 1, 3, 4) for f in feats[::-1]]

    def clip_heads(self, clip_feats_coarsest_first: Sequence[torch.Tensor]
                   ) -> Dict[str, Optional[torch.Tensor]]:
        """The heads once per clip; the seediness head's channel goes last."""
        emb, seed, semseg = self.heads(clip_feats_coarsest_first)
        if seed is not None:
            emb = torch.cat([emb, seed], dim=1)
        if self.output_resize_scale != 1.0:
            s = self.output_resize_scale
            emb = upsample_trilinear(emb, (1.0, s, s))
            if semseg is not None:
                semseg = upsample_trilinear(semseg, (1.0, s, s))
        return {ModelOutput.EMBEDDINGS: emb, ModelOutput.SEMSEG_MASKS: semseg}

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


def build_model(cfg: Config, device="cuda", for_training: bool = False,
                remat: bool = False, dtype: Optional[torch.dtype] = None) -> STEmSegModel:
    """The model on ``device`` (raises if CUDA is asked for and missing), in
    eval mode, or in train mode with its frozen parameters marked when
    ``for_training``. Weights are PyTorch's default init until loaded.
    ``dtype`` is the compute dtype; None gives bfloat16 for a training model
    of a ``training.mixed_precision`` config, else float32."""
    if dtype is None and for_training and cfg.training.mixed_precision:
        dtype = torch.bfloat16
    dev = resolve_device(device)
    model = STEmSegModel(cfg, for_training=for_training, remat=remat, dtype=dtype).to(dev)
    return model.train(for_training)
