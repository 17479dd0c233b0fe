"""Plain float32 STEm-Seg model: ResNet-101 body with frozen batch norm, FPN,
and the squeeze-expand 3D heads (embedding, seediness, semseg).

A frozen copy written from the published architecture (github.com/sabarim/
STEm-Seg, ``stemseg/modeling``) in plain PyTorch, with the module names of
the reference state dict, so that one state dict loads here and into the
system under test. Departures from the published code, all shared with the
system under test:

* the expand step computes ``up(conv_a(a)) + conv_b(b)`` with the two
  slices of the one 1x1x1 weight instead of ``conv(cat(up(a), b))``: a
  1x1x1 conv and a trilinear upsample commute, so the two are equal up to
  rounding;
* the 3D pools count the zero padding in the average, and all resizes use
  the half-pixel convention without antialiasing.

No compute dtype, no remat, no dilated trunk: the configurations measured
use none of them. Nothing here imports the system under test.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

STAGES = {"R-50-FPN": (3, 4, 6, 3), "R-101-FPN": (3, 4, 23, 3)}
EMB_DIMS = {"xy": 2, "ff": 2, "xyt": 3, "xyf": 3, "xytf": 4, "xyff": 4, "xytff": 5,
            "xyfff": 5}
FREE_DIMS = {"xyf": 1, "xytf": 1, "xyff": 2, "xytff": 2, "xyfff": 3}
GRID = {"xy": "yx", "xyt": "tyx", "xyf": "yx0", "xytf": "tyx0", "xyff": "yx00",
        "xytff": "tyx00", "xyfff": "yx000"}
POOL_FLAGS = {2: (0, 0, 0), 4: (1, 0, 0), 8: (1, 1, 0), 16: (1, 1, 1), 24: (1, 1, 1),
              32: (1, 1, 1)}
T_SCALES = {2: (1, 1, 1), 4: (1, 1, 2), 8: (1, 2, 2), 16: (2, 2, 2), 24: (2, 2, 2),
            32: (2, 2, 2)}


def conv(cin, cout, k, stride=1, bias=True, groups=1):
    """2D or 3D conv by the length of ``k``, padded to keep the size."""
    cls = nn.Conv2d if len(k) == 2 else nn.Conv3d
    return cls(cin, cout, k, stride=stride, padding=tuple(x // 2 for x in k), bias=bias,
               groups=groups)


class FrozenBN(nn.Module):
    def __init__(self, n):
        super().__init__()
        for name, init in (("weight", torch.ones), ("bias", torch.zeros),
                           ("running_mean", torch.zeros), ("running_var", torch.ones)):
            self.register_buffer(name, init(n))

    def forward(self, x):
        scale = self.weight * torch.rsqrt(self.running_var)  # eps 0, as published
        shift = self.bias - self.running_mean * scale
        view = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.view(view) + shift.view(view)


class Bottleneck(nn.Module):
    def __init__(self, cin, mid, cout, stride, groups=1):
        super().__init__()
        # stride on the first 1x1 conv (the Mask R-CNN weights' convention)
        self.conv1, self.bn1 = conv(cin, mid, (1, 1), stride, False), FrozenBN(mid)
        self.conv2, self.bn2 = conv(mid, mid, (3, 3), 1, False, groups), FrozenBN(mid)
        self.conv3, self.bn3 = conv(mid, cout, (1, 1), 1, False), FrozenBN(cout)
        self.downsample = (nn.Sequential(conv(cin, cout, (1, 1), stride, False),
                                         FrozenBN(cout)) if cin != cout else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class Stem(nn.Module):
    def __init__(self, cout):
        super().__init__()
        self.conv1, self.bn1 = conv(3, cout, (7, 7), 2, False), FrozenBN(cout)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(F.pad(x, (1, 1, 1, 1), value=float("-inf")), 3, 2)


class ResNet(nn.Module):
    def __init__(self, blocks, groups, width, stem_out, res2_out):
        super().__init__()
        self.stem = Stem(stem_out)
        cin = stem_out
        for i, n in enumerate(blocks, start=1):
            mid, cout = groups * width * 2 ** (i - 1), res2_out * 2 ** (i - 1)
            layer = []
            for j in range(n):
                layer.append(Bottleneck(cin, mid, cout, 2 if (j == 0 and i > 1) else 1, groups))
                cin = cout
            self.add_module(f"layer{i}", nn.Sequential(*layer))
        self.n_stages = len(blocks)

    def forward(self, x):
        x, out = self.stem(x), []
        for i in range(1, self.n_stages + 1):
            x = getattr(self, f"layer{i}")(x)
            out.append(x)
        return out


def up2d(x):
    return F.interpolate(x, size=(x.shape[-2] * 2, x.shape[-1] * 2), mode="bilinear",
                         align_corners=False)


def up3d(x, scale):
    t, h, w = x.shape[-3:]
    size = (int(t * scale[0]), int(h * scale[1]), int(w * scale[2]))
    return F.interpolate(x, size=size, mode="trilinear", align_corners=False)


class FPN(nn.Module):
    def __init__(self, in_channels, cout):
        super().__init__()
        self.n = len(in_channels)
        for i, c in enumerate(in_channels, start=1):
            self.add_module(f"fpn_inner{i}", conv(c, cout, (1, 1)))
            self.add_module(f"fpn_layer{i}", conv(cout, cout, (3, 3)))

    def forward(self, feats):
        inner = getattr(self, f"fpn_inner{self.n}")(feats[-1])
        out = [getattr(self, f"fpn_layer{self.n}")(inner)]
        for i in range(self.n - 1, 0, -1):
            inner = getattr(self, f"fpn_inner{i}")(feats[i - 1]) + up2d(inner)
            out.insert(0, getattr(self, f"fpn_layer{i}")(inner))
        return out  # finest first


class Backbone(nn.Module):
    def __init__(self, body, fpn):
        super().__init__()
        self.body, self.fpn = body, fpn

    def forward(self, x):
        return self.fpn(self.body(x))


class TemporalPool(nn.Module):
    def __init__(self, kind):
        super().__init__()
        self.kind = kind

    def forward(self, x):
        if self.kind == "avg":  # divisor the full window, padding counted
            return F.avg_pool3d(F.pad(x, (1,) * 6), 3, (2, 1, 1))
        return F.max_pool3d(F.pad(x, (1,) * 6, value=float("-inf")), 3, (2, 1, 1))


class Trunk(nn.Module):
    """Squeeze blocks per scale and the expand cascade; output at 1/4."""

    def __init__(self, cin, inter, num_frames, gn_groups, pool_type):
        super().__init__()
        flags = POOL_FLAGS[num_frames]
        self.t_scales = T_SCALES[num_frames]

        def block(n_slots, ch, pool=True):
            layers, c = [], cin
            for slot in range(n_slots):
                layers += [conv(c, ch, (3, 3, 3)), nn.GroupNorm(gn_groups, ch, eps=1e-5),
                           nn.ReLU()]
                if pool:
                    layers.append(TemporalPool(pool_type) if flags[slot] else nn.Identity())
                c = ch
            return nn.Sequential(*layers)

        c32, c16, c8, c4 = inter
        self.block_32x, self.block_16x = block(3, c32), block(2, c16)
        self.block_8x, self.block_4x = block(1, c8), block(1, c4, pool=False)
        self.conv_16 = conv(c32 + c16, c16, (1, 1, 1), bias=False)
        self.conv_8 = conv(c16 + c8, c8, (1, 1, 1), bias=False)
        self.conv_4 = conv(c8 + c4, c4, (1, 1, 1), bias=False)

    @staticmethod
    def fuse(conv_ab, a, b, t_scale):
        w, n_a = conv_ab.weight, a.shape[1]
        return up3d(F.conv3d(a, w[:, :n_a]), (t_scale, 2, 2)) + F.conv3d(b, w[:, n_a:])

    def trunk(self, feats):
        f32, f16, f8, f4 = feats
        x = self.fuse(self.conv_16, self.block_32x(f32), self.block_16x(f16), self.t_scales[0])
        x = self.fuse(self.conv_8, x, self.block_8x(f8), self.t_scales[1])
        return self.fuse(self.conv_4, x, self.block_4x(f4), self.t_scales[2])


def grid(h, w, t, t_scale, mode, device):
    x_abs, y_abs = max(1.0, w / float(h)), max(1.0, h / float(w))
    tt = torch.linspace(-1.0, 1.0, t, device=device) * t_scale
    yy = torch.linspace(-y_abs, y_abs, h, device=device)
    xx = torch.linspace(-x_abs, x_abs, w, device=device)
    tg, yg, xg = torch.meshgrid(tt, yy, xx, indexing="ij")
    by = {"t": tg, "y": yg, "x": xg, "0": torch.zeros_like(xg)}
    return torch.stack([by[c] for c in GRID[mode]])[None]


class EmbeddingHead(Trunk):
    def __init__(self, cin, inter, emb_size, mode, tanh, seediness_output, num_frames,
                 gn_groups, pool_type):
        super().__init__(cin, inter, num_frames, gn_groups, pool_type)
        self.mode, self.tanh = mode, tanh
        self.conv_embedding = conv(inter[-1], EMB_DIMS[mode], (1, 1, 1), bias=False)
        self.conv_variance = conv(inter[-1], emb_size - FREE_DIMS.get(mode, 0), (1, 1, 1))
        self.conv_seediness = (conv(inter[-1], 1, (1, 1, 1), bias=False)
                               if seediness_output else None)
        self.register_buffer("time_scale", torch.tensor(1.0))

    def forward(self, feats):
        x = self.trunk(feats)
        e = self.conv_embedding(x)
        if self.tanh:
            e = torch.tanh(e * 0.25)
        if self.mode != "ff":
            e = e + grid(*e.shape[-2:], e.shape[-3], self.time_scale, self.mode, e.device)
        outs = [e, self.conv_variance(x)]
        if self.conv_seediness is not None:
            outs.append(torch.sigmoid(self.conv_seediness(x)))
        return torch.cat(outs, dim=1)


class OutHead(Trunk):
    """The seediness head (sigmoid) or the semseg head (logits)."""

    def __init__(self, cin, inter, cout, num_frames, gn_groups, pool_type, sigmoid):
        super().__init__(cin, inter, num_frames, gn_groups, pool_type)
        self.conv_out = conv(inter[-1], cout, (1, 1, 1), bias=False)
        self.sigmoid = sigmoid

    def forward(self, feats):
        y = self.conv_out(self.trunk(feats))
        return torch.sigmoid(y) if self.sigmoid else y


class Model(nn.Module):
    """``cfg``: the configuration file's nested dict (the system's full
    config tree as it is run)."""

    def __init__(self, cfg: Dict):
        super().__init__()
        m, r = cfg["model"], cfg["model"]["resnets"]
        nf = cfg["input"]["num_frames"]
        blocks = STAGES[m["backbone"]["type"]]
        body = ResNet(blocks, r["num_groups"], r["width_per_group"], r["stem_out_channels"],
                      r["res2_out_channels"])
        c = r["backbone_out_channels"]
        self.backbone = Backbone(body, FPN([r["res2_out_channels"] * 2 ** i
                                            for i in range(len(blocks))], c))
        e = m["embeddings"]
        for h in (e, m["seediness"], m["semseg"]):
            if h["normalization_layer"] != "gn":
                raise ValueError("the reference holds the GroupNorm heads only")
        self.embedding_head = EmbeddingHead(
            c, e["inter_channels"], e["embedding_size"], m["embedding_dim_mode"],
            e["tanh_activation"], not m["use_seediness_head"], nf, e["gn_num_groups"],
            e["pool_type"])
        s = m["seediness"]
        self.seediness_head = (OutHead(c, s["inter_channels"], 1, nf, s["gn_num_groups"],
                                       s["pool_type"], True)
                               if m["use_seediness_head"] else None)
        g = m["semseg"]
        n_out = cfg["input"]["num_classes"] + (1 if g["foreground_channel"] else 0)
        self.semseg_head = (OutHead(c, g["inter_channels"], n_out, nf, g["gn_num_groups"],
                                    g["pool_type"], False)
                            if m["use_semseg_head"] else None)

    def heads(self, feats: Sequence[torch.Tensor]):
        """4 clip maps ``[N, C, T, h, w]``, coarsest first -> (embedding head
        output, seediness or None, semseg logits or None)."""
        emb = self.embedding_head(feats)
        seed = self.seediness_head(feats) if self.seediness_head is not None else None
        sem = self.semseg_head(feats) if self.semseg_head is not None else None
        return emb, seed, sem

    def forward(self, clips: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward of ``[N, T, 3, H, W]`` clips -> (embedding map
        ``[N, E + V + 1, T, h, w]``, semseg logits or None)."""
        n, t = clips.shape[:2]
        feats = self.backbone(clips.reshape(n * t, *clips.shape[2:]))
        feats = [f.reshape(n, t, *f.shape[1:]).permute(0, 2, 1, 3, 4) for f in feats[::-1]]
        emb, seed, sem = self.heads(feats)
        if seed is not None:
            emb = torch.cat([emb, seed], dim=1)
        return emb, sem


def frozen_names(cfg: Dict) -> List[str]:
    """Parameter name prefixes a training model freezes."""
    if cfg["training"]["freeze_backbone"]:
        return ["backbone."]
    at = cfg["model"]["backbone"]["freeze_at_stage"]
    return (["backbone.body.stem."] if at >= 1 else []) + [
        f"backbone.body.layer{i}." for i in range(1, at)]
