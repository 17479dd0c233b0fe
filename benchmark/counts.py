"""The yardstick's arithmetic: the card's published peaks, the FLOPs a
model's work needs (counted on the reference model on the meta device, so
the count is the same whatever implements the work), and the bytes a
clustering call must move."""

from __future__ import annotations

from typing import Dict, Tuple

# one H100 SXM (NVIDIA's data sheet, dense): float32 outside the tensor
# cores (TF32 is off) and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
META_COLS, K_PAD = 128, 32  # the clustering's meta output, float32 [32, 128]


def cluster_bytes(points: int, e_dims: int, active: int) -> int:
    """Least bytes one clustering call moves: embeddings (4E B), seediness
    (4 B) and fg (1 B) of every point read once, the bandwidths (4E B) at
    each active iteration's seed, the labels (4 B a point) and the meta
    block written once."""
    return points * (4 * e_dims + 4 + 1) + active * 4 * e_dims + points * 4 + K_PAD * META_COLS * 4


def _flops(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def inference_flops(cfg: Dict, padded_hw: Tuple[int, int]) -> Tuple[int, int]:
    """(backbone + FPN FLOPs of one frame, heads' FLOPs of one window) at the
    padded network input ``padded_hw``."""
    import torch

    from .reference.model import Model

    with torch.device("meta"):
        model = Model(cfg)
        frame = torch.empty((1, 3) + tuple(padded_hw))
        with torch.no_grad():
            per_frame = _flops(lambda: model.backbone(frame))
            feats = [f.unsqueeze(2).expand(-1, -1, cfg["input"]["num_frames"], -1, -1)
                     for f in model.backbone(frame)][::-1]
            per_window = _flops(lambda: model.heads(feats))
    return per_frame, per_window


def training_flops(cfg: Dict, clip_hw: Tuple[int, int]) -> int:
    """Forward + backward FLOPs of one clip of ``num_frames`` frames at the
    padded size ``clip_hw``: the weight and data gradients of what the
    configuration trains (frozen parameters get no weight gradient, and no
    data gradient flows below the lowest trained layer)."""
    import torch

    from .reference.model import Model, frozen_names

    with torch.device("meta"):
        model = Model(cfg)
        frozen = frozen_names(cfg)
        for name, p in model.named_parameters():
            p.requires_grad_(not any(name.startswith(f) for f in frozen))
        clip = torch.empty((1, cfg["input"]["num_frames"], 3) + tuple(clip_hw))

        def step():
            emb, sem = model(clip)
            loss = emb.sum() + (sem.sum() if sem is not None else 0.0)
            loss.backward()

        return _flops(step)
