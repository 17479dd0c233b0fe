"""Sliding-window inference engine: per-frame backbone, per-window 3D heads.

* The raw uint8 sequence moves to the device once; each batch of new frames
  is resized (bilinear, half-pixel, no antialiasing), normalised, flipped
  to RGB if the config asks, and zero-padded to a multiple of 32 there.
* FPN features of every frame live in a ring buffer per scale (2 * T rows),
  so each frame runs through the backbone once however many windows hold
  it; a frame leaves the ring when no later window needs it.
* The heads run once per window on the window's features, and emit
  embeddings, bandwidths ``exp(var) * 10`` and seediness, ``[T, h, w, ...]``.
* Duplicate frame ids inside a window (front-padded short sequences) keep
  their LAST occurrence, like the reference's dict-keyed stacking.
* Seediness comes from the separate seediness head, or else is channel
  ``E + V`` of the embedding head's output (the fused configs).
* Without a semseg head, seediness is averaged over the windows holding each
  frame once the whole sequence ran, in window order over the deduped
  frames, and thresholded into the fg masks.
* With a semseg head, the logits of every window position are summed into
  their frame as the windows run (not deduped: a short sequence's repeated
  frame 0 averages every position), optionally after a trilinear upscale
  (``semseg_resize_scale``); the mean gives the fg mask and the multiclass
  output (``derive_masks``).
* Precision follows the model's compute dtype (``build_model(dtype=)``):
  the frames are preprocessed in float32, the feature rings and the heads'
  outputs are in the compute dtype (the bandwidths' ``exp(.) * 10`` too),
  and the window averages accumulate in float32; the clustering takes its
  inputs as float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stemseg_tpu_torch.config import Config
from stemseg_tpu_torch.models.builder import STEmSegModel
from stemseg_tpu_torch.models.embedding_utils import get_nb_free_dims
from stemseg_tpu_torch.models.layers import upsample_trilinear
from stemseg_tpu_torch.structures.geometry import pad_to_multiple


def derive_masks(mean: torch.Tensor, *, has_semseg: bool, semseg_output_type: str,
                 seediness_fg_threshold: float):
    """fg and multiclass masks from the per-frame window-averaged maps.

    :param mean: ``[T, h, w, C]`` averaged semseg logits, or ``[T, h, w]``
        averaged seediness when there is no semseg head
    :param semseg_output_type: 'logits' | 'probs' | 'argmax'
    :return: (fg ``[T, h, w]`` bool, multiclass output or None). With more
        than 2 channels the last one is the fg logit (``sigmoid > 0.5``) and
        the others give the multiclass output; with 2, fg is channel 1 of
        their softmax and there is no multiclass output.
    """
    if not has_semseg:
        return mean > seediness_fg_threshold, None
    if mean.shape[-1] <= 2:
        return torch.softmax(mean, dim=-1)[..., 1] > 0.5, None
    mc_logits, fg_logits = mean[..., :-1], mean[..., -1]
    if semseg_output_type == "logits":
        multiclass = mc_logits
    elif semseg_output_type == "probs":
        multiclass = torch.softmax(mc_logits, dim=-1)
    elif semseg_output_type == "argmax":
        multiclass = torch.argmax(mc_logits, dim=-1)
    else:
        raise ValueError(f"Unknown semseg output type {semseg_output_type!r}")
    return torch.sigmoid(fg_logits) > 0.5, multiclass


class InferenceEngine:
    def __init__(self, cfg: Config, model: STEmSegModel,
                 semseg_resize_scale: float = 1.0):
        """:param model: an ``STEmSegModel`` in eval mode, already on its
        device (see ``models.build_model``)
        :param semseg_resize_scale: spatial trilinear upscale of each
            window's semseg logits before they are summed (4 with
            ``--resize_embeddings``)"""
        self.cfg = cfg
        self.semseg_resize_scale = semseg_resize_scale
        self.model = model
        self.device = next(model.parameters()).device
        self.embedding_size = cfg.model.embeddings.embedding_size
        self.variance_channels = self.embedding_size - get_nb_free_dims(
            cfg.model.embedding_dim_mode)

    def preprocess(self, raw: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
        """uint8 ``[K, H0, W0, 3]`` (on the device) -> normalised, /32-padded
        float32 ``[K, 3, H, W]``."""
        icfg = self.cfg.input
        x = raw.permute(0, 3, 1, 2).float()
        x = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                          align_corners=False, antialias=False)
        mean = torch.tensor(icfg.image_mean, dtype=torch.float32, device=x.device)
        std = torch.tensor(icfg.image_std, dtype=torch.float32, device=x.device)
        if icfg.normalize_to_unit_scale:
            x = x / 255.0
        x = (x - mean.view(1, 3, 1, 1)) / std.view(1, 3, 1, 1)
        if not icfg.bgr_input:
            x = x.flip(1)
        ph, pw = pad_to_multiple(*out_hw)
        return F.pad(x, (0, pw - out_hw[1], 0, ph - out_hw[0]))

    def heads(self, clip_feats: List[torch.Tensor]):
        """One window's FPN maps (finest first, each ``[T, C, h_s, w_s]``) ->
        (embeddings, bandwidths * exp * 10, seediness, semseg logits or
        None), ``[T, h, w, ...]``; the semseg logits upscaled by
        ``semseg_resize_scale``."""
        coarsest_first = [f.permute(1, 0, 2, 3)[None] for f in clip_feats[::-1]]
        emb_out, seed, semseg = self.model.heads(coarsest_first)
        emb_out = emb_out[0].permute(1, 2, 3, 0)  # [T, h, w, C]
        e, v = self.embedding_size, self.variance_channels
        embeddings = emb_out[..., :e]
        bandwidths = torch.exp(emb_out[..., e:e + v]) * 10.0
        seediness = emb_out[..., e + v] if seed is None else seed[0, 0]
        if semseg is not None:
            if self.semseg_resize_scale != 1.0:
                s = self.semseg_resize_scale
                semseg = upsample_trilinear(semseg, (1.0, s, s))
            semseg = semseg[0].permute(1, 2, 3, 0)
        return embeddings, bandwidths, seediness, semseg

    @torch.no_grad()
    def infer_sequence(self, frames: np.ndarray, windows: List[List[int]],
                       resize_hw: Tuple[int, int],
                       seediness_fg_threshold: float = 0.25,
                       semseg_output_type: str = "probs") -> Dict:
        """Sliding-window inference of one sequence.

        :param frames: uint8 ``[T_total, H0, W0, 3]`` raw frames (BGR)
        :param windows: window schedule (frame indices, duplicates allowed)
        :param resize_hw: network input dims before the /32 padding
        :param semseg_output_type: see ``derive_masks``
        :return: ``fg_masks`` [T, h, w] bool, ``multiclass_masks`` (per
            ``semseg_output_type``, or None without a semseg head) and
            ``windows``: dicts of ``frames``, ``embeddings``, ``bandwidths``,
            ``seediness``, all on the device at the embedding scale
        """
        if frames.dtype != np.uint8:
            raise TypeError("the engine takes raw uint8 frames")
        t_total = frames.shape[0]
        frames_dev = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

        ring_size = 2 * len(windows[0])
        rings: Optional[List[torch.Tensor]] = None
        in_ring: Dict[int, int] = {}
        free_rows = list(range(ring_size))
        deps: Dict[int, set] = {}
        for wi, win in enumerate(windows):
            for t in win:
                deps.setdefault(t, set()).add(wi)

        out_windows = []
        semseg_acc: Optional[torch.Tensor] = None
        semseg_cnt = [0] * t_total
        for wi, win in enumerate(windows):
            new_frames = sorted({t for t in win if t not in in_ring})
            if new_frames:
                if len(free_rows) < len(new_frames):
                    raise RuntimeError("feature ring exhausted: the window schedule "
                                       f"keeps more than {ring_size} frames live")
                rows = [free_rows.pop() for _ in new_frames]
                for t, row in zip(new_frames, rows):
                    in_ring[t] = row
                batch = self.preprocess(frames_dev[new_frames], resize_hw)
                feats = self.model.backbone_features(batch)
                if rings is None:
                    rings = [torch.zeros((ring_size,) + f.shape[1:], dtype=f.dtype,
                                         device=f.device) for f in feats]
                row_idx = torch.tensor(rows, device=self.device)
                for ring, f in zip(rings, feats):
                    ring[row_idx] = f

            ring_idx = torch.tensor([in_ring[t] for t in win], device=self.device)
            embeddings, bandwidths, seediness, semseg = self.heads(
                [ring[ring_idx] for ring in rings])
            if semseg is not None:
                # every window position, duplicates included, in order
                if semseg_acc is None:
                    semseg_acc = torch.zeros((t_total,) + semseg.shape[1:],
                                             dtype=torch.float32, device=self.device)
                for i, t in enumerate(win):
                    semseg_acc[t] += semseg[i]
                    semseg_cnt[t] += 1
                del semseg

            unique_frames = sorted(set(win))
            if len(unique_frames) != len(win):
                last_idx = {t: i for i, t in enumerate(win)}
                sel = torch.tensor([last_idx[t] for t in unique_frames],
                                   device=self.device)
                embeddings, bandwidths, seediness = (
                    embeddings[sel], bandwidths[sel], seediness[sel])

            out_windows.append({"frames": unique_frames, "embeddings": embeddings,
                                "bandwidths": bandwidths, "seediness": seediness})

            for t in list(in_ring.keys()):
                deps[t].discard(wi)
                if not deps[t]:
                    free_rows.append(in_ring.pop(t))
                    del deps[t]

        kw = dict(has_semseg=semseg_acc is not None, semseg_output_type=semseg_output_type,
                  seediness_fg_threshold=seediness_fg_threshold)
        if semseg_acc is not None:
            cnt = torch.tensor([max(c, 1) for c in semseg_cnt], dtype=torch.float32,
                               device=self.device)
            mean = semseg_acc.div_(cnt.view(-1, 1, 1, 1))
            fg_masks, multiclass = derive_masks(mean, **kw)
            return {"fg_masks": fg_masks, "multiclass_masks": multiclass,
                    "windows": out_windows}

        # per-frame mean of the seediness of every window holding the frame,
        # summed in window order
        h, w = out_windows[0]["seediness"].shape[1:]
        acc = torch.zeros((t_total, h, w), dtype=torch.float32, device=self.device)
        cnt = torch.zeros((t_total,), dtype=torch.float32, device=self.device)
        for win in out_windows:
            idx = torch.tensor(win["frames"], device=self.device)
            acc[idx] += win["seediness"].float()
            cnt[idx] += 1.0
        mean = acc / torch.clamp(cnt, min=1.0).view(-1, 1, 1)
        fg_masks, _ = derive_masks(mean, **kw)
        return {"fg_masks": fg_masks, "multiclass_masks": None, "windows": out_windows}
