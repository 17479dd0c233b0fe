"""Plain float32 training steps: the synthetic clips worked out again from
the seed, the targets at a quarter of the input, the embedding loss
(Lovász hinge, seediness, bandwidth smoothness), the semseg cross entropy
and fg BCE, the gradient averaged over the micro-steps, and SGD with
coupled weight decay and Nesterov momentum.

Written from the published STEm-Seg training (github.com/sabarim/STEm-Seg,
``stemseg/training``, ``stemseg/modeling/embedding_utils.py``) as the system
under test states its semantics; a frozen copy in plain PyTorch and NumPy
that imports nothing of the system under test. Departures from the
published code, shared with the system under test: the targets are
downscaled by a bilinear resize without antialiasing and kept where it
reads 1 - 1e-5 or more; the semseg cross entropy is the plain mean over
the pixels (the published ignore mask is a no-op there too); the clips are
the synthetic moving-ellipse clips (``data.synthetic``) where the
published trainer reads datasets. A global batch of N clips is worked
one clip at a time, with the normalisers of the whole batch.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .model import FREE_DIMS, Model


# -- the inputs --------------------------------------------------------------------

def sample_seed(seed: int, index: int) -> int:
    return (seed * 1_000_003 + index) % (2 ** 31 - 1)


def synthetic_clip(cfg: Dict, index: int) -> Dict[str, np.ndarray]:
    """Clip ``index`` of the synthetic stream (``data.synthetic``): 1 to
    ``max_instances`` solid-colour ellipses drifting over a textured
    background, with exact masks; the frames normalised as the model takes
    them."""
    icfg, scfg = cfg["input"], cfg["data"]["synthetic"]
    t = icfg["num_frames"]
    h, w = scfg["height"] or icfg["min_dim"], scfg["width"] or icfg["max_dim"]
    rng = np.random.RandomState(sample_seed(scfg["seed"], index))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    bg = np.stack([60 + 50 * np.sin(2 * np.pi * (xx * rng.uniform(0.5, 2.0) / w
                                                 + rng.uniform(0, 1))) for _ in range(3)], -1)
    bg += rng.randn(h, w, 3).astype(np.float32) * 8.0
    n_inst = rng.randint(1, scfg["max_instances"] + 1)
    images = np.broadcast_to(bg, (t, h, w, 3)).copy()
    masks = np.zeros((n_inst, t, h, w), np.uint8)
    for n in range(n_inst):
        a = rng.uniform(0.06, 0.16) * min(h, w)
        b = rng.uniform(0.06, 0.16) * min(h, w)
        cy0, cx0 = rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w
        vy, vx = rng.uniform(-0.02, 0.02) * h, rng.uniform(-0.02, 0.02) * w
        theta = rng.uniform(0, np.pi)
        ct, st = np.cos(theta), np.sin(theta)
        color = rng.uniform(150, 255, size=3).astype(np.float32)
        color[rng.randint(3)] = rng.uniform(0, 60)
        for f in range(t):
            cy, cx = cy0 + vy * f, cx0 + vx * f
            u = (xx - cx) * ct + (yy - cy) * st
            v = -(xx - cx) * st + (yy - cy) * ct
            inside = (u / a) ** 2 + (v / b) ** 2 <= 1.0
            masks[n, f][inside] = 1
            images[f][inside] = color * rng.uniform(0.92, 1.08)
    np.clip(images, 0, 255, out=images)
    images = images.astype(np.float32)
    if icfg["normalize_to_unit_scale"]:
        images = images / 255.0
    images = (images - np.asarray(icfg["image_mean"], np.float32)) / np.asarray(
        icfg["image_std"], np.float32)
    if not icfg["bgr_input"]:
        images = images[..., ::-1]
    return {"images": images, "masks": masks, "category_ids": np.ones(n_inst, np.int64)}


def step_indices(cfg: Dict, world: int, n_micro: int) -> List[List[int]]:
    """The clip indices of the first ``n_micro`` micro-steps' global batches:
    pass 0 of the stream is the permutation of ``default_rng(0)``."""
    tcfg = cfg["training"]
    g = world * tcfg["max_samples_per_chip"]
    acc = max(1, int(round(tcfg["batch_size"] / g)))
    perm = np.random.default_rng(0).permutation(tcfg["max_iterations"] * acc * g)
    return [perm[i * g:(i + 1) * g].tolist() for i in range(n_micro)]


def clip_tensors(clip: Dict, slots: int, device) -> Tuple[torch.Tensor, ...]:
    """Images ``[1, T, 3, H, W]`` padded to /32, masks ``[1, slots, T, H, W]``
    float, category ids ``[1, slots]`` (the largest instances kept)."""
    img, masks, cats = clip["images"], clip["masks"], clip["category_ids"]
    t, h, w, _ = img.shape
    ph, pw = -(-h // 32) * 32, -(-w // 32) * 32
    if masks.shape[0] > slots:
        raise ValueError("the synthetic clips hold fewer instances than the slots")
    x = torch.zeros((1, t, 3, ph, pw), device=device)
    x[0, :, :, :h, :w] = torch.from_numpy(np.ascontiguousarray(img)).to(device).permute(0, 3, 1, 2)
    m = torch.zeros((1, slots, t, ph, pw), device=device)
    m[0, :masks.shape[0], :, :h, :w] = torch.from_numpy(masks).to(device).float()
    c = torch.zeros((1, slots), dtype=torch.int64, device=device)
    c[0, :len(cats)] = torch.from_numpy(cats).to(device)
    return x, m, c


def downscale(x: torch.Tensor, scale: int = 4) -> torch.Tensor:
    h, w = x.shape[-2:]
    lead = x.shape[:-2]
    y = F.interpolate(x.reshape(-1, 1, h, w), size=(h // scale, w // scale), mode="bilinear",
                      align_corners=False, antialias=False)
    return (y.reshape(*lead, h // scale, w // scale) >= 1.0 - 1e-5).float()


# -- the losses ----------------------------------------------------------------------

def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """One binary Lovász hinge per row of ``[I, P]``; errors sorted
    descending, ties in index order."""
    signs = 2.0 * labels - 1.0
    errors = 1.0 - logits * signs
    errors_sorted, perm = torch.sort(errors, dim=-1, descending=True, stable=True)
    gt = labels.gather(-1, perm)
    gts = gt.sum(dim=-1, keepdim=True)
    jaccard = 1.0 - (gts - gt.cumsum(-1)) / (gts + (1.0 - gt).cumsum(-1))
    grad = torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], dim=-1)
    return (F.relu(errors_sorted) * grad).sum(dim=-1)


def clip_loss(emb_map: torch.Tensor, sem: torch.Tensor, masks: torch.Tensor,
              cats: torch.Tensor, cfg: Dict, total_instances: int, n_clips: int
              ) -> torch.Tensor:
    """One clip's share of the global batch's loss, whose normalisers are
    the batch's instances and clips."""
    lcfg = cfg["training"]["losses"]
    ecfg = lcfg["embedding"]
    e = cfg["model"]["embeddings"]["embedding_size"]
    v = e - FREE_DIMS.get(cfg["model"]["embedding_dim_mode"], 0)
    m = downscale(masks)[0]  # [I, T, h, w]
    labels = (m * cats[0].view(-1, 1, 1, 1).float()).amax(dim=0).long()
    emb, bw, seed = emb_map[0, :e], emb_map[0, e:e + v], emb_map[0, e + v]
    p = seed.numel()
    mf = m.reshape(m.shape[0], p)
    counts = mf.sum(dim=1)
    mf, counts = mf[counts > 0], counts[counts > 0]
    n = mf.shape[0]
    total = (emb_map * 0.0).sum()
    if n:
        ef, bf, s = emb.reshape(-1, p), bw.reshape(-1, p), seed.reshape(p)
        centers = (mf @ ef.T) / counts[:, None]
        bw_act = (mf @ (torch.exp(bf) * 10.0).T) / counts[:, None]
        bw_raw = (mf @ bf.T) / counts[:, None]
        smooth = ((mf[:, None] * (bf[None] - bw_raw[:, :, None]) ** 2).sum(dim=(1, 2))
                  / (counts * v)).sum() / n
        free = torch.tensor([1.0 / s_ ** 2 for s_ in ecfg["free_dim_stds"]], device=emb.device)
        full = torch.cat([bw_act, free.expand(n, -1)], dim=1)
        probs = torch.exp(-0.5 * ((ef[None] - centers[:, :, None]) ** 2
                                  * full[:, :, None]).sum(dim=1))
        lovasz = lovasz_hinge(probs * 2.0 - 1.0, mf).sum()
        fg_mse = ((mf * (s[None] - probs.detach()) ** 2).sum(dim=1) / counts).sum()
        bg = 1.0 - mf.amax(dim=0)
        bg_mse = (bg * s ** 2).sum() / bg.sum().clamp(min=1.0)  # no ignore pixels here
        total = total + ecfg["weight"] * (
            ecfg["weight_lovasz"] * lovasz / total_instances
            + ecfg["weight_variance_smoothness"] * smooth / n_clips
            + ecfg["weight_seediness"] * (fg_mse + bg_mse) / (total_instances + 1.0))
    if sem is not None:
        logits = sem
        if cfg["model"]["semseg"]["foreground_channel"]:
            logits, fg_logits = sem[:, :-1], sem[:, -1]
            total = total + F.binary_cross_entropy_with_logits(
                fg_logits, (labels[None] > 0).float()) / n_clips
        total = total + lcfg["weight_semseg"] * F.cross_entropy(logits, labels[None]) / n_clips
    return total


# -- the steps ---------------------------------------------------------------------------

def train_steps(cfg: Dict, state: Dict[str, torch.Tensor], world: int, n_steps: int,
                frozen: List[str], device) -> Dict:
    """``n_steps`` optimizer steps from ``state`` on the global batches of the
    stream. Returns the loss of each micro-step's global batch, the first
    step's averaged gradient and the parameters after the last step (both
    by name, on the host)."""
    tcfg = cfg["training"]
    if (tcfg["optimizer"].lower() != "sgd" or tcfg["clip_gradients"] or tcfg["loss_at_full_res"]
            or tcfg["freeze_backbone"] or tcfg["lr_decay_type"] not in ("exponential", "none")):
        raise ValueError("the reference holds the presets' SGD steps only")
    model = Model(cfg).to(device)
    model.load_state_dict(state)
    params = {n: p for n, p in model.named_parameters()
              if not any(n.startswith(f) for f in frozen)}
    for n, p in model.named_parameters():
        p.requires_grad_(n in params)
    g = world * tcfg["max_samples_per_chip"]
    acc = max(1, int(round(tcfg["batch_size"] / g)))
    slots = tcfg["max_instances"] or 16
    batches = step_indices(cfg, world, n_steps * acc)
    buf: Dict[str, torch.Tensor] = {}
    losses, first_grad = [], None
    for step in range(n_steps):
        lr = tcfg["initial_lr"] * (1.0 if tcfg["lr_decay_type"] == "none" else
                                   float(np.exp(np.log(tcfg["lr_exp_decay_factor"])
                                                / tcfg["lr_exp_decay_steps"]))
                                   ** max(step - tcfg["lr_exp_decay_start"], 0))
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        for k in range(acc):
            clips = [clip_tensors(synthetic_clip(cfg, i), slots, device)
                     for i in batches[step * acc + k]]
            total_inst = sum(int((downscale(m)[0].flatten(1).sum(1) > 0).sum())
                             for _, m, _ in clips)
            loss_sum = 0.0
            for x, m, c in clips:
                emb, sem = model(x)
                loss = clip_loss(emb, sem, m, c, cfg, total_inst, len(clips))
                for (n, gr) in zip(params, torch.autograd.grad(loss, list(params.values()))):
                    grads[n] += gr / acc
                loss_sum += float(loss.detach())
                del emb, sem, loss
            losses.append(loss_sum)
        if first_grad is None:
            first_grad = {n: gr.cpu() for n, gr in grads.items()}
        with torch.no_grad():
            for n, p in params.items():
                d = grads[n] + tcfg["weight_decay"] * p
                buf[n] = d.clone() if n not in buf else buf[n].mul_(tcfg["momentum"]).add_(d)
                d = d + tcfg["momentum"] * buf[n] if tcfg["nesterov"] else buf[n]
                p.sub_(lr * d)
    out = {"losses": losses, "first_grad": first_grad,
           "params": {n: p.detach().cpu() for n, p in params.items()}}
    del model, params, buf, grads
    return out
