#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``stemseg_tpu_torch``) on one CUDA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each of
which raises on failure (the script then exits non-zero):

1. device: name, power limit (nvidia-smi) and the TF32 flags;
2. build: ``nvcc`` builds the CUDA sources of the checkout;
3. kernels: ``cluster_points_single`` (207,360 points) and
   ``cluster_points_tiled`` (878,592 points) against their plain PyTorch
   version on the same mixture-of-Gaussians inputs, both secondary modes
   and one case that exhausts K: labels exact except knife-edge points
   (plain ``exp(-0.5 d)`` within 1e-6 of a threshold, at most 0.01 %),
   meta equal; kernel time, plain time and bound;
4. main path A: the ``davis_2`` preset at full width (R-101-FPN, 16-frame
   windows, 704x1248 network input) on a 26-frame 480x854 sequence through
   ``TrackGenerator._process_loaded`` into the DAVIS writer; every window
   must go through ``cluster_points_tiled``;
5. main path B: ``davis_1`` at 480x854 (8-frame windows, 207,360 points a
   window) on 16 frames; every window through ``cluster_points_single``;
6. small input: the slice on the GPU against the slice on the CPU (plain
   versions, CPU convolutions) on the same weights and frames;
7. steady state: main path A once more, timed only; the device time of
   each of its layers; and one profiled run (device busy share).

The last three lines are the kernel table as JSON, the card's name and
power limit as nvidia-smi prints them, and ``{"ok": true, "device": ...}``.
Without a CUDA device, or outside a checkout, it exits non-zero and prints
no result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
KNIFE_EPS = 1e-6
MAX_KNIFE_FRACTION = 1e-4
MAIN_SEED = 0


def log(*args):
    print(*args, flush=True)


class Sequence:
    def __init__(self, seq_id, n_frames, image_dims):
        self.id = seq_id
        self.image_dims = image_dims
        self._n = n_frames

    def __len__(self):
        return self._n


def synthetic_frames(n, h, w, seed):
    """Moving discs over a gradient with pixel noise; BGR uint8."""
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([yy * 0.1 + 40, xx * 0.1 + 60, (yy + xx) * 0.05 + 80], -1)
    discs = [(rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w,
              rng.uniform(0.08, 0.18) * h, rng.uniform(-4, 4, 2),
              rng.randint(0, 255, 3)) for _ in range(4)]
    frames = np.empty((n, h, w, 3), np.uint8)
    for t in range(n):
        f = base.copy()
        for cy, cx, r, (vy, vx), col in discs:
            f[(yy - cy - vy * t) ** 2 + (xx - cx - vx * t) ** 2 < r * r] = col
        frames[t] = np.clip(f + rng.randn(h, w, 3) * 6, 0, 255).astype(np.uint8)
    return frames


def mixture_points(p, seed, e=4, n_free=2, n_clusters=8, noise=0.05):
    """A DAVIS-like window: Gaussian blobs in embedding space, seediness
    peaked at the blob centres, outliers, ~30 % background."""
    import numpy as np

    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.8, 0.8, size=(n_clusters, e)).astype(np.float32)
    k = rng.randint(0, n_clusters + 1, size=p)
    kc = np.minimum(k, n_clusters - 1)
    inlier = k < n_clusters
    emb = np.where(inlier[:, None], centers[kc] + rng.randn(p, e) * noise,
                   rng.uniform(-1, 1, size=(p, e))).astype(np.float32)
    dist = np.linalg.norm(emb - centers[kc], axis=1)
    seed_v = np.where(inlier, np.exp(-dist / (2 * noise)) * 0.19 + 0.8,
                      rng.uniform(0.0, 0.5, p)).astype(np.float32)
    bw = (np.exp(rng.randn(p, e - n_free) * 0.1 + np.log(3.0)) * 10.0)
    free = np.full((p, n_free), 1.0 / 0.09)
    full_bw = np.concatenate([bw, free], axis=1).astype(np.float32)
    fg = rng.rand(p) > 0.3
    return emb, full_bw, seed_v, fg


def time_cuda(fn, n, warmup=2):
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def primary_walk(emb, bw, fg, meta, primary, secondary):
    """Replays the primary assignments of the valid clusters of ``meta``:
    available points per iteration (for the operation count) and the points
    whose ``exp(-0.5 d)`` lies within KNIFE_EPS of a threshold."""
    import torch

    e = emb.shape[1]
    avail = fg.clone()
    knife = torch.zeros_like(fg)
    n_avail = []
    for k in range(meta.shape[0]):
        if meta[k, -1] <= 0.5:
            break
        c, b = meta[k, :e], meta[k, e:2 * e]
        d2 = torch.zeros(emb.shape[0], device=emb.device)
        for j in range(e):
            d2 = d2 + (emb[:, j] - c[j]) ** 2 * b[j]
        prob = torch.exp(-0.5 * torch.sqrt(d2))
        knife |= ((prob - primary).abs() < KNIFE_EPS) | ((prob - secondary).abs() < KNIFE_EPS)
        n_avail.append(int(avail.sum()))
        avail &= ~(prob > primary)
    return n_avail, knife


def check_edge_cases(ops, name):
    """The loop running out of points before K (key 0 must stop it), a
    window without fg points, and K = 1, against the plain version."""
    import numpy as np
    import torch

    emb, bw, seed, fg = mixture_points(2000, seed=7, n_clusters=2, noise=0.01)
    cases = (("all_taken", np.ones_like(bw), np.ones_like(fg), 20, 0.0),
             ("all_background", bw, np.zeros_like(fg), 20, 0.0),
             ("k1", bw, fg, 1, 0.8))
    for case, case_bw, case_fg, k, min_seed in cases:
        tensors = [torch.from_numpy(x).cuda() for x in (emb, case_bw, seed, case_fg)]
        for mode in ("reference", "nearest"):
            kwargs = dict(e_dims=4, max_instances=k, primary=0.5, secondary=0.3,
                          min_seediness=min_seed, reference_secondary=mode == "reference")
            labels, meta = getattr(ops, name)(*tensors, **kwargs)
            ref_labels, ref_meta = ops.cluster_points_reference(*tensors, **kwargs)
            if not (torch.equal(labels, ref_labels) and torch.equal(meta, ref_meta)):
                raise AssertionError(f"{name} {case} {mode}: differs from the plain version")
        n_valid = int((meta[:, -1] > 0.5).sum())
        if case == "all_taken" and not (n_valid < k and bool((labels >= 0).all())):
            raise AssertionError(f"{name} all_taken: {n_valid} clusters, points left")
        log(f"  {name} edge case {case}: {n_valid} clusters, exact in both modes")


def check_kernels(ops):
    import torch

    results = {}
    for name, p in (("cluster_points_single", 207_360), ("cluster_points_tiled", 878_592)):
        emb, bw, seed, fg = (torch.from_numpy(x).cuda()
                             for x in mixture_points(p, seed=p % 1000))
        wrapper = getattr(ops, name)
        row = {"max_abs_err": 0.0, "label_mismatches": 0}
        for mode, k, min_seed in (("reference", 20, 0.8), ("nearest", 20, 0.8),
                                  ("reference", 3, 0.8)):
            kwargs = dict(e_dims=4, max_instances=k, primary=0.5, secondary=0.3,
                          min_seediness=min_seed, reference_secondary=mode == "reference")
            labels, meta = wrapper(emb, bw, seed, fg, **kwargs)
            ref_labels, ref_meta = ops.cluster_points_reference(emb, bw, seed, fg, **kwargs)
            torch.cuda.synchronize()
            err = float((meta - ref_meta).abs().max())
            if err != 0.0:
                raise AssertionError(f"{name} {mode} K={k}: meta differs by {err}")
            n_valid = int((meta[:, -1] > 0.5).sum())
            if n_valid < min(k, 3):
                raise AssertionError(f"{name} {mode} K={k}: only {n_valid} clusters formed")
            n_avail, knife = primary_walk(emb, bw, fg, ref_meta, 0.5, 0.3)
            mism = labels != ref_labels
            n_mism = int(mism.sum())
            if bool((mism & ~knife).any()) or n_mism > MAX_KNIFE_FRACTION * p:
                raise AssertionError(f"{name} {mode} K={k}: {n_mism} label mismatches, "
                                     f"{int((mism & ~knife).sum())} not on a knife edge")
            log(f"  {name} P={p} {mode:9s} K={k:2d}: {n_valid} clusters, "
                f"{n_mism} knife-edge label mismatches, meta max abs err {err}")
            row["label_mismatches"] += n_mism
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if (mode, k) == ("reference", 20):
                kw = kwargs
                n_iter_avail = n_avail
        check_edge_cases(ops, name)
        # times at the main-path shape, K = 20, reference mode
        row["ms"] = time_cuda(lambda: wrapper(emb, bw, seed, fg, **kw), 20)
        row["plain_ms"] = time_cuda(lambda: ops.cluster_points_reference(emb, bw, seed, fg, **kw),
                                    3, warmup=1)
        # least time: inputs read once (emb, bw, seed, fg), labels + meta
        # written once; operations of the executed iterations on the
        # available points (3E + 4 each: sub, mul, mul, add per dim, sqrt,
        # scale, exp, compare)
        n_bytes = p * (4 * 4 * 2 + 4 + 1) + p * 4 + 32 * 128 * 4
        n_ops = sum(n_iter_avail) * (3 * 4 + 4)
        bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = n_ops / PEAK_FP32_OPS_PER_S * 1e3
        row.update(bound_ms=max(bytes_ms, ops_ms),
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   points=p, iterations=len(n_iter_avail), bytes=n_bytes, ops=n_ops)
        log(f"  {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}: {n_bytes} B, "
            f"{n_ops} ops over {len(n_iter_avail)} iterations)")
        results[name] = row
    return results


def run_main_path(cfg, frames, seq_id, out_dir, seed):
    """The port's main path, as a user drives it: model, TrackGenerator,
    DAVIS writer, one sequence of raw frames."""
    from stemseg_tpu_torch.inference.main import TrackGenerator
    from stemseg_tpu_torch.inference.output_utils import DavisOutputGenerator
    from stemseg_tpu_torch.models import build_model, init_random_weights
    from stemseg_tpu_torch.ops import launch_counts, reset_launch_counts
    from stemseg_tpu_torch.utils.timer import Timer

    model = build_model(cfg, device="cuda")
    init_random_weights(model, seed)
    tg = TrackGenerator(cfg, "davis", model, DavisOutputGenerator(out_dir, device="cuda"),
                        cfg.data.davis.max_inference_tracks)
    seq = Sequence(seq_id, len(frames), frames.shape[1:3])
    Timer.reset()
    reset_launch_counts()
    labels, counts, lifetimes, metas = tg._process_loaded(
        seq, frames, frames.shape[1:3], tg.max_tracks)
    launches = dict(launch_counts)
    return tg, labels, counts, metas, launches


def check_main_path(tag, preset, overrides, n_frames, kernel, expect_windows,
                    expect_shape, out_root):
    import numpy as np

    from stemseg_tpu_torch.config import load_preset, merge

    cfg = merge(load_preset(preset), overrides)
    frames = synthetic_frames(n_frames, 480, 854, seed=MAIN_SEED)
    out_dir = os.path.join(out_root, tag)
    t0 = time.perf_counter()
    tg, labels, counts, metas, launches = run_main_path(cfg, frames, tag, out_dir, MAIN_SEED)
    wall = time.perf_counter() - t0
    other = "cluster_points_single" if kernel == "cluster_points_tiled" else "cluster_points_tiled"
    if launches[kernel] != expect_windows or launches[other] != 0 \
            or launches["cluster_points_reference"] != 0:
        raise AssertionError(f"path {tag}: launches {launches}, expected {expect_windows} "
                             f"of {kernel} and no other")
    if labels.shape != expect_shape:
        raise AssertionError(f"path {tag}: labels {labels.shape}, expected {expect_shape}")
    pngs = sorted(os.listdir(os.path.join(out_dir, "results", tag)))
    if pngs != [f"{t:05d}.png" for t in range(n_frames)]:
        raise AssertionError(f"path {tag}: wrote {len(pngs)} PNGs, expected {n_frames}")
    per_window = [int(m.valid.sum()) for m in metas]
    n_points = [int(np.prod(m.labels.shape)) for m in metas]
    if not all(per_window) or len(counts) < 2:
        raise AssertionError(f"path {tag}: no clusters formed ({per_window})")
    log(f"  path {tag}: {preset} min/max dim {cfg.input.min_dim}/{cfg.input.max_dim}, "
        f"{n_frames} frames, {len(metas)} windows of {n_points[0]} points, "
        f"labels {labels.shape}, {len(counts) - 1} tracks, {len(pngs)} PNGs, wall {wall:.3f} s")
    log(f"  path {tag}: clusters per window {per_window}; launches {launches}")
    for line in tg.fps_report():
        log(f"  path {tag}: {line}")
    return cfg, frames, launches


def check_small_input(out_root):
    """The slice on the GPU against the slice on the CPU on one small input:
    engine outputs within 1e-3, labels on >= 99.9 % of the pixels."""
    import numpy as np
    import torch

    from stemseg_tpu_torch.config import load_config
    from stemseg_tpu_torch.inference.main import TrackGenerator
    from stemseg_tpu_torch.inference.output_utils import DavisOutputGenerator
    from stemseg_tpu_torch.models import build_model, init_random_weights

    cfg = load_config({
        "input": {"num_frames": 4, "min_dim": 64, "max_dim": 96},
        "model": {"backbone": {"type": "R-50-FPN"}, "embedding_dim_mode": "xyff",
                  "use_seediness_head": True, "use_semseg_head": False,
                  "embeddings": {"embedding_size": 4}},
        "training": {"losses": {"embedding": {"free_dim_stds": [0.3, 0.3]}}},
        "clustering": {"min_seediness_prob": 0.05}})
    frames = synthetic_frames(10, 32, 48, seed=1)
    outs = {}
    for dev in ("cuda", "cpu"):
        model = build_model(cfg, device=dev)
        init_random_weights(model, 1)
        tg = TrackGenerator(cfg, "davis", model,
                            DavisOutputGenerator(os.path.join(out_root, "small_" + dev),
                                                 device=dev), 20, frame_overlap=2)
        out = tg.do_inference(frames, (32, 48))
        outs[dev] = (out, tg.do_clustering(out)[0])
    (g_out, g_labels), (c_out, c_labels) = outs["cuda"], outs["cpu"]
    err = max(float((gw[k].cpu() - cw[k]).abs().max())
              for gw, cw in zip(g_out["windows"], c_out["windows"])
              for k in ("embeddings", "bandwidths", "seediness"))
    agree = float((g_labels == c_labels).mean())
    log(f"  small input: GPU vs CPU engine max abs err {err:.3g}, label agreement {agree:.6f}")
    if not err < 1e-3 or agree < 0.999 or not np.isfinite(err):
        raise AssertionError(f"small input: err {err}, agreement {agree}")


def layer_split(tg, frames, kernel_ms):
    """Device time of each layer of path A at its real shapes (CUDA events,
    warm): preprocessing and backbone + FPN on one window's 16 new frames,
    the two 3D heads on one window, scaled to the 26-frame sequence."""
    import torch

    from stemseg_tpu_torch.structures.geometry import compute_resize_params

    eng = tg.engine
    t_win = tg.cfg.input.num_frames
    new_w, new_h, _ = compute_resize_params((frames.shape[2], frames.shape[1]),
                                            tg.cfg.input.min_dim, tg.cfg.input.max_dim)
    raw = torch.from_numpy(frames[:t_win]).cuda()
    with torch.no_grad():
        pre_ms = time_cuda(lambda: eng.preprocess(raw, (new_h, new_w)), 3)
        batch = eng.preprocess(raw, (new_h, new_w))
        bb_ms = time_cuda(lambda: eng.model.backbone_features(batch), 3)
        feats = eng.model.backbone_features(batch)
        heads_ms = time_cuda(lambda: eng.heads(feats), 3)
    n_frames, n_windows = len(frames), 2
    parts = {"preprocess": pre_ms * n_frames / t_win,
             "backbone+FPN": bb_ms * n_frames / t_win,
             "3D heads": heads_ms * n_windows,
             "clustering kernels": kernel_ms * n_windows}
    for name, ms in parts.items():
        log(f"  layer split A: {name:18s} {ms:9.3f} ms for {n_frames} frames")
    return parts


def device_profile(tg, frames):
    """One more sequence through ``tg`` under torch.profiler: the device's
    busy share of the wall time (sum of kernel, copy and memset time on
    the device over the host's wall clock) and the largest device items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seq = Sequence("A3", len(frames), frames.shape[1:3])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tg._process_loaded(seq, frames, frames.shape[1:3], tg.max_tracks)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    log(f"  profile A: wall {wall_us / 1e3:.3f} ms (profiled, writer included), device busy "
        f"{busy_us / 1e3:.3f} ms = {busy_us / wall_us:.3f} of the wall")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  profile A: {us / 1e3:9.3f} ms  {name[:90]}")


def main():
    if not os.path.isdir(os.path.join(HERE, "stemseg_tpu_torch")):
        sys.stderr.write("chip_smoke: run it from the root of a checkout\n")
        sys.exit(1)
    sys.path.insert(0, HERE)
    import importlib.util
    import shutil

    import torch

    from stemseg_tpu_torch.ops import build, cluster as ops
    from stemseg_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        sys.exit(1)

    t_start = time.perf_counter()
    log("== phase 1: device")
    resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}, device {kind}, "
        f"count {torch.cuda.device_count()}")
    log(f"  nvidia-smi: {smi}")
    log(f"  cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    # imported lazily: cv2 by the CLI's frame reader, yaml for a config.yaml,
    # PIL by the DAVIS writer (the only one of them the main path below runs)
    present = {m: importlib.util.find_spec(m) is not None for m in ("yaml", "cv2", "PIL")}
    log(f"  optional modules: {present}, ninja: {shutil.which('ninja') or 'absent'}")

    log("== phase 2: build")
    for res in build.build().values():
        regs = [int(w) for line in res.log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = sum(int(line.split("bytes spill stores")[0].split()[-1])
                     for line in res.log.splitlines() if "bytes spill stores" in line)
        log(f"  {res.name}: {res.path} built in {res.seconds:.1f} s; "
            f"{len(regs)} kernels, at most {max(regs, default=0)} registers a thread, "
            f"{spills} bytes of spill stores")

    log("== phase 3: kernels against the plain version")
    kernels = check_kernels(ops)

    with tempfile.TemporaryDirectory() as out_root:
        log("== phase 4: main path A (davis_2, 704x1248, 16-frame windows)")
        cfg_a, frames_a, launches_a = check_main_path(
            "A", "davis_2", {"clustering": {"min_seediness_prob": 0.05}}, 26,
            "cluster_points_tiled", 2, (26, 176, 312), out_root)
        log("== phase 5: main path B (davis_1, 480x854, 8-frame windows)")
        _, _, launches_b = check_main_path(
            "B", "davis_1", {"input": {"min_dim": 480, "max_dim": 854},
                             "clustering": {"min_seediness_prob": 0.05}}, 16,
            "cluster_points_single", 5, (16, 120, 216), out_root)
        log("== phase 6: small input, GPU against CPU")
        check_small_input(out_root)
        log("== phase 7: steady state, main path A again (timing only)")
        t0 = time.perf_counter()
        tg, *_ = run_main_path(cfg_a, frames_a, "A2", os.path.join(out_root, "A2"), MAIN_SEED)
        log(f"  path A steady: wall {time.perf_counter() - t0:.3f} s")
        for line in tg.fps_report():
            log(f"  path A steady: {line}")
        layer_split(tg, frames_a, kernels["cluster_points_tiled"]["ms"])
        device_profile(tg, frames_a)

    replaces = {"cluster_points_single": "stemseg_tpu/ops/cluster_pallas.py:103",
                "cluster_points_tiled": "stemseg_tpu/ops/cluster_pallas.py:300"}
    launches = {"cluster_points_single": launches_b["cluster_points_single"],
                "cluster_points_tiled": launches_a["cluster_points_tiled"]}
    table = {"kernels": [
        {"name": name, "route": "cuda", "source": "stemseg_tpu_torch/ops/csrc/cluster.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": row["max_abs_err"], "label_mismatches": row["label_mismatches"],
         "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
         "bound_by": row["bound_by"], "library_ms": None, "points": row["points"],
         "iterations": row["iterations"]}
        for name, row in kernels.items()]}
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
