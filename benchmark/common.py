"""What every driver of the benchmark shares: the files it is defined by,
the card check, the seeded inputs and weights, the profiler reduction, the
per-layer readers and the result line."""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
# top-level module names that no benchmark process may hold: the JAX stack
# and the package the system under test was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "stemseg_tpu")
GIB = float(2 ** 30)


def load_json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def spec() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str) -> Tuple[Dict, Dict, Dict, Dict]:
    """(spec, workload entry, configuration file, traffic file) of a cell."""
    s = spec()
    by_name = {w["name"]: w for w in s["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in s["configs"]}[w["config"]]
    return s, w, load_json(os.path.join(ROOT, conf["file"])), load_json(
        os.path.join(HERE, "traffic", w["traffic"] + ".json"))


def forbidden_loaded() -> List[str]:
    """Modules in ``sys.modules`` whose top-level name, taken whole, is one
    of ``FORBIDDEN``."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def require_cards(n: int) -> None:
    """Exits without a result unless ``n`` CUDA devices are visible."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        print(f"this cell needs {n} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        raise SystemExit(3)


def set_numerics() -> None:
    """Full float32: no TF32 in convolutions or matrix products."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def card_power_limit() -> Optional[str]:
    """The first card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def seed32(seed: int) -> int:
    """A seed for generators that take 32 bits (``--seed`` may be larger)."""
    return seed % (2 ** 31 - 1)


# -- seeded inputs and weights ------------------------------------------------

def moving_discs(n: int, h: int, w: int, seed: int, device) -> "torch.Tensor":
    """``n`` uint8 BGR frames ``[n, h, w, 3]`` on ``device``: four discs
    moving over a colour gradient, with pixel noise; every number drawn
    from a generator seeded with ``seed``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    yy = torch.arange(h, device=device, dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, w)
    tt = torch.arange(n, device=device, dtype=torch.float32).view(n, 1, 1)
    frames = torch.stack(torch.broadcast_tensors(yy * 0.1 + 40, xx * 0.1 + 60,
                                                 (yy + xx) * 0.05 + 80), dim=-1)
    frames = frames.expand(n, h, w, 3).clone()
    u = torch.rand((4, 8), generator=gen, device=device)
    for cy, cx, r, vy, vx, b, g, rr in u.tolist():
        inside = ((yy - (0.2 + 0.6 * cy) * h - (8 * vy - 4) * tt) ** 2
                  + (xx - (0.2 + 0.6 * cx) * w - (8 * vx - 4) * tt) ** 2
                  < ((0.08 + 0.10 * r) * h) ** 2)
        colour = torch.tensor([b, g, rr], device=device) * 255.0
        frames = torch.where(inside[..., None], colour.floor(), frames)
    noise = torch.randn((n, h, w, 3), generator=gen, device=device) * 6.0
    return (frames + noise).clamp_(0, 255).to(torch.uint8)


def random_weights(model, seed: int, device) -> Dict[str, "torch.Tensor"]:
    """A state dict for ``model`` (the reference, any device, meta included)
    drawn on ``device`` from a generator seeded with ``seed``, in one call:
    backbone and FPN convs uniform within ``sqrt(3 / fan_in)`` with zero
    biases, head convs within ``sqrt(1 / fan_in)`` with biases within
    ``1 / sqrt(fan_in)``; norms and frozen statistics the identity."""
    import math

    import torch
    from torch import nn

    convs = [(name, mod) for name, mod in model.named_modules()
             if isinstance(mod, (nn.Conv2d, nn.Conv3d))]
    sizes = []
    for _, mod in convs:
        sizes.append(mod.weight.numel())
        if mod.bias is not None:
            sizes.append(mod.bias.numel())
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    state = {k: torch.zeros(v.shape, device=device) if not k.endswith(
        ("weight", "running_var")) else torch.ones(v.shape, device=device)
        for k, v in model.state_dict().items()}
    if "embedding_head.time_scale" in state:
        state["embedding_head.time_scale"] = torch.ones((), device=device)
    offset = 0
    for name, mod in convs:
        fan_in = mod.weight[0].numel()
        backbone = name.startswith("backbone.")
        n = mod.weight.numel()
        state[name + ".weight"] = flat[offset:offset + n].view(mod.weight.shape) * math.sqrt(
            (3.0 if backbone else 1.0) / fan_in)
        offset += n
        if mod.bias is not None:
            n = mod.bias.numel()
            state[name + ".bias"] = (torch.zeros(n, device=device) if backbone else
                                     flat[offset:offset + n] / math.sqrt(fan_in))
            offset += n
    return state


# -- the profiler ----------------------------------------------------------------

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def start_profiler():
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    return prof


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce_trace(prof, device_index: int = 0) -> Dict:
    """The device side of a stopped profiler session between its
    ``bench.window_start`` and ``bench.window_end`` marks: each kernel, copy
    and memset on the device as (name, start, end) in ns; the union of
    their intervals; device time by operation name; idle time by the
    innermost ``bench.*`` host span over the middle of each gap."""
    import torch

    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev, spans, marks = [], [], {}
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if hasattr(e, "activity_type"):
                on_device = e.activity_type() in DEVICE_ACTIVITIES
            elif hasattr(e, "is_user_annotation"):
                on_device = not e.is_user_annotation()
            else:
                on_device = not name.startswith("bench.")
            if on_device and e.device_index() == device_index:
                dev.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith("bench."):
            if name in ("bench.window_start", "bench.window_end"):
                marks[name] = e.start_ns()
            else:
                spans.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    lo = marks.get("bench.window_start", min((s for _, s, _ in dev), default=0))
    hi = marks.get("bench.window_end", max((e for _, _, e in dev), default=0))
    dev = [(n, max(s, lo), min(e, hi)) for n, s, e in dev if e > lo and s < hi]
    busy = _merge([(s, e) for _, s, e in dev])
    by_op: Dict[str, float] = {}
    for n, s, e in dev:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e9
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    spans.sort(key=lambda x: x[2] - x[1])  # innermost (shortest) first
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) // 2
        label = next((n for n, a, b in spans if a <= mid < b), "bench.other")
        gaps[label] = gaps.get(label, 0.0) + (e - s) / 1e9
    return {"device": dev, "busy_s": sum(e - s for s, e in busy) / 1e9,
            "window_s": (hi - lo) / 1e9, "by_op": by_op, "gaps": gaps}


def log(*args) -> None:
    """One line on standard error, written at once (ranks share the stream)."""
    sys.stderr.write(" ".join(str(a) for a in args) + "\n")
    sys.stderr.flush()


def top(d: Dict[str, float], n: int = 10) -> List[List]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda x: -x[1])[:n]]


# -- per-layer readers -----------------------------------------------------------

def read_metrics(names: Iterable[str], ctx: Dict) -> Dict[str, float]:
    """Each per-layer metric by its reader ``metrics/<name>.py`` (its
    ``read(ctx)``); a reader that finds nothing returns None and the
    metric is left out."""
    out = {}
    for name in names:
        path = os.path.join(HERE, "metrics", name + ".py")
        mod_spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(
            ".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        value = mod.read(ctx)
        if value is not None:
            out[name] = value
    return out


# -- the result ----------------------------------------------------------------------

def outcome(attempted: int, failed: int, end_to_end: Dict[str, float], device: Dict,
            checks: Sequence[Tuple[str, float, float]], ctx: Optional[Dict],
            reduced: Optional[Dict]) -> Dict:
    """What a driver's run returns. ``checks``: (name, value, limit) of each
    number compared, correct when none is over its limit and nothing
    failed; ``ctx``: what the per-layer readers read (traced runs);
    ``reduced``: ``reduce_trace``'s output (traced runs)."""
    return {"correct": failed == 0 and all(v <= lim for _, v, lim in checks),
            "attempted": attempted, "failed": failed, "end_to_end": end_to_end,
            "device": device, "checks": list(checks), "ctx": ctx, "reduced": reduced}


def result_line(out: Dict, metrics: Dict[str, float], units: Dict[str, str]) -> str:
    """The last line of standard output, the compared numbers last."""
    line = {"correct": bool(out["correct"]), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]),
            "metrics": {k: {"value": v, "unit": units[k]} for k, v in metrics.items()},
            "device": out["device"]}
    if out["reduced"] is not None:
        line["breakdown"] = {"device_ops": top(out["reduced"]["by_op"]),
                             "idle_gaps": top(out["reduced"]["gaps"])}
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in out["checks"]}
    return json.dumps(line)


def finish(line: str, checks: Sequence[Tuple[str, float, float]]) -> None:
    """Prints the compared numbers on standard error and the result line
    last on standard output, unless a forbidden module was loaded."""
    bad = forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        raise SystemExit(4)
    for name, v, lim in checks:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)


class Clock:
    """Host-clock spans of the benchmark's own calls into the layers, each
    mirrored as a ``bench.<name>`` profiler annotation."""

    def __init__(self):
        self.spans: List[Tuple[str, float, float]] = []

    def span(self, name: str, fn: Callable, *args, **kwargs):
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function("bench." + name):
            out = fn(*args, **kwargs)
        self.spans.append((name, t0, time.perf_counter()))
        return out

    def total(self, name: str) -> float:
        return sum(e - s for n, s, e in self.spans if n == name)
