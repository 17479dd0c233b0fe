"""Traffic of kind ``train``: the trainer's micro-step (``TrainStep``) fed by
``Trainer.make_loader`` through ``to_device``, one rank a card, timed from
the first optimizer step after set-up to the first optimizer step that
ends after the run's seconds.

The traffic file gives the ranks (``world``), the loader's worker
processes a rank, the optimizer steps set-up drives (the reference follows
them) and the limit of each number compared. The configuration file's
``train`` tree is the preset in ``training.mode: synthetic``; the seed
makes the weights and the clips (``data.synthetic.seed``).

With more than one rank the parent process starts one worker process a
rank (``run.py --rank-worker``), gives them the process group's address and
reads their results back; rank 0's clock ends the window, and the decision
reaches the other ranks by one small all-reduce a step, as the trainer's
interrupt flag does. Each rank reports the forbidden modules it holds once
its window has closed, and a run in which any rank holds one ends without
a result, as ``common.finish`` ends the parent's.
"""

from __future__ import annotations

import gc
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

from .. import common
from ..reference import model as ref_model
from ..reference import train as ref_train

WORKER_TIMEOUT = 330  # seconds a rank worker may take
# what a rank worker runs (the entry point, given ``--rank-worker``); a
# fault run puts ``faults.py NAME`` in its place
WORKER_ARGV = [os.path.join(common.HERE, "run.py")]


def _cfg_tree(conf: Dict, seed: int, bf16: bool) -> Dict:
    tree = json.loads(json.dumps(conf["train"]))
    tree["data"]["synthetic"]["seed"] = common.seed32(seed)
    if bf16:  # the program's own lower precision: the control
        tree["training"]["mixed_precision"] = True
    return tree


def run(workload: str, conf: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
        t0: float, device: str = "cuda", dtype=None) -> Dict:
    """One run of a training cell (``dtype`` bfloat16: the control); returns
    its outcome (see ``common.outcome``)."""
    import torch

    bf16 = dtype == torch.bfloat16
    t0_wall = time.time() - (time.perf_counter() - t0)
    if traffic["world"] == 1:
        ranks = [rank_run(conf, traffic, seed, seconds, trace, t0_wall, 0, 1, device, bf16)]
    else:
        ranks = _spawn(workload, conf, traffic, seed, seconds, trace, t0_wall, bf16, device)
    return _outcome(ranks, traffic, _cfg_tree(conf, seed, bf16))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(workload, conf, traffic, seed, seconds, trace, t0_wall, bf16, device) -> List[Dict]:
    """One worker process a rank; their results, rank by rank."""
    world = traffic["world"]
    out_dir = tempfile.mkdtemp(prefix="bench-ranks-")
    with open(os.path.join(out_dir, "inputs.json"), "w") as fh:
        json.dump({"conf": conf, "traffic": traffic}, fh)
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port))
        spec = json.dumps({"kind": traffic["kind"], "rank": rank, "out": out_dir,
                           "t0_wall": t0_wall, "bf16": bf16, "device": device})
        procs.append(subprocess.Popen(
            [sys.executable, *WORKER_ARGV, "--workload", workload,
             "--seed", str(seed), "--seconds", str(seconds), "--trace", str(int(trace)),
             "--rank-worker", spec], env=env, start_new_session=True))
    deadline = time.time() + WORKER_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(f"rank workers {bad} failed: exit codes "
                           f"{[p.returncode for p in procs]}")
    ranks = [common.load_json(os.path.join(out_dir, f"rank{r}.json")) for r in range(world)]
    found = sorted({m for r in ranks for m in r["forbidden"]})
    if found:
        common.log(f"forbidden modules loaded in rank workers: {found}")
        raise SystemExit(4)
    return ranks


def rank_worker(args) -> None:
    """A rank of a multi-rank run, started by ``_spawn``, on the parent's
    configuration and traffic."""
    spec = json.loads(args.rank_worker)
    inputs = common.load_json(os.path.join(spec["out"], "inputs.json"))
    conf, traffic = inputs["conf"], inputs["traffic"]
    res = rank_run(conf, traffic, args.seed, args.seconds, bool(args.trace), spec["t0_wall"],
                   spec["rank"], traffic["world"], spec["device"], spec["bf16"])
    res["forbidden"] = common.forbidden_loaded()  # the window has closed
    with open(os.path.join(spec["out"], f"rank{spec['rank']}.json"), "w") as fh:
        json.dump(res, fh)


def _trainer_args(model_dir: str, workers: int, device: str):
    from stemseg_tpu_torch.training.main import make_parser

    return make_parser().parse_args(["--model_dir", model_dir, "--cfg", "-", "--no_resume",
                                     "--num_cpu_workers", str(workers), "--device", device])


def rank_run(conf: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
             t0_wall: float, rank: int, world: int, device: str, bf16: bool) -> Dict:
    """Set-up, window and (rank 0) the reference of one rank. Returns what
    the parent gathers, JSON-serialisable."""
    import torch

    from stemseg_tpu_torch.config import load_config
    from stemseg_tpu_torch.training.loader import to_device
    from stemseg_tpu_torch.training.main import Trainer
    from stemseg_tpu_torch.utils.distributed import all_reduce_ints

    common.set_numerics()
    tree = _cfg_tree(conf, seed, bf16)
    cfg = load_config(tree)
    trainer = Trainer(cfg, tempfile.mkdtemp(prefix="bench-train-"),
                      _trainer_args(tempfile.mkdtemp(), traffic["workers"], device))
    dev = trainer.device
    with torch.device("meta"):
        shapes = ref_model.Model(tree)
    state = common.random_weights(shapes, common.seed32(seed), dev)
    trainer.model.load_state_dict(state)
    named = [(n, p) for n, p in trainer.model.named_parameters() if p.requires_grad]
    p0 = host_state = None
    if rank == 0:
        host_state = {k: v.detach().to("cpu", copy=True) for k, v in state.items()}
        p0 = {n: host_state[n] for n, _ in named}
    del state, shapes
    common.log(f"rank {rank}: model and weights {time.time() - t0_wall:.3f} s")

    loader = iter(trainer.make_loader(traffic["workers"]))
    acc, step = trainer.accumulate_steps, trainer.train_step
    clock = common.Clock()
    waits: List[float] = []
    losses: List[float] = []

    def optimizer_step(keep_losses: bool) -> None:
        for _ in range(acc):
            t = time.perf_counter()
            batch = clock.span("loader", next, loader)
            waits.append(time.perf_counter() - t)
            metrics = clock.span("step", step, to_device(batch, dev))
            if keep_losses:
                losses.append(float(metrics["total"]))

    # set-up: the first optimizer steps, which the reference follows
    first_grad = after = None
    wd = cfg.training.weight_decay
    for i in range(traffic["setup_steps"]):
        optimizer_step(True)
        if rank == 0 and i == 0:
            # the gradient as the optimizer got it (none where it made no step)
            first_grad = {}
            for n, p in named:
                buf = trainer.optimizer.state.get(p, {}).get("momentum_buffer")
                first_grad[n] = (torch.zeros_like(p0[n]) if buf is None else
                                 buf.to("cpu", copy=True) - wd * p0[n])
    if rank == 0:
        after = {n: p.detach().to("cpu", copy=True) for n, p in named}
    setup_peak = 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_reserved(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_waits = len(waits)
    clock.spans.clear()

    # the window
    prof = common.start_profiler() if trace and rank == 0 else None
    t_start = time.perf_counter()
    start_wall = time.time()
    with torch.profiler.record_function("bench.window_start"):
        pass
    steps = 0
    while True:
        optimizer_step(False)
        steps += 1
        stop = int(time.perf_counter() - t_start >= seconds) if rank == 0 else 0
        if world > 1:
            stop = all_reduce_ints([stop], dev, op="max")[0]
        if stop:
            break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t_start
    with torch.profiler.record_function("bench.window_end"):
        pass
    reduced = None
    if prof is not None:
        prof.stop()
        reduced = common.reduce_trace(prof, dev.index or 0)
        del prof
    peak_reserved = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
    common.log(f"rank {rank}: window {window_s:.3f} s, {steps} steps; set-up "
               f"{start_wall - t0_wall:.3f} s; peak reserved {peak_reserved / common.GIB:.3f} GiB")
    getattr(loader, "_shutdown_workers", lambda: None)()
    rank_gap = _rank_gap(trainer.model, world, dev)
    window_waits = waits[setup_waits:]
    res = {"rank": rank, "steps": steps, "window_s": window_s, "setup_s": start_wall - t0_wall,
           "peak_reserved": peak_reserved, "setup_peak": setup_peak,
           "clips": steps * acc * cfg.training.max_samples_per_chip,
           "loader_wait_ms": float(np.mean(window_waits)) * 1e3 if window_waits else None,
           "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
           "rank_gap": rank_gap, "losses": losses}
    if reduced is not None:
        res["trace"] = {"busy_s": reduced["busy_s"], "window_s": reduced["window_s"],
                        "by_op": reduced["by_op"], "gaps": reduced["gaps"],
                        "nccl_s": sum(e - s for n, s, e in reduced["device"]
                                      if "nccl" in n.lower()) / 1e9}
    # the program's state goes before the reference runs
    del trainer, step, loader, named
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    if rank == 0:
        t_ref = time.perf_counter()
        res["checks"] = _compare(tree, traffic, host_state, p0, first_grad, after, losses,
                                 world, dev)
        common.log(f"reference {time.perf_counter() - t_ref:.3f} s")
    return res


def _rank_gap(model, world: int, dev) -> float:
    """The largest difference between a parameter on any rank and rank 0's:
    0 when the ranks hold one model, as data parallelism promises."""
    if world == 1:
        return 0.0
    import torch
    import torch.distributed as dist

    gap = torch.zeros((), device=dev)
    with torch.no_grad():
        for p in model.parameters():
            q = p.detach().clone()
            dist.broadcast(q, src=0)
            gap = torch.maximum(gap, (p.detach() - q).abs().max())
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap)


def _leaf_gap(prog: Dict, want: Dict, keep=None) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    names = [n for n in want if keep is None or keep(n)]
    ref_norms = {n: float(want[n].double().norm()) for n in names}
    median = float(np.median(list(ref_norms.values())))
    return max(abs(float(prog[n].double().norm()) - ref_norms[n]) / max(ref_norms[n], median)
               for n in names)


def _compare(tree, traffic, host_state, p0, first_grad, after, losses, world, dev):
    """The reference over the set-up's steps: (name, value, limit) of the
    worst micro-step's loss gap, the worst leaf's first-gradient gap and the
    worst leaf's parameter-change gap (leaves whose reference gradient is
    under a thousandth of the median leaf's left out of the change)."""
    want = ref_train.train_steps(tree, host_state, world, traffic["setup_steps"],
                                 ref_model.frozen_names(tree), dev)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want["losses"]))
    grad_gap = _leaf_gap(first_grad, want["first_grad"])
    g_norms = {n: float(g.double().norm()) for n, g in want["first_grad"].items()}
    floor = 1e-3 * float(np.median(list(g_norms.values())))
    change = {n: after[n] - p0[n] for n in after}
    change_ref = {n: want["params"][n] - p0[n] for n in after}
    change_gap = _leaf_gap(change, change_ref, keep=lambda n: g_norms[n] >= floor)
    limits = traffic["check"]["limits"]
    return [("loss_gap", loss_gap, limits["loss_gap"]),
            ("grad_gap", grad_gap, limits["grad_gap"]),
            ("change_gap", change_gap, limits["change_gap"])]


def _outcome(ranks: List[Dict], traffic: Dict, tree: Dict) -> Dict:
    r0 = ranks[0]
    world = len(ranks)
    checks = list(r0["checks"])
    if world > 1:
        checks.append(("rank_gap", max(r["rank_gap"] for r in ranks),
                       traffic["check"]["limits"]["rank_gap"]))
    clips = sum(r["clips"] for r in ranks)
    peak = max(r["peak_reserved"] for r in ranks)
    device = {"platform": "gpu" if r0["kind"] != "cpu" else "cpu", "kind": r0["kind"],
              "count": world,
              "memory_peak_bytes": max(max(r["peak_reserved"], r["setup_peak"]) for r in ranks)}
    e2e = {"clips_per_s": clips / r0["window_s"],
           "setup_s": r0["setup_s"],
           "peak_reserved_gib": peak / common.GIB}
    ctx, reduced = None, None
    if "trace" in r0:
        from .. import counts

        scfg, icfg = tree["data"]["synthetic"], tree["input"]
        hw = (-(-(scfg["height"] or icfg["min_dim"]) // 32) * 32,
              -(-(scfg["width"] or icfg["max_dim"]) // 32) * 32)
        reduced = r0["trace"]
        device.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
        ctx = {"kind": "train", "trace": reduced, "window_s": r0["window_s"],
               "steps": r0["steps"], "clips": clips, "chips": world,
               "loader_wait_ms": max(r["loader_wait_ms"] for r in ranks),
               "flops_per_clip": counts.training_flops(tree, hw),
               "power": common.card_power_limit()}
    return common.outcome(r0["steps"], 0, e2e, device, checks, ctx, reduced)
