"""A sustained training run through the trainer's CLI, interrupted and
resumed:

    python -m stemseg_tpu_torch.tools.train_sustained --model_dir D \
        [--cfg T | PRESET | FILE] [--steps 300] [--interrupt_at 150] [--bf16] \
        [--num_cpu_workers 4] [--score] [--device cuda]

1. writes the config into ``D/sustained.yaml``: ``--cfg T`` (the default)
   is ``davis_1`` on ``training.mode: synthetic`` (moving blobs, no data);
   a preset name trains in the preset's own mode on datasets that
   ``chip_smoke.write_training_datasets`` writes into ``D/data`` (each
   dataset's layout and frame size); a config file is taken as it is.
   ``max_iterations`` is ``--steps``; ``--bf16`` sets
   ``training.mixed_precision``;
2. session 1: ``python -m stemseg_tpu_torch.training.main`` as a
   subprocess, every step logged; after it prints iteration
   ``--interrupt_at`` it gets a SIGINT, and must checkpoint and exit 0;
3. session 2: the same command, which must auto-resume from that
   checkpoint and run to ``--steps``;
4. checks that the steps stitched (``logs/metrics.jsonl`` and
   ``logs/steps.jsonl`` hold each step 1..N once) and that the mean loss
   of the last k steps is below that of the first k (``--k``, at most a
   quarter of the steps); reports each session's steps/s and the loader's
   waits after its workers' first queue drained (``2 * num_cpu_workers``
   micro-batches), from ``logs/steps.jsonl`` (host clock);
5. with ``--score``, runs ``tools.eval_all`` on the first and the last
   checkpoint against the validation sets ``chip_smoke.write_eval_datasets``
   writes into ``D/eval_data`` (the dataset of the training mode: DAVIS for
   ``synthetic`` and ``davis``);
6. writes ``D/sustained_summary.json`` and prints it; exits non-zero when a
   check failed.

The generated datasets come from ``chip_smoke.py`` at the root of the
checkout, which this tool puts on ``sys.path``. ``D`` must not hold an
earlier run (session 1 would resume from it).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EVAL_DATASETS = {"synthetic": "davis", "davis": "davis", "youtube_vis": "ytvis",
                 "kitti_mots": "kittimots"}
EVAL_CKPT = {"davis": "davis.pth", "ytvis": "youtube_vis.pth", "kittimots": "kitti_mots.pth"}


def _chip_smoke():
    if CHECKOUT not in sys.path:
        sys.path.insert(0, CHECKOUT)
    import chip_smoke

    return chip_smoke


def write_cfg(args) -> Tuple[str, object, Dict[str, str]]:
    """(config path, config, dataset environment variables)."""
    from stemseg_tpu_torch.config import load_config, load_preset, merge, save_config

    if args.cfg == "T":
        cfg = merge(load_preset("davis_1"), {"training": {"mode": "synthetic"}})
    elif os.path.exists(args.cfg):
        cfg = load_config(args.cfg)
    else:
        cfg = load_preset(args.cfg)
    over = {"max_iterations": args.steps}
    if args.bf16:
        over["mixed_precision"] = True
    cfg = merge(cfg, {"training": over})
    env = {}
    if cfg.training.mode != "synthetic":
        env = _chip_smoke().write_training_datasets(os.path.join(args.model_dir, "data"))
    path = os.path.join(args.model_dir, "sustained.yaml")
    save_config(cfg, path)
    return path, cfg, env


def run_session(cmd: List[str], env: Dict[str, str], log_path: str, timeout_s: float,
                interrupt_at: Optional[int] = None) -> Tuple[int, List[str], float]:
    """Runs the trainer; with ``interrupt_at``, sends it a SIGINT once its
    console shows that iteration. A watchdog kills it after ``timeout_s``.
    Returns (exit code, its output lines, wall seconds)."""
    print(f"+ {' '.join(cmd)}" + (f"   [SIGINT at iteration {interrupt_at}]"
                                  if interrupt_at else ""), flush=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=CHECKOUT, env=env, start_new_session=True)
    timed_out = threading.Event()

    def kill():
        timed_out.set()
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)

    watchdog = threading.Timer(timeout_s, kill)
    watchdog.daemon = True
    watchdog.start()
    lines, sent = [], False
    try:
        with open(log_path, "a") as log:
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                log.write(line)
                sys.stdout.write("| " + line)
                sys.stdout.flush()
                if interrupt_at is not None and not sent and line.startswith("it "):
                    if int(line.split("it ", 1)[1].split("/", 1)[0]) >= interrupt_at:
                        print(f"+ SIGINT to the trainer ({line.split(' |')[0]})", flush=True)
                        os.kill(proc.pid, signal.SIGINT)  # the trainer alone, not its workers
                        sent = True
        rc = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            proc.wait()
    if timed_out.is_set():
        raise TimeoutError(f"the trainer ran past {timeout_s} s and was killed")
    return rc, lines, time.perf_counter() - t0


def read_jsonl(path: str) -> List[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def session_timing(records: List[dict], skip: int) -> dict:
    """Steps/s and loader waits of one session's ``steps.jsonl`` records,
    after its first ``skip`` steps (the workers' first queue)."""
    steady = records[skip:]
    out = {"steps": len(records), "first_step_wait_s": records[0]["loader_wait"],
           "steady_steps": len(steady)}
    if len(steady) >= 2:
        span = steady[-1]["time"] - steady[0]["time"]
        waits = [r["loader_wait"] for r in steady[1:]]
        out.update(steps_per_s=(len(steady) - 1) / span, s_per_step=span / (len(steady) - 1),
                   loader_wait_mean_s=sum(waits) / len(waits), loader_wait_max_s=max(waits))
    return out


def score(args, cfg, ckpts: List[str]) -> Dict[str, dict]:
    """``tools.eval_all`` on each checkpoint, against the generated
    validation set of the training mode's dataset."""
    import shutil

    dataset = EVAL_DATASETS[cfg.training.mode]
    env = dict(os.environ, **_chip_smoke().write_eval_datasets(
        os.path.join(args.model_dir, "eval_data"))[0])
    out = {}
    for ckpt in ckpts:
        step = os.path.basename(ckpt).split(".")[0]
        models = os.path.join(args.model_dir, f"score_{step}")
        os.makedirs(models)
        shutil.copy(os.path.join(args.model_dir, "config.yaml"), models)
        os.symlink(os.path.abspath(ckpt), os.path.join(models, EVAL_CKPT[dataset]))
        cmd = [sys.executable, "-m", "stemseg_tpu_torch.tools.eval_all", "--models_dir", models,
               "--output_dir", os.path.join(models, "out"), "--datasets", dataset,
               "--device", args.device]
        if args.bf16:
            cmd.append("--bf16")
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=CHECKOUT, env=env, capture_output=True, text=True,
                             timeout=args.timeout)
        if res.returncode != 0:
            raise RuntimeError(f"eval_all on {ckpt} failed:\n{res.stdout[-3000:]}\n"
                               f"{res.stderr[-3000:]}")
        out[step] = {"metrics": json.loads(res.stdout.strip().splitlines()[-1])[dataset],
                     "wall_s": time.perf_counter() - t0}
        print(f"+ scored {ckpt}: {out[step]}", flush=True)
    return out


def device_line(device: str) -> Optional[str]:
    if not device.startswith("cuda"):
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--cfg", default="T",
                    help="T (davis_1 on synthetic clips), a preset name (its own mode on "
                         "generated datasets) or a config file")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--interrupt_at", type=int, default=150)
    ap.add_argument("--k", type=int, default=20,
                    help="steps at each end of the loss curve compared")
    ap.add_argument("--bf16", action="store_true", help="training.mixed_precision")
    ap.add_argument("--num_cpu_workers", type=int, default=4)
    ap.add_argument("--score", action="store_true",
                    help="score the first and the last checkpoint with tools.eval_all")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=3600.0, help="seconds a session may take")
    args = ap.parse_args(argv)
    if not 0 < args.interrupt_at < args.steps:
        ap.error("--interrupt_at must lie inside the run")

    os.makedirs(args.model_dir, exist_ok=True)
    if os.listdir(args.model_dir):
        ap.error(f"{args.model_dir} is not empty: session 1 would resume from an earlier run")
    cfg_path, cfg, data_env = write_cfg(args)
    env = dict(os.environ, PYTHONPATH=CHECKOUT, **data_env)
    cmd = [sys.executable, "-u", "-m", "stemseg_tpu_torch.training.main",
           "--model_dir", args.model_dir, "--cfg", cfg_path, "--display_interval", "1",
           "--summary_interval", "1", "--save_interval", str(10 * args.steps),
           "--num_cpu_workers", str(args.num_cpu_workers), "--device", args.device]
    run_log = os.path.join(args.model_dir, "run.log")
    failures = []

    rc1, lines1, wall1 = run_session(cmd, env, run_log, args.timeout, args.interrupt_at)
    saved = [line.split(": ", 1)[1] for line in lines1 if line.startswith("Checkpoint saved to")]
    if rc1 != 0 or not any("Interrupt signal received" in line for line in lines1) \
            or len(saved) != 1:
        raise RuntimeError(f"session 1: exit {rc1}, checkpoints {saved}; it must acknowledge "
                           "the SIGINT and save once")
    steps_path = os.path.join(args.model_dir, "logs", "steps.jsonl")
    n_session1 = len(read_jsonl(steps_path))

    rc2, lines2, wall2 = run_session(cmd, env, run_log, args.timeout)
    if rc2 != 0 or not any(line.startswith(f"Restoring session from {saved[0]}")
                           for line in lines2) \
            or not any("Training complete" in line for line in lines2):
        raise RuntimeError(f"session 2: exit {rc2}; it must resume from {saved[0]} and "
                           "complete")

    metrics = read_jsonl(os.path.join(args.model_dir, "logs", "metrics.jsonl"))
    steps = read_jsonl(steps_path)
    want = list(range(1, args.steps + 1))
    stitched = [r["step"] for r in metrics] == want and [r["step"] for r in steps] == want
    if not stitched:
        failures.append("the steps did not stitch: metrics.jsonl "
                        f"{[r['step'] for r in metrics][:3]}..., steps.jsonl "
                        f"{[r['step'] for r in steps][:3]}...")
    losses = [r["total"] for r in metrics]
    k = max(1, min(args.k, len(losses) // 4))
    first_k, last_k = sum(losses[:k]) / k, sum(losses[-k:]) / k
    if not all(math.isfinite(v) for v in losses):
        failures.append("a loss is not finite")
    if not last_k < first_k:
        failures.append(f"the loss did not fall: first {k} {first_k}, last {k} {last_k}")

    accumulate = max(1, round(cfg.training.batch_size / cfg.training.max_samples_per_chip))
    skip = math.ceil(2 * args.num_cpu_workers / accumulate)
    summary = {
        "cfg": args.cfg, "bf16": args.bf16, "steps": args.steps,
        "interrupted_checkpoint": saved[0], "stitched": stitched,
        "device": args.device, "nvidia_smi": device_line(args.device),
        "num_cpu_workers": args.num_cpu_workers, "accumulate_steps": accumulate,
        "k": k, "loss_first_k": first_k, "loss_last_k": last_k,
        "loss_decreased": last_k < first_k,
        "sessions": [dict(session_timing(steps[:n_session1], skip), wall_s=wall1),
                     dict(session_timing(steps[n_session1:], skip), wall_s=wall2)],
        "loss_curve": losses,
        "terms_first_k": {key: sum(r[key] for r in metrics[:k]) / k for key in metrics[0]
                          if key != "step"},
        "terms_last_k": {key: sum(r[key] for r in metrics[-k:]) / k for key in metrics[0]
                         if key != "step"},
    }
    if args.score:
        from stemseg_tpu_torch.training.checkpoint import find_latest_checkpoint

        summary["scores"] = score(args, cfg, [saved[0], find_latest_checkpoint(args.model_dir)])
    summary["failures"] = failures
    path = os.path.join(args.model_dir, "sustained_summary.json")
    with open(path, "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps({k_: v for k_, v in summary.items() if k_ != "loss_curve"}, indent=1))
    print(f"+ summary in {path}" + (f"; FAILED: {failures}" if failures else ""), flush=True)
    if failures:
        sys.exit(1)
    return summary


if __name__ == "__main__":
    main()
