"""Training metrics logging and the wall-clock ETA.

Scalars go to ``metrics.jsonl`` (always) and to tensorboardX when it can be
imported; each optimizer step's end (wall clock) and the loader's wait
before it go to ``steps.jsonl``; the console line uses the same abbreviations as the JAX
package's logger. The ETA counts the time of earlier sessions too: the
elapsed time goes into the checkpoint through ``state_dict``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

ABBREVIATIONS = {
    "total_embedding": "E",
    "lovasz": "L",
    "var_smoothness": "VS",
    "seediness": "S",
    "semseg": "CE",
    "fg": "FG",
    "total": "T",
    "grad_norm": "GN",
    "lr": "LR",
}


class TrainingLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self.steps_path = os.path.join(log_dir, "steps.jsonl")

        self._tb_writer = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb_writer = SummaryWriter(log_dir)

        self._start_time = time.time()
        self._elapsed_before_start = 0.0  # summed over restored sessions

    def add_scalars(self, scalars: Dict[str, float], step: int):
        record = {"step": step, **{k: float(v) for k, v in scalars.items()}}
        with open(self.jsonl_path, "a") as fh:
            fh.write(json.dumps(record) + "\n")
        if self._tb_writer is not None:
            for k, v in scalars.items():
                self._tb_writer.add_scalar(k, float(v), step)

    def add_step(self, step: int, loader_wait: float):
        """One optimizer step ended now; the loader kept it waiting
        ``loader_wait`` seconds (its micro-batches' waits summed)."""
        with open(self.steps_path, "a") as fh:
            fh.write(json.dumps({"step": step, "time": time.time(),
                                 "loader_wait": loader_wait}) + "\n")

    def close(self):
        if self._tb_writer is not None:
            self._tb_writer.close()

    @staticmethod
    def format_console_line(step: int, total: int, scalars: Dict[str, float],
                            sec_per_iter: float, eta_seconds: float) -> str:
        parts = [f"it {step}/{total}"]
        for k, v in scalars.items():
            parts.append(f"{ABBREVIATIONS.get(k, k)}: {float(v):.4f}")
        parts.append(f"{sec_per_iter:.3f}s/it")
        hours, rem = divmod(int(eta_seconds), 3600)
        minutes, seconds = divmod(rem, 60)
        parts.append(f"ETA {hours:02d}:{minutes:02d}:{seconds:02d}")
        return " | ".join(parts)

    def total_elapsed(self) -> float:
        return self._elapsed_before_start + (time.time() - self._start_time)

    def compute_eta(self, elapsed_iterations: int, total_iterations: int) -> float:
        """Seconds left at the mean time per iteration over all sessions."""
        if elapsed_iterations == 0:
            return 0.0
        sec_per_iter = self.total_elapsed() / elapsed_iterations
        return sec_per_iter * (total_iterations - elapsed_iterations)

    def state_dict(self) -> Dict:
        return {"elapsed": self.total_elapsed()}

    def load_state_dict(self, state: Dict):
        self._elapsed_before_start = float(state.get("elapsed", 0.0))
        self._start_time = time.time()
