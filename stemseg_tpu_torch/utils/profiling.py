"""The ``--profile DIR`` trace of both CLIs: a ``torch.profiler`` session
over the CPU and, on a GPU, the device, written as a chrome trace to
``DIR/trace.json``."""

from __future__ import annotations

import os

import torch

from stemseg_tpu_torch.utils.device import synchronize


def start_trace(device: torch.device):
    """A started profiler session for work on ``device``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def write_trace(profiler, out_dir: str, device: torch.device) -> str:
    """Waits for ``device``, stops ``profiler`` and writes its trace; returns
    the trace's path."""
    synchronize(device)
    profiler.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    profiler.export_chrome_trace(path)
    print(f"Profile trace written to {path}")
    return path
