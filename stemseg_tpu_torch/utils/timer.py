"""Named wall-clock timers with inclusion/exclusion decorators.

``log_duration(name)`` accumulates a function's wall time under ``name``
and marks the call as the span ``cli.<name>`` (``utils.profiling``);
``exclude_duration(*names)`` subtracts the wrapped call's wall time from
those of the given timers that are open around the call (a ``log_duration``
of that name is running), so that image I/O inside a timed phase stays out
of the fps report and I/O outside every timed phase subtracts nothing. Work
queued on a CUDA device is only finished when the host synchronises, so the
timed functions of the inference CLI end in a synchronise.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from typing import Dict

from stemseg_tpu_torch.utils.profiling import span


class Timer:
    _durations: Dict[str, float] = defaultdict(float)
    _exclusions: Dict[str, float] = defaultdict(float)
    _open: Dict[str, int] = defaultdict(int)  # nesting depth per name

    @classmethod
    def reset(cls):
        cls._durations = defaultdict(float)
        cls._exclusions = defaultdict(float)
        cls._open = defaultdict(int)

    @classmethod
    def log_duration(cls, name: str):
        def decorator(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                cls._open[name] += 1
                t0 = time.perf_counter()
                try:
                    with span("cli." + name):
                        return fn(*args, **kwargs)
                finally:
                    cls._durations[name] += time.perf_counter() - t0
                    cls._open[name] -= 1
            return wrapper
        return decorator

    @classmethod
    def exclude_duration(cls, *names: str):
        def decorator(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                inside = [name for name in names if cls._open[name] > 0]
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    dt = time.perf_counter() - t0
                    for name in inside:
                        cls._exclusions[name] += dt
            return wrapper
        return decorator

    @classmethod
    def get_duration(cls, name: str) -> float:
        return max(cls._durations[name] - cls._exclusions[name], 0.0)

    @classmethod
    def get_durations_sum(cls) -> float:
        total = sum(cls._durations.values()) - sum(cls._exclusions.values())
        return max(total, 0.0)
