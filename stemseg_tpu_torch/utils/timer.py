"""Named wall-clock timers with inclusion/exclusion decorators.

``log_duration(name)`` accumulates a function's wall time under ``name``;
``exclude_duration(*names)`` subtracts the wrapped call's wall time from the
given timers, so that image I/O stays out of the fps report. Work queued on
a CUDA device is only finished when the host synchronises, so the timed
functions of the inference CLI end in a synchronise.
"""

from __future__ import annotations

import functools
import time
from collections import defaultdict
from typing import Dict


class Timer:
    _durations: Dict[str, float] = defaultdict(float)
    _exclusions: Dict[str, float] = defaultdict(float)

    @classmethod
    def reset(cls):
        cls._durations = defaultdict(float)
        cls._exclusions = defaultdict(float)

    @classmethod
    def log_duration(cls, name: str):
        def decorator(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    cls._durations[name] += time.perf_counter() - t0
            return wrapper
        return decorator

    @classmethod
    def exclude_duration(cls, *names: str):
        def decorator(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    dt = time.perf_counter() - t0
                    for name in names:
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
