"""Host counts of the kernel wrappers' launches (``cluster.launch_counts``,
``lsap.launch_counts``) as executions on the device.

A launch made while its thread captures a CUDA graph executes nothing: it
is tallied for the graph (``captured``), and every replay of the graph adds
the graph's tally (``replayed``). So on the fused path, whose windows
replay graphs, the counts equal the launches a profiler trace of the same
run holds.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Tuple

_LOCK = threading.Lock()  # run_batch's host threads launch concurrently
_local = threading.local()


def bump(counts: Dict[str, int], name: str) -> None:
    """One launch of ``name`` into ``counts``, or into the graph this thread
    is capturing."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally.append((counts, name))
        return
    with _LOCK:
        counts[name] += 1


@contextlib.contextmanager
def captured() -> Iterator[List[Tuple[Dict[str, int], str]]]:
    """Inside: this thread's launches are tallied in the yielded list (the
    graph's), not counted."""
    _local.tally = tally = []
    try:
        yield tally
    finally:
        _local.tally = None


def replayed(tally: List[Tuple[Dict[str, int], str]]) -> None:
    """Counts the launches of one replay of a graph whose capture tallied
    ``tally``."""
    with _LOCK:
        for counts, name in tally:
            counts[name] += 1
