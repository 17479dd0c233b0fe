"""What the readers of the program's own spans and counters share: the
records of the program's last profiler session
(``stemseg_tpu_torch.utils.profiling.last_session``), which in a traced
run are the window's. A program without that recorder, or a run whose
session was held by other processes (the ranks of a multi-rank run), has
none to give, and the readers then return None."""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

from benchmark import common


def session() -> Optional[Dict]:
    """The program's last session of records, or None."""
    from stemseg_tpu_torch.utils import profiling

    read = getattr(profiling, "last_session", None)
    return read() if read is not None else None


def named(records: Dict, names: Iterable[str]) -> List[Dict]:
    names = set(names)
    return [s for s in records["spans"] if s["name"] in names]


def stream_ms(records: Dict, *names: str) -> Optional[float]:
    """Summed stream milliseconds of the spans ``names``; None where none
    of them was timed on the device."""
    ms = [s["stream_ms"] for s in named(records, names) if s["stream_ms"] is not None]
    return sum(ms) if ms else None


def host_ms(records: Dict, *names: str) -> Optional[float]:
    """Summed host milliseconds of the spans ``names``; None where there is
    none."""
    spans = named(records, names)
    return sum(s["host_ms"] for s in spans) if spans else None


def idle_by_span(device: List[Tuple[str, int, int]], records: Dict,
                 prefix: str) -> Dict[str, float]:
    """Milliseconds of the idle gaps between the device intervals
    (``reduce_trace``'s ``device``: name, start and end in ns), and before
    the first and after the last of them within the records' extent, each
    given to the innermost span named ``prefix``* over its middle; gaps
    whose middle no such span covers are left out. The spans come from one
    thread, so they nest."""
    if not records["spans"]:
        return {}
    lo = min(s["start_ns"] for s in records["spans"])
    hi = max(s["end_ns"] for s in records["spans"])
    edges = [lo] + [x for iv in common._merge([(s, e) for _, s, e in device]) for x in iv] + [hi]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    spans = sorted((s["start_ns"], -s["end_ns"], s["name"]) for s in records["spans"]
                   if s["name"].startswith(prefix))
    starts = [s for s, _, _ in spans]
    out: Dict[str, float] = {}
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for s, e in gaps:
        mid = (s + e) // 2
        j = bisect.bisect_right(starts, mid)
        for start, neg_end, name in spans[i:j]:
            while stack and stack[-1][1] <= start:
                stack.pop()
            stack.append((start, -neg_end, name))
        i = max(i, j)
        while stack and stack[-1][1] <= mid:
            stack.pop()
        if stack:
            name = stack[-1][2]
            out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return out
