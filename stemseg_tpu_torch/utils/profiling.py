"""Tracing: the ``--profile DIR`` session of both CLIs, and the port's own
spans and counters on that session's clock.

``start_trace`` / ``write_trace``: a ``torch.profiler`` session over the
CPU and, on a GPU, the device, written as a chrome trace to
``DIR/trace.json``, with the per-span totals and the counters printed.

``span(name)`` marks a layer boundary and ``count(name, n)`` counts work
there. Both act only while a ``torch.profiler`` session records on the
calling thread (the CLIs' ``--profile``, the benchmark's traced window);
otherwise a span costs one check and returns at once: no
``record_function``, no clock read, no CUDA event, no allocation. While
one records, a span enters ``record_function("stemseg." + name)`` (so it
shows in the trace) and keeps a record: its name, its parent (the
innermost span open on its thread), the id of its top-level span (the
outermost open span that was given an ``ident``), its thread, and its start
and end from ``time.time_ns()``, the base the profiler stamps its host and
device events in. ``span(name, device=True)`` on a CUDA device also records
a CUDA event at entry and exit on the current stream; their elapsed time,
the span's stream milliseconds, is read only when the records are read,
and the recorder adds no synchronisation. Never open a span inside a body
that is captured into a CUDA graph: wrap the call that captures or
replays it.

A session of records starts when a profiler session starts (the recorder
wraps ``torch.autograd.profiler._run_on_profiler_start``, which every
``torch.profiler`` session calls as it starts; on a torch without it, at
the first span or count that finds a profiler recording and no session
open). It ends when the next one starts, at ``write_trace``, or when
``last_session`` on the session's thread finds the profiler stopped; its
records then replace those of the session before: ``last_session``
returns them.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from stemseg_tpu_torch.utils.device import synchronize

PREFIX = "stemseg."
_recording = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Session:
    def __init__(self):
        self.thread = threading.get_ident()
        self.spans: List[_Span] = []
        self.counters: Dict[str, int] = defaultdict(int)


class _Recorder:
    """The open session, the last closed one and each thread's open spans."""

    def __init__(self):
        self.current: Optional[_Session] = None
        self.last: Optional[_Session] = None
        self.local = threading.local()
        self.lock = threading.Lock()

    def session(self) -> _Session:
        with self.lock:
            if self.current is None:
                self.current = _Session()
            return self.current

    def begin(self) -> None:
        with self.lock:
            self.last, self.current = self.current or self.last, _Session()

    def end(self) -> None:
        with self.lock:
            if self.current is not None:
                self.last, self.current = self.current, None

    def found_off(self) -> None:
        """Ends the open session if it is this thread's: its profiler stopped."""
        current = self.current
        if current is not None and current.thread == threading.get_ident():
            self.end()

    def stack(self) -> List["_Span"]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_recorder = _Recorder()


def _begin_with_profiler() -> None:
    """Makes every profiler session that starts begin a session of records.
    torch exposes no session identity, so without this hook two sessions
    run back to back with no read between would share one session of
    records."""
    mod = torch.autograd.profiler
    start = getattr(mod, "_run_on_profiler_start", None)
    if start is None or getattr(start, "begins_records", False):
        return

    def run_on_profiler_start():
        start()
        _recorder.begin()

    run_on_profiler_start.begins_records = True
    mod._run_on_profiler_start = run_on_profiler_start


_begin_with_profiler()


class _Span:
    __slots__ = ("name", "ident", "device", "parent", "top", "thread", "start", "end",
                 "events", "_rf")

    def __init__(self, name: str, device: bool, ident):
        self.name, self.device, self.ident = name, device, ident
        self.end = self.events = None

    def __enter__(self):
        session = _recorder.session()
        stack = _recorder.stack()
        self.parent = parent = stack[-1] if stack else None
        self.top = parent.top if parent is not None and parent.top is not None else self.ident
        self.thread = threading.get_ident()
        self._rf = torch.profiler.record_function(PREFIX + self.name)
        self._rf.__enter__()
        if self.device:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack.append(self)
        session.spans.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        _recorder.stack().pop()
        self._rf.__exit__(*exc)
        return False


def span(name: str, device: bool = False, ident=None):
    """A context manager marking ``name``'s boundary (module docstring).

    :param device: also time the span on the current CUDA stream (pass
        True only when the work inside runs on a CUDA device)
    :param ident: the id of this span's work (a run, a step), inherited as
        the top-level id by the spans inside it when no enclosing span has
        one"""
    if not _recording():
        return _OFF
    return _Span(name, device, ident)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` of the recording session (a no-op
    when none records)."""
    if not _recording():
        return
    session = _recorder.session()
    with _recorder.lock:
        session.counters[name] += n


def last_session() -> Optional[Dict]:
    """The records of the last session that ended, or None: ``spans``, one
    dict each in the order they were entered (``name``, ``index``,
    ``parent`` (an index or None), ``top``, ``thread``, ``start_ns``,
    ``end_ns``, ``host_ms``, ``stream_ms`` (None for a host-only span),
    ``self_ms``: host ms less its children's); and ``counters``, the
    counts' totals by name. Spans still open are left out.
    Reading the stream times waits for their end events."""
    if not _recording():
        _recorder.found_off()
    session = _recorder.last
    if session is None:
        return None
    done = [s for s in session.spans if s.end is not None]
    index = {id(s): i for i, s in enumerate(done)}
    spans = []
    for i, s in enumerate(done):
        stream_ms = None
        if s.events is not None:
            s.events[1].synchronize()
            stream_ms = s.events[0].elapsed_time(s.events[1])
        spans.append({"name": s.name, "index": i,
                      "parent": None if s.parent is None else index.get(id(s.parent)),
                      "top": s.top, "thread": s.thread, "start_ns": s.start, "end_ns": s.end,
                      "host_ms": (s.end - s.start) / 1e6, "stream_ms": stream_ms,
                      "self_ms": (s.end - s.start) / 1e6})
    for rec in spans:
        if rec["parent"] is not None:
            spans[rec["parent"]]["self_ms"] -= rec["host_ms"]
    return {"spans": spans, "counters": dict(session.counters)}


def span_totals(records: Dict) -> Dict[str, Dict[str, float]]:
    """Per span name of ``last_session()``'s records: ``calls``, ``host_ms``,
    ``stream_ms`` (summed over the spans that have one, None where none
    has) and ``self_ms``."""
    out: Dict[str, Dict] = {}
    for s in records["spans"]:
        t = out.setdefault(s["name"], {"calls": 0, "host_ms": 0.0, "stream_ms": None,
                                       "self_ms": 0.0})
        t["calls"] += 1
        t["host_ms"] += s["host_ms"]
        t["self_ms"] += s["self_ms"]
        if s["stream_ms"] is not None:
            t["stream_ms"] = (t["stream_ms"] or 0.0) + s["stream_ms"]
    return out


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
    """Waits for ``device``, stops ``profiler`` and writes its trace; prints
    the session's span totals and counters; returns the trace's path."""
    synchronize(device)
    profiler.stop()
    _recorder.end()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    profiler.export_chrome_trace(path)
    print(f"Profile trace written to {path}")
    records = last_session()
    if records is not None:
        for name, t in sorted(span_totals(records).items()):
            stream = "-" if t["stream_ms"] is None else f"{t['stream_ms']:.3f}"
            print(f"span {PREFIX}{name}: {t['calls']} calls, host {t['host_ms']:.3f} ms, "
                  f"stream {stream} ms, self {t['self_ms']:.3f} ms")
        for name, n in sorted(records["counters"].items()):
            print(f"counter {PREFIX}{name}: {n}")
    return path
