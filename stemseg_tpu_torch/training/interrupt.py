"""Cooperative interrupt handling: SIGINT / SIGTERM set a flag that the
trainer polls after each optimizer step, to checkpoint and then exit."""

from __future__ import annotations

import signal


class InterruptException(RuntimeError):
    pass


class InterruptDetector:
    def __init__(self):
        self._interrupted = False
        self._previous = None

    def start(self):
        if self._previous is not None:
            return
        self._previous = {s: signal.signal(s, self._handler)
                          for s in (signal.SIGINT, signal.SIGTERM)}

    def stop(self):
        """Put back the handlers that were installed before ``start``."""
        if self._previous is None:
            return
        for s, handler in self._previous.items():
            signal.signal(s, handler)
        self._previous = None

    def _handler(self, signum, frame):
        self._interrupted = True

    def raise_if_interrupted(self):
        if self._interrupted:
            raise InterruptException("training interrupted by signal")
