"""Cooperative interrupt handling: SIGINT / SIGTERM set a flag that the
trainer polls after each optimizer step, to checkpoint and then exit.

Data parallel, the ranks agree: the flag polled is the max over the ranks
(one small all-reduce a step), so every rank stops at the same step, and
none waits in a collective for a rank that has left."""

from __future__ import annotations

import signal
from typing import Optional

import torch

from stemseg_tpu_torch.utils.distributed import all_reduce_ints


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

    def raise_if_interrupted(self, device: Optional[torch.device] = None):
        """Raises if this rank, or with a process group any rank, was
        interrupted. :param device: where the collective's tensor lives"""
        flag = int(self._interrupted)
        if device is not None:
            flag = all_reduce_ints([flag], device, op="max")[0]
        if flag:
            raise InterruptException("training interrupted by signal")
