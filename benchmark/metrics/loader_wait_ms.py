"""Milliseconds a micro-step waits for its batch (``training/loader`` and
``data/``): the benchmark's host clock around each ``next()`` on the
trainer's loader in the window, the mean a micro-step, of the slowest
rank. Moves ``clips_per_s``."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return ctx["loader_wait_ms"]
