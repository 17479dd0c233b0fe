"""Milliseconds of NCCL kernels an optimizer step on rank 0's card
(``parallel/mesh``: the gradient all-reduce, and the step's small
all-reduces of counts and of the window's stop flag), from the profiler's
device trace. None without a collective. Moves ``clips_per_s``."""


def read(ctx):
    if ctx.get("kind") != "train" or ctx["chips"] < 2 or not ctx["trace"]["nccl_s"]:
        return None
    return ctx["trace"]["nccl_s"] * 1e3 / ctx["steps"]
