"""Share (%) of the traced window's wall with no kernel, copy or memset on
rank 0's card (the union of the profiler's device intervals). Moves
``clips_per_s``."""


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("kind") != "train" or not trace or trace["window_s"] <= 0:
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"]) * 100.0
