"""Share (%) of the traced window's wall with no kernel, copy or memset on
the card (the union of the profiler's device intervals). Moves
``frames_per_s``."""


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("kind") != "infer" or trace is None or trace["window_s"] <= 0:
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"]) * 100.0
