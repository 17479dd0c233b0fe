"""CUDA graphs the fused path captured in the window
(``inference/fused_pipeline``): the program's ``fused.captures`` counter.
Moves ``frames_per_s``."""

from benchmark import spans


def read(ctx):
    if ctx.get("kind") != "infer":
        return None
    records = spans.session()
    if not records or not spans.named(records, ["fused.run"]):
        return None
    return records["counters"].get("fused.captures", 0)
