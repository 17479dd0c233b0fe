"""Milliseconds a frame the card idles inside the fused path (``device``):
the idle gaps between the traced window's device intervals whose middle
lies inside one of the program's ``fused.*`` spans, over the window's
frames. Moves ``frames_per_s``."""

from benchmark import spans


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("kind") != "infer" or trace is None or not trace["device"] or not ctx["frames"]:
        return None  # no device traced (the CPU): no idle time to read
    records = spans.session()
    if not records or not spans.named(records, ["fused.run"]):
        return None
    return sum(spans.idle_by_span(trace["device"], records, "fused.").values()) / ctx["frames"]
