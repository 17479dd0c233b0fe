"""Milliseconds a frame of the fused path's masks, clustering and
association (``inference/fused_pipeline``): the stream time of the
program's ``fused.derive`` and ``fused.scan_b`` spans over the window's
frames. Moves ``frames_per_s``."""

from benchmark import spans


def read(ctx):
    if ctx.get("kind") != "infer" or not ctx["frames"]:
        return None
    records = spans.session()
    ms = spans.stream_ms(records, "fused.derive", "fused.scan_b") if records else None
    return None if ms is None else ms / ctx["frames"]
