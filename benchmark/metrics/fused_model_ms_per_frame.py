"""Milliseconds a frame of the model in the fused path (``models``:
backbone, FPN, heads): the stream time of the program's ``fused.prelude``
and ``fused.scan_a`` spans (backbone and FPN of each window's new frames,
the heads on the window) over the window's frames. Moves
``frames_per_s``."""

from benchmark import spans


def read(ctx):
    if ctx.get("kind") != "infer" or not ctx["frames"]:
        return None
    records = spans.session()
    ms = spans.stream_ms(records, "fused.prelude", "fused.scan_a") if records else None
    return None if ms is None else ms / ctx["frames"]
