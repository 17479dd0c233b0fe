"""Milliseconds a frame of the writer's host work (``inference/output_utils``):
the host time of the program's ``writer.encode`` spans (the PNG's condense
and write, the RLE encoding) over the window's frames. Moves
``frames_per_s``."""

from benchmark import spans


def read(ctx):
    if ctx.get("kind") != "infer" or not ctx["frames"]:
        return None
    records = spans.session()
    ms = spans.host_ms(records, "writer.encode") if records else None
    return None if ms is None else ms / ctx["frames"]
