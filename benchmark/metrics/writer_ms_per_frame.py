"""Milliseconds a frame of the dataset's writer (``inference/output_utils``):
the benchmark's host clock around each ``process_sequence`` call and the
YT-VIS ``save()``, over the window's frames. Moves ``frames_per_s``."""


def read(ctx):
    if ctx.get("kind") != "infer" or not ctx["frames"]:
        return None
    clock = ctx["clock"]
    return (clock.total("writer") + clock.total("save")) * 1e3 / ctx["frames"]
