"""Milliseconds a frame of the fused path (``inference/fused_pipeline``
through ``TrackGenerator``): the host clock around each sequence's call,
less its writer span, over the window's frames. The fused run ends in its
fetch, which waits for the device. Moves ``frames_per_s``."""


def read(ctx):
    if ctx.get("kind") != "infer" or not ctx["frames"]:
        return None
    clock = ctx["clock"]
    return (clock.total("sequence") - clock.total("writer")) * 1e3 / ctx["frames"]
