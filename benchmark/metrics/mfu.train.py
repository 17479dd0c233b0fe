"""Share (%) of the cards' float32 peak (67 TFLOP/s a card, outside the
tensor cores; TF32 is off) that the window's training work takes: forward
and backward FLOPs of a clip (weight and data gradients of what the preset
trains, counted on the reference model, ``counts.training_flops``) times
the clips of the window's optimizer steps over all ranks, over the window
and the cards. Moves ``clips_per_s``."""

from benchmark import counts


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    return (ctx["flops_per_clip"] * ctx["clips"] / ctx["window_s"]
            / (counts.PEAK_FP32_FLOPS * ctx["chips"]) * 100.0)
