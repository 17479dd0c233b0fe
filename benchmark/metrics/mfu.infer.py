"""Share (%) of the card's float32 peak (67 TFLOP/s outside the tensor
cores; TF32 is off) that the model work of the window's frames takes:
backbone + FPN once a frame and the heads once a window, at the padded
network input, counted on the reference model (``counts``), over the
traced window's host-clock length. Moves ``frames_per_s``."""

from benchmark import counts


def read(ctx):
    if ctx.get("kind") != "infer" or not ctx["frames"]:
        return None
    return ctx["flops"] / ctx["window_s"] / counts.PEAK_FP32_FLOPS * 100.0
