"""Share (%) of the FLOP roofline of the training forward's backbone and
FPN (``models``, inside ``training/step``): the forward FLOPs of a clip's
frames (``backbone_flops_per_clip``, counted on the reference, which only
the ``train_resnext`` driver puts in the context) times the window's clips,
at the card's float32 peak of 67 TFLOP/s (TF32 is off), over the stream
time of the program's ``step.backbone`` spans. The FLOP bound is the
larger for the backbone as a whole (the grouped 3x3s of 8 channels a group
sit near the card's ridge of 20 FLOP a byte, the other convolutions well
above it), so bytes are not counted. Moves ``clips_per_s``."""

from benchmark import counts, spans


def read(ctx):
    flops = ctx.get("backbone_flops_per_clip")
    if ctx.get("kind") != "train" or not flops or not ctx["clips"]:
        return None
    records = spans.session()
    ms = spans.stream_ms(records, "step.backbone") if records else None
    if not ms:
        return None
    return flops * ctx["clips"] / counts.PEAK_FP32_FLOPS / (ms / 1e3) * 100.0
