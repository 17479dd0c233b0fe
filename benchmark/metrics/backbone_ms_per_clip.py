"""Milliseconds a clip of the training forward's backbone and FPN
(``models``, inside ``training/step``): the stream time of the program's
``step.backbone`` spans over the window's clips. Moves ``clips_per_s``."""

from benchmark import spans


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["clips"]:
        return None
    records = spans.session()
    ms = spans.stream_ms(records, "step.backbone") if records else None
    return None if ms is None else ms / ctx["clips"]
