"""Milliseconds a clip of the training backward (``training/step``,
``models``): the stream time of the program's ``step.backward`` spans
(``torch.autograd.grad``) over the window's clips. Moves ``clips_per_s``."""

from benchmark import spans


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["clips"]:
        return None
    records = spans.session()
    ms = spans.stream_ms(records, "step.backward") if records else None
    return None if ms is None else ms / ctx["clips"]
