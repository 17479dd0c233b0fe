"""Milliseconds a clip of the training forward and losses (``training/step``,
``models``, ``losses``): the stream time of the program's ``step.forward``
and ``step.loss`` spans over the window's clips. Moves ``clips_per_s``."""

from benchmark import spans


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["clips"]:
        return None
    records = spans.session()
    ms = spans.stream_ms(records, "step.forward", "step.loss") if records else None
    return None if ms is None else ms / ctx["clips"]
