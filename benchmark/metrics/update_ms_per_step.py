"""Milliseconds an optimizer step of the gradient's bookkeeping and the
update (``training/step``, ``training/optim``): the stream time of the
program's ``step.accumulate`` (each micro-step's gradient norm and running
mean) and ``step.update`` spans over the window's optimizer steps. Moves
``clips_per_s``."""

from benchmark import spans


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    records = spans.session()
    ms = spans.stream_ms(records, "step.accumulate", "step.update") if records else None
    return None if ms is None else ms / ctx["steps"]
