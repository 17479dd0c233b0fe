"""Cache releases of the fused path in the window
(``inference/fused_pipeline``): the program's ``fused.cache_releases``
counter, one for each run that warmed a per-window body up, when the
caching allocator's free blocks go back to the card. Moves
``peak_reserved_gib``."""

from benchmark import spans


def read(ctx):
    if ctx.get("kind") != "infer":
        return None
    records = spans.session()
    if not records or not spans.named(records, ["fused.run"]):
        return None
    return records["counters"].get("fused.cache_releases", 0)
