"""Share (%) of the bytes roofline of the clustering kernels (``ops``,
``cluster.cu``): the least bytes each call moves (``counts.cluster_bytes``)
at the card's published 3.35 TB/s, over the device time of every
``cluster_kernel`` launch in the traced window, graph replays included.
A profiler session has been seen to lose a launch: the bytes are then
those of the launches it kept. Moves ``frames_per_s``."""

from benchmark import counts


def read(ctx):
    trace = ctx.get("trace")
    if ctx.get("kind") != "infer" or trace is None:
        return None
    launches = [(s, e) for name, s, e in trace["device"] if "cluster_kernel" in name]
    want = ctx["cluster_bytes"]
    if not launches or not want:
        return None
    seconds = sum(e - s for s, e in launches) / 1e9
    n_bytes = sum(want) * min(1.0, len(launches) / len(want))
    return n_bytes / counts.PEAK_BYTES_PER_S / seconds * 100.0
