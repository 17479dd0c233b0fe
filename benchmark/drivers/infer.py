"""Traffic of kind ``infer``: a dataset pass of the inference CLI's
``TrackGenerator`` (the fused path, then the dataset's writer) over a fixed
list of sequences, timed from the first sequence of the list to the first
sequence boundary after the run's seconds.

The traffic file gives the dataset, the sequences (id, frames, raw height,
raw width) in the order they run, the warm-up sequences, how many
sequences the correctness check samples, and the limit of each number it
compares. The seed makes the weights and the frames only; the work is the
file's.
"""

from __future__ import annotations

import gc
import json
import os
import random
import tempfile
import time
from typing import Dict, List

import numpy as np

from .. import common
from ..reference import infer as ref

WRITERS = {"davis": "DavisOutputGenerator", "ytvis": "YoutubeVISOutputGenerator"}
TRACKS = {"davis": "davis", "ytvis": "youtube_vis"}


class Seq:
    """What ``TrackGenerator`` and the writers read of a sequence."""

    def __init__(self, seq_id: str, n: int, hw):
        self.id, self._n, self.image_dims = seq_id, n, tuple(hw)

    def __len__(self):
        return self._n


class TimedWriter:
    """The dataset's writer, each call on the benchmark's clock."""

    def __init__(self, inner, clock: common.Clock):
        self.inner, self.clock = inner, clock

    def process_sequence(self, *args, **kwargs):
        return self.clock.span("writer", self.inner.process_sequence, *args, **kwargs)

    def save(self):
        return self.clock.span("save", self.inner.save)


def frame_seed(seed: int, index: int) -> int:
    """The frames' generator seed of sequence ``index`` (warm-ups negative)."""
    return (seed * 1_000_003 + index + 1_000) % (2 ** 63)


def make_frames(specs: List, seed: int, offset: int, device) -> List[np.ndarray]:
    import torch

    out = []
    for i, (_, n, h, w) in enumerate(specs):
        out.append(common.moving_discs(n, h, w, frame_seed(seed, offset + i), device)
                   .cpu().numpy())
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out


def centre_fg_logit(state: Dict, cfg: Dict, frames: np.ndarray, device) -> None:
    """In ``state``: the semseg head's fg weights lose their component along
    the head trunk's mean output on the first window of ``frames``, so that
    the fg decision of random weights varies over the pixels (computed with
    the reference model)."""
    import torch

    model = ref.Model(cfg).to(device)
    model.load_state_dict(state)
    icfg = cfg["input"]
    hw = ref.resize_params(frames.shape[1], frames.shape[2], icfg["min_dim"], icfg["max_dim"])
    with torch.no_grad():
        raw = torch.from_numpy(frames[:icfg["num_frames"]]).to(device)
        feats = model.backbone(ref.preprocess(raw, hw, icfg))
        clip = [f.permute(1, 0, 2, 3)[None] for f in feats[::-1]]
        trunk = model.semseg_head.trunk(clip)
        mu = trunk.mean(dim=(0, 2, 3, 4)).double()
    w = state["semseg_head.conv_out.weight"]
    d = (w[-1, :, 0, 0, 0] - (w[0, :, 0, 0, 0] if w.shape[0] == 2 else 0.0)).double()
    w[-1, :, 0, 0, 0] -= ((d @ mu) / (mu @ mu) * mu).float()
    del model, feats, clip, trunk


def run(workload: str, conf: Dict, traffic: Dict, seed: int, seconds: float, trace: bool,
        t0: float, device: str = "cuda", dtype=None) -> Dict:
    """One run of an inference cell (``dtype``: the model's compute dtype,
    None for the configuration's float32); returns its outcome (see
    ``common.outcome``)."""
    import torch

    from stemseg_tpu_torch.config import load_config
    from stemseg_tpu_torch.inference import output_utils
    from stemseg_tpu_torch.inference.main import TrackGenerator
    from stemseg_tpu_torch.models import build_model

    dev = torch.device(device)
    common.set_numerics()
    cfg_dict = conf[traffic["config_role"]]
    cfg = load_config(cfg_dict)
    dataset = traffic["dataset"]
    max_tracks = getattr(cfg.data, TRACKS[dataset]).max_inference_tracks
    overlap = getattr(cfg.data, TRACKS[dataset]).inference_frame_overlap
    seqs, warm = traffic["sequences"], traffic["warmup"]

    # inputs and weights from the seed
    common.log(f"imports {time.perf_counter() - t0:.3f} s")
    warm_frames = make_frames(warm, seed, -len(warm), dev)
    frames = make_frames(seqs, seed, 0, dev)
    with torch.device("meta"):
        shapes = ref.Model(cfg_dict)
    state = common.random_weights(shapes, common.seed32(seed), dev)
    if cfg_dict["model"]["use_semseg_head"]:
        centre_fg_logit(state, cfg_dict, warm_frames[0], dev)
    host_state = {k: v.detach().to("cpu", copy=True) for k, v in state.items()}
    model = build_model(cfg, device=dev, dtype=dtype)
    model.load_state_dict(state)
    del state, shapes

    common.log(f"frames, weights, model {time.perf_counter() - t0:.3f} s")
    out_root = tempfile.mkdtemp(prefix="bench-infer-")
    clock = common.Clock()

    def writer(sub):
        cls = getattr(output_utils, WRITERS[dataset])
        kw = {"sequence_order": [s[0] for s in seqs]} if dataset == "ytvis" else {}
        return TimedWriter(cls(os.path.join(out_root, sub), device=dev, **kw), clock)

    tg = TrackGenerator(cfg, dataset, model, writer("warmup"), max_tracks)
    for (sid, n, h, w), f in zip(warm, warm_frames):
        tg._process_loaded(Seq(sid, n, (h, w)), f, (h, w), max_tracks)
    tg.output_generator = window_writer = writer("window")
    del warm_frames
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_reserved(dev)
        common.log(f"after warm-up: reserved {torch.cuda.memory_reserved(dev) / common.GIB:.3f}"
                   f" GiB, peak reserved {setup_peak / common.GIB:.3f}, peak allocated "
                   f"{torch.cuda.max_memory_allocated(dev) / common.GIB:.3f}")
        torch.cuda.reset_peak_memory_stats(dev)
    clock.spans.clear()

    # the window
    prof = common.start_profiler() if trace else None
    done: List[Dict] = []
    t_start = time.perf_counter()
    with torch.profiler.record_function("bench.window_start"):
        pass
    i = 0
    while True:
        sid, n, h, w = seqs[i % len(seqs)]
        f = frames[i % len(seqs)]
        if i >= len(seqs):  # a second pass hands the port mirrored frames
            sid, f = f"{sid}~{i // len(seqs)}", np.ascontiguousarray(f[:, ::-1])
        writer_s, captures = clock.total("writer"), getattr(tg.fused, "captures", 0)
        clock.span("sequence", tg._process_loaded, Seq(sid, n, (h, w)), f, (h, w), max_tracks)
        common.log(f"sequence {i} {sid}: {n} frames, {clock.spans[-1][2] - clock.spans[-1][1]:.4f}"
                   f" s, writer {clock.total('writer') - writer_s:.4f} s, graphs captured "
                   f"{getattr(tg.fused, 'captures', 0) - captures}")
        done.append({"id": sid, "n": n, "hw": (h, w), "index": i})
        i += 1
        if time.perf_counter() - t_start >= seconds:
            break
    if dataset == "ytvis":
        window_writer.save()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_end = time.perf_counter()
    with torch.profiler.record_function("bench.window_end"):
        pass
    window_s = t_end - t_start
    n_frames = sum(d["n"] for d in done)
    reduced = None
    common.log(f"window {window_s:.3f} s, {len(done)} sequences, {n_frames} frames; set-up "
               f"{t_start - t0:.3f} s")
    if prof is not None:
        prof.stop()
        t_red = time.perf_counter()
        reduced = common.reduce_trace(prof)
        common.log(f"trace: {len(reduced['device'])} device events, busy {reduced['busy_s']:.3f}"
                   f" of {reduced['window_s']:.3f} s, read in {time.perf_counter() - t_red:.3f} s")
        del prof
    peak_reserved = torch.cuda.max_memory_reserved(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        common.log(f"window: peak reserved {peak_reserved / common.GIB:.3f} GiB, peak allocated "
                   f"{torch.cuda.max_memory_allocated(dev) / common.GIB:.3f}")
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1,
                   "memory_peak_bytes": max(setup_peak, peak_reserved) if dev.type == "cuda" else 0}
    metrics = {"frames_per_s": n_frames / window_s, "setup_s": t_start - t0,
               "peak_reserved_gib": peak_reserved / common.GIB}

    ctx = None
    if trace:
        device_info.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
        ctx = layer_context(cfg_dict, done, clock, reduced, window_s, n_frames, overlap)

    # the program's state goes before the reference runs
    del tg, model, window_writer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks, missing = compare(cfg_dict, traffic, done, frames, host_state, out_root, seed,
                              overlap, max_tracks, dev, dataset)
    common.log(f"reference {time.perf_counter() - t_ref:.3f} s")
    return common.outcome(len(done), missing, metrics, device_info, checks, ctx, reduced)


def layer_context(cfg_dict, done, clock, reduced, window_s, n_frames, overlap):
    """What the per-layer readers of an inference cell read."""
    from .. import counts

    icfg = cfg_dict["input"]
    t = icfg["num_frames"]
    e = cfg_dict["model"]["embeddings"]["embedding_size"]
    k = cfg_dict["clustering"]["max_instances"]
    flops, cluster_bytes = 0, []
    by_size = {}
    for d in done:
        h, w = ref.resize_params(*d["hw"], icfg["min_dim"], icfg["max_dim"])
        padded = (ref.pad32(h), ref.pad32(w))
        if padded not in by_size:
            by_size[padded] = counts.inference_flops(cfg_dict, padded)
        per_frame, per_window = by_size[padded]
        n_win = len(ref.windows_of(d["n"], t, overlap))
        flops += d["n"] * per_frame + n_win * per_window
        points = t * (padded[0] // 4) * (padded[1] // 4)
        cluster_bytes += [counts.cluster_bytes(points, e, k)] * n_win
    return {"kind": "infer", "window_s": window_s, "frames": n_frames, "clock": clock,
            "trace": reduced, "flops": flops, "cluster_bytes": cluster_bytes,
            "power": common.card_power_limit()}


def sample(done: List[Dict], n: int, seed: int) -> List[Dict]:
    """``n`` completed sequences drawn from the seed, the longest among
    them (its first run)."""
    longest = max(done, key=lambda d: (d["n"], -d["index"]))
    rest = [d for d in done if d is not longest]
    return [longest] + random.Random(seed).sample(rest, min(n - 1, len(rest)))


def matched_mismatch(a: np.ndarray, b: np.ndarray, same_class=None) -> int:
    """Pixels of two uint8 index volumes (0 = no track) that disagree after
    the one-to-one matching of ``a``'s ids to ``b``'s that maximises
    agreement; with ``same_class(i, j)``, a pair of different classes agrees
    nowhere."""
    from scipy.optimize import linear_sum_assignment

    overlap = np.bincount(a.ravel().astype(np.int64) * 256 + b.ravel(),
                          minlength=256 * 256).reshape(256, 256)
    overlap[0, 1:] = overlap[1:, 0] = 0  # no track matches only no track
    if same_class is not None:
        for i, j in zip(*np.nonzero(overlap)):
            if i and j and not same_class(int(i), int(j)):
                overlap[i, j] = 0
    rows, cols = linear_sum_assignment(-overlap)
    return int(a.size - overlap[rows, cols].sum())


def read_davis(out_dir: str, seq_id: str, n: int) -> np.ndarray:
    from PIL import Image

    return np.stack([np.asarray(Image.open(os.path.join(out_dir, "results", seq_id,
                                                        f"{t:05d}.png"))) for t in range(n)])


def rle_decode(rle: Dict) -> np.ndarray:
    """A COCO compressed RLE dict -> ``[H, W]`` bool (pycocotools' format)."""
    h, w = rle["size"]
    s, counts, i = rle["counts"].encode(), [], 0
    while i < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    vals = np.zeros(len(counts), bool)
    vals[1::2] = True
    flat = np.repeat(vals, counts)
    if flat.size != h * w:
        raise ValueError(f"an RLE of {flat.size} pixels for {h}x{w}")
    return flat.reshape(w, h).T


def compare(cfg_dict, traffic, done, frames, host_state, out_root, seed, overlap,
            max_tracks, dev, dataset):
    """The reference over a sample of the window's sequences against what
    the writer wrote for them: the share of pixels whose track (and on
    YT-VIS the track's class) disagrees after matching the tracks. Returns
    ([(name, value, limit)], number of sequences whose output is missing)."""
    import torch

    check = traffic["check"]
    model = ref.Model(cfg_dict).to(dev)
    model.load_state_dict({k: v.to(dev) for k, v in host_state.items()})
    out_dir = os.path.join(out_root, "window")
    written = None
    if dataset == "ytvis":
        with open(os.path.join(out_dir, "results.json")) as fh:
            written = json.load(fh)
    bad = total = missing = 0
    for d in sample(done, check["sequences"], seed):
        f = frames[d["index"] % len(frames)]
        if d["index"] >= len(frames):
            f = np.ascontiguousarray(f[:, ::-1])
        res = ref.infer_sequence(model, cfg_dict, f, overlap, semseg_logits=True)
        if dataset == "davis":
            want = ref.davis_index_maps(res.labels, d["hw"], cfg_dict, max_tracks, dev)
            try:
                got = read_davis(out_dir, d["id"], d["n"])
            except FileNotFoundError:
                missing += 1
                continue
            bad += matched_mismatch(got, want)
        else:
            want_vol, want = ref.ytvis_instances(res.labels, res.multiclass, d["hw"], cfg_dict,
                                                 max_tracks, dev)
            got = [x for x in written if x["video_id"] == d["id"]]
            if not got and want:
                missing += 1
                continue
            got_vol = np.zeros_like(want_vol)
            for j, x in enumerate(got):
                for t, r in enumerate(x["segmentations"]):
                    got_vol[t][rle_decode(r)] = j + 1
            got_cls = {j + 1: x["category_id"] for j, x in enumerate(got)}
            want_cls = {j + 1: x["category_id"] for j, x in enumerate(want)}
            bad += matched_mismatch(got_vol, want_vol,
                                    lambda i, j: got_cls[i] == want_cls[j])
        total += d["n"] * d["hw"][0] * d["hw"][1]
        del res
    del model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return [("label_mismatch", bad / max(total, 1), check["limits"]["label_mismatch"])], missing
