"""The fused sequence path: a whole sequence's inference with no host sync
between the upload of its frames and the one fetch of its results.

The streaming path (``engine.infer_sequence`` + ``chainer.OnlineChainer``)
keeps its window schedule and the Hungarian association on the host, so
the host waits for the device inside every sequence. Here everything after
the upload runs on the device, in the order the JAX package's fused graph
(``stemseg_tpu/inference/fused_pipeline.py``) runs it:

* prelude: backbone + FPN of window 0's T frames into the feature rings;
* pass A over the windows: backbone + FPN of the window's new frames into
  the rings, the heads on the window's T ring rows, the semseg logits (or
  the seediness) added into per-frame accumulators, and the window's
  embeddings, bandwidths and seediness kept (float32);
* the fg and multiclass masks from the accumulated means
  (``engine.derive_masks``);
* pass B over the windows: (4x upscale and) clustering into the window's
  block of raw ids; the intersections of the committed global labels and
  the new raw labels on the overlap frames; IoU (float32) and the masked
  Hungarian assignment (``lsap.lsa_masked``: a CUDA kernel on the card);
  the window's labels rewritten to their matched global ids, the raw ->
  global ``lut`` updated and the window's new frames committed.

Schedule: ``_Schedule`` turns the window list into index arrays (ring rows,
accumulator blocks, committed rows, candidate bands), uploaded once per run.
Ring rows are assigned statically (``frame % 2T``, rows ``p < T - 1``
mirrored at ``p + 2T``), so a window's T rows are one contiguous run.

On a CUDA device the prelude, pass A with ``n`` new frames and pass B with
a band of ``b`` rows each run eagerly the first time a host thread calls
them, on the pipeline's capture stream, and are captured into a
``torch.cuda.CUDAGraph`` that thread's next time; from then on the host
replays them, once per real window, with the window's index in a device
scalar.
Padded windows are simply not replayed. The masks and the final cast run
once a sequence, eagerly. The pipeline keeps one device state: the buffers
of the runs with the same input and frame sizes, T, K, compute dtype,
semseg output type and fg threshold, sized for the longest sequence seen
so far, and their graphs. A sequence of another key, or longer than the
buffers, replaces the state and warms and captures its bodies anew;
sequences of one dataset (one frame size) share one state whatever their
lengths. Every state of a pipeline captures into the pipeline's one graph
memory pool, which outlives its states: a replacement synchronises the
device, resets the old state's graphs and drops the state, and the blocks
those graphs' captures used stay in the pool for the next state's
captures, so a run that changes frame size at every sequence holds one
state's graph memory, not one a state. A failed capture or replay raises.
On the CPU the same bodies run eagerly, with the plain versions of the
kernels.

Parity: the labels equal the streaming path's bit for bit (the same raw id
blocks; the fold is ``chainer.fold_and_associate``'s: intersection counts
per global id equal the summed per-raw counts because the committed chunks'
pixel sets are disjoint, the look-back band holds every root an overlap
frame can carry, and ``lsa_masked`` replicates scipy's tie-breaking). The
one representational difference is the IoU: float32 here, float64 on the
host path; the two can disagree only where two assignments' total costs
differ by less than float32's epsilon. Sequences shorter than T (a window
with repeated frames) take the streaming path in the caller.

Tracing (``utils.profiling``, while a profiler records): a run is the span
``fused.run`` (its id the pipeline's run number) around ``fused.new_state``
(when it makes a state), ``fused.load``, ``fused.prelude``, one
``fused.scan_a`` a window, ``fused.derive``, one ``fused.scan_b`` a window
(these four also timed on the stream), ``fused.fetch`` and
``fused.track_stats``; the counters ``fused.captures`` and
``fused.replays`` count the graphs captured and replayed. The spans wrap
the calls that capture or replay a body, never the body.

Data parallel (``run_batch``, the inference CLI's ``--data_parallel``): one
sequence per device, each through a pipeline of its own (a replica of the
model, its own engine, device state and capture stream on that device),
each driven from its own host thread; the JAX package's padding of a batch
to one compile bucket is an XLA matter and has no counterpart.
"""

from __future__ import annotations

import contextlib
import copy
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from stemseg_tpu_torch.inference.chainer import _intersection_counts, track_stats
from stemseg_tpu_torch.inference.clustering import ClusterParams, cluster_window
from stemseg_tpu_torch.inference.engine import InferenceEngine, derive_masks, upscale_window
from stemseg_tpu_torch.inference.lsap import lsa_masked
from stemseg_tpu_torch.ops import launches
from stemseg_tpu_torch.utils.profiling import count, span

# index arrays of a schedule, packed into one int64 buffer on the device
_SCHEDULE_KEYS = ("new_ids", "write_rows", "write_rows2", "win_start", "prelude_rows",
                  "prelude_mirror", "scatter_start", "commit_tgt", "win_frames", "overlap_msk",
                  "label_base", "cand_base")


class _Schedule:
    """Per-sequence schedule arrays (numpy), the same for every sequence with
    the same window list."""

    def __init__(self, windows: List[List[int]], k: int, l_cap: int, w_cap: int):
        """:param l_cap, w_cap: frames and windows the device buffers hold
            (``l_cap`` is also the committed volume's trash row)"""
        w_real = len(windows)
        t_win = len(windows[0])
        # mirrored ring: period 2T plus T - 1 mirror rows plus a trash row.
        # A window's frames are contiguous (asserted below), so its rows are
        # a circular run [s, s + T) mod 2T; mirroring rows p < T - 1 at
        # p + 2T makes it a plain run [s, s + T) over 3T - 1 rows
        ring = 2 * t_win
        self.ring_rows = 3 * t_win          # 2T + (T - 1) mirrors + 1 trash
        self.trash_row = 3 * t_win - 1
        self.t_win = t_win
        self.w_real = w_real
        self.k = k

        for win in windows:
            assert list(win) == list(range(win[0], win[0] + t_win)), \
                f"fused path requires contiguous windows, got {win}"

        def mirror_row(t: int) -> int:
            p = t % ring
            return p + ring if p <= t_win - 2 else self.trash_row

        # per-window new frames (frames not seen in any earlier window)
        seen: set = set()
        new_per_win: List[List[int]] = []
        for win in windows:
            new = [t for t in win if t not in seen]
            seen.update(new)
            new_per_win.append(new)
        assert new_per_win[0] == list(windows[0]), "window 0 must be all-new"

        # pass A's new frames per window; window 0's come from the prelude.
        # Rows are padded to T, the most a window can bring, so that the
        # layout depends on (w_cap, T) alone
        self.n_new = [0] + [len(n) for n in new_per_win[1:]]
        s = t_win

        def pad_list(lst, n, fill):
            return list(lst) + [fill] * (n - len(lst))

        new_ids = []      # [W, T] frames to read (0 past n_new)
        write_rows = []   # [W, T] primary ring row (trash past n_new)
        write_rows2 = []  # [W, T] mirror ring row (trash when p > T - 2)
        win_start = []    # [W] first ring row of the window's T rows
        scatter_start = []  # [W] first frame of the window's accumulator block
        commit_tgt = []   # [W, T] committed-volume row (l_cap = trash)
        win_frames = []   # [W, T] frame ids
        overlap_msk = []  # [W, T] 1 where the frame is shared with the previous window

        prev = None
        # look-back band: windows whose raw ids can appear on overlap frames
        self.lookback = 1
        for i in range(w_cap):
            if i < w_real:
                win = windows[i]
                new = new_per_win[i] if i > 0 else []
                win_frames.append(list(win))
                win_start.append(win[0] % ring)
                new_ids.append(pad_list(new, s, 0))
                write_rows.append(pad_list([t % ring for t in new], s, self.trash_row))
                write_rows2.append(pad_list([mirror_row(t) for t in new], s, self.trash_row))
                scatter_start.append(win[0])
                commit_tgt.append([t if t in new_per_win[i] else l_cap for t in win])
                if i == 0:
                    overlap_msk.append([0] * t_win)
                else:
                    prev_set = set(prev)
                    overlap_msk.append([1 if t in prev_set else 0 for t in win])
                    # the committing window of each overlap frame bounds the look-back
                    for t in win:
                        if t in prev_set:
                            self.lookback = max(self.lookback, i - committed_by[t])
                if i == 0:
                    committed_by = {t: 0 for t in win}
                else:
                    for t in new_per_win[i]:
                        committed_by[t] = i
                prev = win
            else:  # padded window: the host never runs it
                win_frames.append([0] * t_win)
                win_start.append(0)
                new_ids.append([0] * s)
                write_rows.append([self.trash_row] * s)
                write_rows2.append([self.trash_row] * s)
                scatter_start.append(0)
                commit_tgt.append([l_cap] * t_win)
                overlap_msk.append([0] * t_win)

        i64 = np.int64
        self.n_new += [0] * (w_cap - w_real)
        self.new_ids = np.asarray(new_ids, i64)
        self.write_rows = np.asarray(write_rows, i64)
        self.write_rows2 = np.asarray(write_rows2, i64)
        self.win_start = np.asarray(win_start, i64)
        # the prelude's (window 0's) rows, [T]
        self.prelude_rows = np.asarray([t % ring for t in windows[0]], i64)
        self.prelude_mirror = np.asarray([mirror_row(t) for t in windows[0]], i64)
        self.scatter_start = np.asarray(scatter_start, i64)
        self.commit_tgt = np.asarray(commit_tgt, i64)
        self.win_frames = np.asarray(win_frames, i64)
        self.overlap_msk = np.asarray(overlap_msk, i64)
        self.label_base = np.asarray([1 + i * k for i in range(w_cap)], i64)
        # candidate band start per window (ids below it never on overlap frames)
        self.cand_base = np.asarray([1 + (i - self.lookback) * k for i in range(w_cap)], i64)
        self._packed: Dict[bool, torch.Tensor] = {}

    def layout(self) -> Dict[str, Tuple[int, Tuple[int, ...]]]:
        """Offset and shape of each index array in ``packed``."""
        out, offset = {}, 0
        for name in _SCHEDULE_KEYS:
            arr = getattr(self, name)
            out[name] = (offset, arr.shape)
            offset += arr.size
        return out

    def packed(self, pinned: bool) -> torch.Tensor:
        """The index arrays in one int64 host tensor (page-locked for a
        non-blocking upload when ``pinned``), made once."""
        t = self._packed.get(pinned)
        if t is None:
            t = torch.from_numpy(np.concatenate([getattr(self, n).ravel()
                                                 for n in _SCHEDULE_KEYS]))
            t = t.pin_memory() if pinned else t
            self._packed[pinned] = t
        return t


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _semseg_scatter(acc: torch.Tensor, cnt: torch.Tensor, start: torch.Tensor,
                    wmap: torch.Tensor, t_iota: torch.Tensor) -> None:
    """Adds one window's map into the per-frame accumulators in place: the
    window's frames are the contiguous block at ``start`` (one addition per
    element, as the streaming engine's per-frame sums)."""
    blk = start + t_iota
    acc.index_copy_(0, blk, acc.index_select(0, blk) + wmap)
    cnt.index_copy_(0, blk, cnt.index_select(0, blk) + 1.0)


def _remap_ids(labels: torch.Tensor, base: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Rewrites the ids ``base + r`` (r < len(dst)) of ``labels`` to
    ``dst[r]``; other values stay."""
    k = dst.shape[0]
    rel = labels - base
    inside = (rel >= 0) & (rel < k)
    return torch.where(inside, dst[rel.clamp(0, k - 1).long()], labels)


def _intersection_block(existing, labels, ov, cand1, cand2):
    """Overlap-frame intersection counts between the committed ids ``cand1``
    and the new raw ids ``cand2`` (``chainer._intersection_counts`` on the
    frames where ``ov``)."""
    a = torch.where(ov, existing, -7)
    b = torch.where(ov, labels, -7)
    return _intersection_counts(a, b, cand1, cand2)


class _State:
    """The device state of the runs of one key (input and frame sizes, T,
    K, compute dtype, semseg output type, fg threshold): the uploaded frames
    and schedule, the rings, accumulators, per-window outputs, fg masks,
    committed volume and ``lut``, sized for ``l_cap`` frames and ``w_cap``
    windows, and the CUDA graph of each per-window body."""

    def __init__(self, pipe: "FusedSequencePipeline", key, frame_shape, resize_hw,
                 l_cap: int, w_cap: int, t_win: int, semseg_output_type: str,
                 threshold: float):
        dev = pipe.engine.device
        # the pipeline owns its state: a strong reference back would make a
        # cycle, and a dropped pipeline would keep its state (device buffers,
        # graphs and their pool) until the cyclic GC ran
        self.pipe = weakref.proxy(pipe)
        self.key = key
        self.resize_hw = tuple(resize_hw)
        self.l_cap, self.w_cap, self.t_win = l_cap, w_cap, t_win
        self.ring_rows = 3 * t_win
        self.semseg_output_type = semseg_output_type
        self.threshold = threshold
        self.frames = torch.zeros((l_cap,) + tuple(frame_shape), dtype=torch.uint8, device=dev)
        self.sched = self.views = None
        self.win_idx = torch.zeros(1, dtype=torch.int64, device=dev)
        k = pipe.cluster_params.max_instances
        self.t_iota = torch.arange(t_win, device=dev)
        self.k_iota = torch.arange(k, dtype=torch.int32, device=dev)
        self.band_iotas: Dict[int, torch.Tensor] = {}
        self.n_lut = w_cap * k + 2  # slot n_lut - 1 is never an id: the band's trash
        # made by the bodies' first (eager) run, so never inside a capture
        self.rings = self.acc = self.cnt = self.embs = self.bws = self.seeds = None
        self.fg = self.committed = self.lut = self.lut0 = None
        self.graphs: Dict[object, torch.cuda.CUDAGraph] = {}
        self.launches: Dict[object, list] = {}  # the kernels each graph launches
        self.warm: set = set()

    # -- loading ------------------------------------------------------------

    def load(self, frames, sched: _Schedule, l_pad: int) -> None:
        """Frames and schedule onto the device, without a host sync (page-
        locked host copies, non-blocking)."""
        cuda = self.frames.is_cuda
        if self.sched is None:
            layout = sched.layout()
            self.sched = torch.zeros(sum(int(np.prod(s)) for _, s in layout.values()),
                                     dtype=torch.int64, device=self.frames.device)
            self.views = {name: self.sched[o:o + int(np.prod(s))].view(s)
                          for name, (o, s) in layout.items()}
        if torch.is_tensor(frames):
            if frames.shape[0] != l_pad:
                raise ValueError(f"device frames must be pre-padded to {l_pad} frames")
            self.frames[:l_pad].copy_(frames, non_blocking=True)
        else:
            # the padded frames are never read: padded windows never run
            n = min(frames.shape[0], l_pad)
            src = torch.from_numpy(np.ascontiguousarray(frames[:n]))
            self.frames[:n].copy_(src.pin_memory() if cuda else src, non_blocking=cuda)
        self.sched.copy_(sched.packed(pinned=cuda), non_blocking=cuda)

    # -- the bodies -----------------------------------------------------------

    def _window(self, name: str) -> torch.Tensor:
        return self.views[name].index_select(0, self.win_idx)[0]

    def _prelude(self) -> None:
        eng = self.pipe.engine
        v = self.views
        frames = self.frames.index_select(0, v["win_frames"][0])
        feats = eng.model.backbone_features(eng.preprocess(frames, self.resize_hw))
        if self.rings is None:
            self.rings = [torch.zeros((self.ring_rows,) + f.shape[1:], dtype=f.dtype,
                                      device=f.device) for f in feats]
        rows = torch.cat([v["prelude_rows"], v["prelude_mirror"]])
        for ring, f in zip(self.rings, feats):
            ring.index_copy_(0, rows, torch.cat([f, f]))
        # buffers of an earlier run start over
        if self.acc is not None:
            self.acc.zero_()
            self.cnt.zero_()
        if self.committed is not None:
            self.committed.fill_(-1)
            self.lut.copy_(self.lut0)

    def _scan_a(self, n_new: int) -> None:
        eng = self.pipe.engine
        if n_new:
            new = self._window("new_ids")[:n_new]
            feats = eng.model.backbone_features(
                eng.preprocess(self.frames.index_select(0, new), self.resize_hw))
            rows = torch.cat([self._window("write_rows")[:n_new],
                              self._window("write_rows2")[:n_new]])
            for ring, f in zip(self.rings, feats):
                ring.index_copy_(0, rows, torch.cat([f, f]))
        win_rows = self.views["win_start"].index_select(0, self.win_idx) + self.t_iota
        emb, bw, seed, semseg = eng.heads([ring.index_select(0, win_rows) for ring in self.rings])
        # clustering and averaging in float32 whatever the compute dtype
        wmap = (semseg if semseg is not None else seed).float()
        if self.embs is None:
            dev = emb.device
            self.embs = torch.zeros((self.w_cap,) + emb.shape, dtype=torch.float32, device=dev)
            self.bws = torch.zeros((self.w_cap,) + bw.shape, dtype=torch.float32, device=dev)
            self.seeds = torch.zeros((self.w_cap,) + seed.shape, dtype=torch.float32, device=dev)
            # + T trash rows: the block of a padded window
            self.acc = torch.zeros((self.l_cap,) + wmap.shape[1:], dtype=torch.float32,
                                   device=dev)
            self.cnt = torch.zeros(self.l_cap, dtype=torch.float32, device=dev)
        self.embs.index_copy_(0, self.win_idx, emb.float()[None])
        self.bws.index_copy_(0, self.win_idx, bw.float()[None])
        self.seeds.index_copy_(0, self.win_idx, seed.float()[None])
        _semseg_scatter(self.acc, self.cnt, self.views["scatter_start"].index_select(
            0, self.win_idx), wmap, self.t_iota)

    def derive(self, n: int) -> Optional[torch.Tensor]:
        """The fg masks of the first ``n`` frames into the fg buffer (pass B
        reads it); returns the multiclass masks (or None). Eager: once a
        sequence, with the sequence's padded length."""
        eng = self.pipe.engine
        mean = self.acc[:n] / self.cnt[:n].clamp(min=1.0).view((n,) + (1,) * (self.acc.dim() - 1))
        fg, mc = derive_masks(mean, has_semseg=eng.model.semseg_head is not None,
                              semseg_output_type=self.semseg_output_type,
                              seediness_fg_threshold=self.threshold)
        if self.fg is None:
            self.fg = torch.zeros((self.l_cap,) + fg.shape[1:], dtype=fg.dtype, device=fg.device)
        self.fg[:n].copy_(fg)
        return mc

    def _scan_b(self, band: int) -> None:
        pipe = self.pipe
        k = pipe.cluster_params.max_instances
        emb = self.embs.index_select(0, self.win_idx)[0]
        bw = self.bws.index_select(0, self.win_idx)[0]
        seed = self.seeds.index_select(0, self.win_idx)[0]
        if pipe.cluster_full_scale:
            emb, bw = upscale_window(emb), upscale_window(bw)
            seed = upscale_window(seed[..., None])[..., 0]
        frames = self._window("win_frames")
        base = self._window("label_base").to(torch.int32)
        labels = cluster_window(emb, bw, seed, self.fg.index_select(0, frames),
                                pipe.cluster_params, base).labels
        if self.committed is None:
            self.committed = torch.full((self.l_cap + 1,) + labels.shape[1:], -1,
                                        dtype=torch.int32, device=labels.device)
            # raw id -> global root; slot 0 is where out-of-band candidates clip
            self.lut0 = torch.arange(self.n_lut, dtype=torch.int32, device=labels.device)
            self.lut = self.lut0.clone()
        if band not in self.band_iotas:
            self.band_iotas[band] = torch.arange(band, device=labels.device)

        # fold: the candidate globals are the lut roots of the band's raw ids.
        # The band is rounded up, so at small K the last window's can reach
        # past the last id: those rows read the trash slot (a root no frame
        # carries, masked out below by n1 = 0)
        raws = (self._window("cand_base") + self.band_iotas[band]).clamp(0, self.n_lut - 1)
        roots = torch.sort(self.lut.index_select(0, raws)).values
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=roots.device),
                           roots[1:] != roots[:-1]])
        existing = self.committed.index_select(0, frames)
        ov = (self._window("overlap_msk") > 0).view(-1, 1, 1)
        cand2 = base + self.k_iota
        inter, n1, n2 = _intersection_block(existing, labels, ov, roots, cand2)

        # associate: masked Hungarian with scipy's tie-breaking
        row_valid = first & (roots > 0) & (n1 > 0)
        col_valid = n2 > 0
        union = n1[:, None] + n2[None, :] - inter
        iou = torch.where(union > 0, inter / union.clamp(min=1.0), 0.0)
        _, r4c = lsa_masked(1.0 - iou, row_valid, col_valid)

        # each new cluster's global id: its matched root, else itself
        dst = torch.where(r4c >= 0, roots[r4c.clamp(min=0).long()], cand2)
        labels = _remap_ids(labels, base, dst)
        self.lut.index_copy_(0, cand2.long(), dst)
        self.committed.index_copy_(0, self._window("commit_tgt"), labels)

    # -- running ----------------------------------------------------------------

    def call(self, name, window: Optional[int] = None) -> None:
        """Runs one per-window body, ``"prelude"``, ``("scan_a", n_new)`` or
        ``("scan_b", band)`` (``window`` is its window index): eagerly on
        the CPU; on a CUDA device eagerly on the capture stream the first
        time on a host thread (a warm-up), captured that thread's next time,
        replayed from then on."""
        if window is not None:
            self.win_idx.fill_(window)
        body = {"prelude": self._prelude,
                "scan_a": lambda: self._scan_a(name[1]),
                "scan_b": lambda: self._scan_b(name[1])}[name if name == "prelude" else name[0]]
        if not self.frames.is_cuda:
            body()
            return
        graph = self.graphs.get(name)
        stream = self.pipe.stream
        # captured only on a host thread that ran it eagerly before: a
        # thread's first cuDNN call can create its handle, which allocates
        # device memory and so cannot be captured (``run_batch`` runs each
        # call on new threads)
        warm_key = (name, threading.get_ident())
        if graph is None and warm_key in self.warm:
            # capture_begin / capture_end on the capture stream, not
            # torch.cuda.graph: that synchronises and empties the caching
            # allocators (device and page-locked host) at every capture
            graph = torch.cuda.CUDAGraph()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream), launches.captured() as launched:
                graph.capture_begin(self.pipe.graph_pool, capture_error_mode="thread_local")
                try:
                    body()
                except BaseException:
                    with contextlib.suppress(RuntimeError):  # the body's error is the one
                        graph.capture_end()
                    raise
                graph.capture_end()
            self.graphs[name] = graph
            self.launches[name] = launched
            self.pipe.captures += 1
            count("fused.captures")
        if graph is not None:
            graph.replay()
            launches.replayed(self.launches[name])
            count("fused.replays")
            return
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            body()
        torch.cuda.current_stream().wait_stream(stream)
        self.warm.add(warm_key)

    def release_graphs(self) -> None:
        """Resets every graph of this state (the device must have finished
        their replays): the blocks their captures used stay in the
        pipeline's pool, free for the next captures into it."""
        for graph in self.graphs.values():
            graph.reset()
        self.graphs.clear()
        self.launches.clear()


def _graph_pool(stream: torch.cuda.Stream):
    """A CUDA graph memory pool for every state of one pipeline, and what
    keeps it open: the caching allocators (the device one and the page-
    locked host one) refuse a capture into a pool whose graphs are all gone
    (``use_count > 0``), so a graph of one fill of a scalar stays captured
    into the pool for the pipeline's lifetime. Returns (pool, keeper)."""
    pool = torch.cuda.graph_pool_handle()
    scalar = torch.zeros(1, device=stream.device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(stream.device):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            graph.capture_begin(pool, capture_error_mode="thread_local")
            scalar.zero_()
            graph.capture_end()
    return pool, (graph, scalar)


def _fetch(tensors: List[torch.Tensor]) -> List[np.ndarray]:
    """Host copies of ``tensors``: on a CUDA device one non-blocking copy
    each into page-locked memory, then one wait for the stream."""
    if not tensors[0].is_cuda:
        return [t.clone().numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [h.numpy() for h in host]


class FusedSequencePipeline:
    """Runs whole sequences through the fused path (see the module
    docstring).

    :param engine: ``InferenceEngine`` (its model, preprocessing and heads)
    :param cluster_params: ``ClusterParams``
    :param cluster_full_scale: 4x-upscale the embeddings before clustering
        (``--resize_embeddings``); the engine must upscale the semseg logits
        4x too (``semseg_resize_scale=4``)
    """

    LOOKBACK_PAD = 8  # candidate band padded to a multiple

    def __init__(self, engine: InferenceEngine, cluster_params: ClusterParams,
                 cluster_full_scale: bool = False):
        if cluster_full_scale and engine.model.semseg_head is None:
            raise ValueError("full-scale clustering requires the semseg head's fg masks")
        self.engine = engine
        self.cluster_params = cluster_params
        self.cluster_full_scale = cluster_full_scale
        self._schedule_cache: Dict = {}
        self._state: Optional[_State] = None
        self.states_made = 0  # device states made, graphs captured and runs, so far
        self.captures = 0
        self.runs = 0
        self.stream: Optional[torch.cuda.Stream] = None
        self.graph_pool = self._pool_keeper = None  # every state's graphs capture into it
        self._replicas: Dict[Tuple[int, torch.device], "FusedSequencePipeline"] = {}
        if engine.device.type == "cuda":
            from stemseg_tpu_torch.ops.cluster import prepare_records

            self.stream = torch.cuda.Stream(engine.device)
            prepare_records(self.stream)
            self.graph_pool, self._pool_keeper = _graph_pool(self.stream)

    def _band(self, lookback: int) -> int:
        """Candidate-band width, rounded up to 2 look-back windows, so that a
        tail window that overlaps one window further back keeps the band's
        graph. The extra rows are zero (a committed id at or above a
        window's own block never appears before its commit) and are masked
        out of the Hungarian (``row_valid``), as the host fold drops them."""
        k = self.cluster_params.max_instances
        return _round_up(k * lookback, max(self.LOOKBACK_PAD, 2 * k))

    def _schedule(self, windows: List[List[int]], k: int, l_cap: int,
                  w_cap: int) -> _Schedule:
        """Memoised ``_Schedule``: a pure function of (windows, k, l_cap,
        w_cap), so every sequence of the same length reuses one."""
        key = (tuple(tuple(w) for w in windows), k, l_cap, w_cap)
        sched = self._schedule_cache.get(key)
        if sched is None:
            sched = _Schedule(windows, k, l_cap, w_cap)
            self._schedule_cache[key] = sched
        return sched

    def _state_for(self, key, l_pad: int, w_pad: int, make) -> _State:
        """The device state for a run of ``key`` with ``l_pad`` frames and
        ``w_pad`` windows: the current one if its key matches and its
        buffers are large enough, else a new one (``make(l_cap, w_cap)``),
        grown to the longer of the two sequences when the key matches."""
        old = self._state
        if old is not None and old.key == key and old.l_cap >= l_pad and old.w_cap >= w_pad:
            return old
        with span("fused.new_state"):
            l_cap, w_cap = l_pad, w_pad
            if old is not None:
                if old.key == key:
                    l_cap, w_cap = max(l_cap, old.l_cap), max(w_cap, old.w_cap)
                if self.engine.device.type == "cuda":  # replays may still read its buffers
                    torch.cuda.synchronize(self.engine.device)
                old.release_graphs()
                self._state = old = None
            self._state = make(l_cap, w_cap)
        self.states_made += 1
        return self._state

    @torch.no_grad()
    def run(self, frames, windows: List[List[int]], seediness_fg_threshold: float = 0.25,
            semseg_output_type: str = "probs", resize_hw: Optional[Tuple[int, int]] = None,
            device_outputs: bool = False, fetch_multiclass: bool = True):
        """One sequence through the fused path.

        :param frames: uint8 ``[T_total, H0, W0, 3]`` raw BGR frames (numpy),
            or a uint8 tensor on the device already padded to the sequence's
            padded length (``round_up(T_total, 16)`` frames)
        :param windows: schedule from ``get_subsequence_frames``, without
            repeated frames (sequences of at least T frames)
        :param resize_hw: network input dims before the /32 padding (None:
            the frames' own)
        :param device_outputs: skip the fetch; return device tensors
            (labels in the transport dtype, int16 when the ids fit, and the
            masks, padded to the padded length) with counts and lifetimes
            None
        :param fetch_multiclass: False leaves the multiclass masks on the
            device (the DAVIS writer ignores them; the other writers take
            device tensors)
        :return: (labels ``[T, h_c, w_c]`` int32 numpy, counts, lifetimes,
            fg masks numpy, multiclass masks: numpy, a device tensor or None)
        """
        # the true length comes from the schedule: device frames arrive padded
        t_total = max(max(w) for w in windows) + 1
        if frames.shape[0] < t_total:
            raise ValueError(f"{frames.shape[0]} frames for a schedule of {t_total}")
        if not all(len(set(w)) == len(w) for w in windows):
            raise ValueError("the fused path takes windows without repeated frames "
                             "(sequences of at least T frames)")
        if frames.dtype != (torch.uint8 if torch.is_tensor(frames) else np.uint8):
            raise TypeError("the fused path takes raw uint8 frames")

        k = self.cluster_params.max_instances
        t_win = len(windows[0])
        l_pad = _round_up(t_total, 16)
        w_pad = _round_up(len(windows), 4)
        frame_shape = tuple(frames.shape[1:])
        resize_hw = tuple(resize_hw) if resize_hw is not None else frame_shape[:2]
        key = (resize_hw, frame_shape, t_win, k, self.engine.model.compute_dtype,
               semseg_output_type, seediness_fg_threshold)
        cuda = self.engine.device.type == "cuda"
        self.runs += 1
        with span("fused.run", ident=self.runs):
            state = self._state_for(key, l_pad, w_pad, lambda l_cap, w_cap: _State(
                self, key, frame_shape, resize_hw, l_cap, w_cap, t_win, semseg_output_type,
                seediness_fg_threshold))
            sched = self._schedule(windows, k, state.l_cap, state.w_cap)
            band = self._band(sched.lookback)

            with span("fused.load"):
                state.load(frames, sched, l_pad)
            with span("fused.prelude", device=cuda):
                state.call("prelude")
            for i in range(sched.w_real):
                with span("fused.scan_a", device=cuda):
                    state.call(("scan_a", sched.n_new[i]), i)
            with span("fused.derive", device=cuda):
                mc = state.derive(l_pad)
            for i in range(sched.w_real):
                with span("fused.scan_b", device=cuda):
                    state.call(("scan_b", band), i)
            # int16 transport whenever the ids fit (halves the label fetch)
            labels = state.committed[:l_pad].to(
                torch.int16 if w_pad * k + 1 < 2 ** 15 else torch.int32, copy=True)
            fg = state.fg[:l_pad]

            if device_outputs:
                return labels, None, None, fg.clone(), mc
            fetch = [labels, fg]
            want_mc = fetch_multiclass and mc is not None
            if want_mc:
                fetch.append(mc)
            kept_mc = mc[:t_total] if mc is not None and not want_mc else None
            with span("fused.fetch"):
                fetched = _fetch(fetch)
                labels = fetched[0][:t_total].astype(np.int32)
            fg = fetched[1][:t_total]
            multiclass = fetched[2][:t_total] if want_mc else kept_mc
            with span("fused.track_stats"):
                counts, lifetimes = track_stats(labels)
            return labels, counts, lifetimes, fg, multiclass

    def replica(self, slot: int, device) -> "FusedSequencePipeline":
        """The pipeline of ``run_batch``'s slot ``slot`` on ``device``: this one
        for slot 0 on its own device, else (made once, then kept) one over a
        copy of the model on ``device``, with its own engine, device state
        and capture stream."""
        device = torch.device(device)
        if slot == 0 and device == self.engine.device:
            return self
        key = (slot, device)
        pipe = self._replicas.get(key)
        if pipe is None:
            eng = self.engine
            model = copy.deepcopy(eng.model).to(device)
            pipe = FusedSequencePipeline(
                InferenceEngine(eng.cfg, model, semseg_resize_scale=eng.semseg_resize_scale),
                self.cluster_params, cluster_full_scale=self.cluster_full_scale)
            self._replicas[key] = pipe
        return pipe

    def run_batch(self, frames_batch: Sequence, windows_batch: Sequence[List[List[int]]],
                  devices: Sequence, **kwargs) -> List[tuple]:
        """Data-parallel inference: sequence ``i`` runs on ``devices[i]``
        through slot ``i``'s pipeline (``replica``), each driven from its own
        host thread; a device may appear more than once.

        :param frames_batch: per-sequence raw uint8 frames, as ``run`` takes
        :param windows_batch: per-sequence window schedules
        :param devices: one device per sequence
        :param kwargs: ``run``'s options, the same for every sequence
        :return: ``run``'s result per sequence, in input order; a
            sequence's failure is raised
        """
        if not len(frames_batch) == len(windows_batch) == len(devices):
            raise ValueError(f"{len(frames_batch)} sequences, {len(windows_batch)} schedules "
                             f"and {len(devices)} devices")
        pipes = [self.replica(i, d) for i, d in enumerate(devices)]

        def one(pipe, frames, windows):
            dev = pipe.engine.device
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                return pipe.run(frames, windows, **kwargs)

        with ThreadPoolExecutor(max_workers=len(pipes)) as pool:
            futures = [pool.submit(one, pipe, f, w)
                       for pipe, f, w in zip(pipes, frames_batch, windows_batch)]
            return [f.result() for f in futures]
