"""Inference CLI: ``python -m stemseg_tpu_torch.inference.main CKPT -o DIR
--dataset {davis,ytvis,kittimots} [--resize_embeddings] [--bf16]
[--profile_clustering] [--profile DIR] [--save_vis] [--data_parallel]
[--device cuda]``.

Per sequence: frame loading (the next sequence's frames are read while
the current one runs) -> inference -> the dataset's writer (DAVIS PNGs,
YT-VIS ``results.json``, KITTI-MOTS txt), with the reference's fps report
(model, clustering + postprocessing, overall). A sequence of at least
``num_frames`` frames takes the fused path (``fused_pipeline``: backbone,
heads, clustering and the cross-window association on the device, one
fetch at the end, its launches replayed from CUDA graphs), and its whole
run is logged under the "inference" timer, so only the overall fps
compares with the streaming path; a shorter sequence, and every sequence
under ``--profile_clustering``, takes the streaming path (sliding-window
engine, then per-window clustering + cross-window chaining with the
association on the host). Frame I/O and output writing stay out of the
timers; each timed phase ends in a device synchronise, so the report holds
device time. After the last sequence the writer's ``save()`` runs (the
YT-VIS json and zip, the KITTI-MOTS NMS).

``--resize_embeddings`` (or a config trained with ``loss_at_full_res``)
clusters at the network input scale: each window's semseg logits, and the
embeddings, bandwidths and seediness handed to the clustering, are
upscaled 4x trilinearly first.

``--bf16`` runs the model in bfloat16 with float32 parameters; the frames
are preprocessed, the windows averaged and clustered in float32.
``--profile_clustering`` times each window's clustering between two device
synchronisations and reports the durations by point count (on the
streaming path, which it forces);
``--profile DIR`` writes a ``torch.profiler`` chrome trace of the whole run
to ``DIR/trace.json``; ``--save_vis`` has the DAVIS writer also write each
frame with its tracks overlaid (``vis/<seq>/<t>.jpg``; the other writers
take the flag and write none, as in the JAX package).

``--data_parallel`` serves one sequence per device over every visible CUDA
device (``torch.cuda.device_count()``; with ``--device cpu``,
``CPU_DATA_PARALLEL`` replicas on the CPU): the sequences of at least
``num_frames`` frames are grouped by raw frame size and run in chunks of
the device count through ``FusedSequencePipeline.run_batch``, each chunk's
whole run under the "inference" timer; the shorter ones take the streaming
path after them. The writers run on the main thread, in that order.

Config resolution: ``config.yaml`` beside the checkpoint if present, else
the dataset's preset (``davis_2``, ``youtube_vis``, ``kitti_mots_2``); CLI
overrides for the input dims and the minimum seediness. Weights load from a
JAX package ``.ckpt`` (flax msgpack, its weights only) or a ``.pth``: a
reference state dict, or a checkpoint of the port's trainer (its
``"model"`` entry), so either trainer's model dir (checkpoints beside its
``config.yaml``) is read as it is.
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from stemseg_tpu_torch.config import Config, load_config, load_preset, merge
from stemseg_tpu_torch.utils.device import synchronize
from stemseg_tpu_torch.utils.timer import Timer

DATASET_PRESETS = {"davis": "davis_2", "ytvis": "youtube_vis", "kittimots": "kitti_mots_2"}
FRAME_READERS = 4  # threads reading JPEGs
CPU_DATA_PARALLEL = 2  # --data_parallel's replicas with --device cpu


def load_inference_cfg(model_path: str, dataset: str, min_dim: Optional[int],
                       max_dim: Optional[int],
                       min_seediness_prob: Optional[float]) -> Config:
    cfg_file = os.path.join(os.path.dirname(model_path), "config.yaml")
    if os.path.exists(cfg_file):
        print(f"Loading config from {cfg_file}")
        cfg = load_config(cfg_file)
    else:
        if dataset not in DATASET_PRESETS:
            raise ValueError(f"Invalid dataset {dataset!r}; expected one of "
                             f"{sorted(DATASET_PRESETS)}")
        print(f"Loading default preset {DATASET_PRESETS[dataset]}")
        cfg = load_preset(DATASET_PRESETS[dataset])

    # input-dim overrides keep the aspect limit ratio
    if min_dim or max_dim:
        ratio = cfg.input.max_dim / cfg.input.min_dim
        if min_dim and max_dim:
            new_min, new_max = min_dim, max_dim
        elif min_dim:
            new_min, new_max = min_dim, int(round(min_dim * ratio))
        else:
            new_min, new_max = int(round(max_dim / ratio)), max_dim
        cfg = merge(cfg, {"input": {"min_dim": new_min, "max_dim": new_max}})
        print(f"Network input image dimension limits: {new_min}, {new_max}")

    if min_seediness_prob:
        cfg = merge(cfg, {"clustering": {"min_seediness_prob": min_seediness_prob}})
    return cfg


def load_model(cfg: Config, model_path: str, device="cuda",
               dtype: Optional[torch.dtype] = None):
    """Build the model on ``device``, computing in ``dtype`` (None: float32),
    and load a JAX package ``.ckpt``, a reference ``.pth`` or a checkpoint of
    the port's trainer."""
    from stemseg_tpu_torch.models import build_model, load_state_dict_file

    if not model_path.endswith((".pth", ".ckpt")):
        raise ValueError(f"{model_path}: expected a .pth or a JAX package .ckpt")
    model = build_model(cfg, device=device, dtype=dtype)
    model.load_state_dict(load_state_dict_file(model_path))
    return model


class TrackGenerator:
    """Per-sequence orchestration over the fused path, or the streaming
    engine and the online chainer."""

    def __init__(self, cfg: Config, dataset: str, model, output_generator,
                 max_tracks: int, seediness_thresh: float = 0.25,
                 frame_overlap: int = -1, resize_embeddings: bool = False,
                 profile_clustering: bool = False, use_fused: bool = True,
                 devices: Optional[Sequence] = None):
        """:param model: an ``STEmSegModel`` on its device; its compute dtype
            is the run's
        :param profile_clustering: keep a ``ClusterTimeLog`` of the windows'
            clustering (a device synchronisation before and after each); the
            fused path has no window boundary to time, so this forces the
            streaming path
        :param use_fused: run sequences of at least ``num_frames`` frames
            through ``FusedSequencePipeline``
        :param devices: serve those sequences data parallel, one per device
            (``FusedSequencePipeline.run_batch``); needs the fused path"""
        from stemseg_tpu_torch.inference.chainer import OnlineChainer
        from stemseg_tpu_torch.inference.clustering import (
            ClusterParams,
            ClusterTimeLog,
            cluster_window,
        )
        from stemseg_tpu_torch.inference.engine import InferenceEngine, upscale_window
        from stemseg_tpu_torch.models.embedding_utils import get_nb_free_dims

        overlaps = {"davis": cfg.data.davis.inference_frame_overlap,
                    "ytvis": cfg.data.youtube_vis.inference_frame_overlap,
                    "kittimots": cfg.data.kitti_mots.inference_frame_overlap}
        if dataset not in overlaps:
            raise ValueError(f"Invalid dataset {dataset!r}; expected one of {sorted(overlaps)}")
        self.cluster_full_scale = cfg.training.loss_at_full_res or resize_embeddings
        if self.cluster_full_scale and not cfg.model.use_semseg_head:
            raise ValueError("full-scale clustering takes its fg masks from the semseg "
                             "head; this config has none")
        self.cfg = cfg
        self.dataset = dataset
        self.output_generator = output_generator
        self.max_tracks = max_tracks
        self.seediness_thresh = seediness_thresh
        self.frame_overlap = frame_overlap if frame_overlap > 0 else overlaps[dataset]
        self.semseg_output_type = {"kittimots": "argmax", "ytvis": "logits"}.get(
            dataset, "probs")
        self.engine = InferenceEngine(
            cfg, model, semseg_resize_scale=4.0 if self.cluster_full_scale else 1.0)
        self.device = self.engine.device

        ccfg = cfg.clustering
        self.cluster_params = ClusterParams(
            primary_prob_thresh=ccfg.primary_prob_threshold,
            secondary_prob_thresh=ccfg.secondary_prob_threshold,
            min_seediness_prob=ccfg.min_seediness_prob,
            max_instances=ccfg.max_instances,
            n_free_dims=get_nb_free_dims(cfg.model.embedding_dim_mode),
            free_dim_stds=tuple(cfg.training.losses.embedding.free_dim_stds),
            secondary_assignment=ccfg.secondary_assignment)
        self.cluster_time_log = ClusterTimeLog() if profile_clustering else None

        def cluster_fn(emb, bw, seed, fg_mask, label_start):
            if self.cluster_full_scale:
                emb, bw = upscale_window(emb), upscale_window(bw)
                seed = upscale_window(seed[..., None])[..., 0]
            return cluster_window(emb, bw, seed, fg_mask, self.cluster_params,
                                  label_start, time_log=self.cluster_time_log)

        self.chainer = OnlineChainer(cluster_fn, max_instances=ccfg.max_instances)
        self.fused = None
        if use_fused and not profile_clustering:
            from stemseg_tpu_torch.inference.fused_pipeline import FusedSequencePipeline

            self.fused = FusedSequencePipeline(self.engine, self.cluster_params,
                                               cluster_full_scale=self.cluster_full_scale)
        if devices is not None and self.fused is None:
            raise ValueError("data-parallel serving runs the fused path, which "
                             "--profile_clustering (or use_fused=False) turns off")
        self.devices = list(devices) if devices is not None else None
        self.total_frames_processed = 0

    def _read_frames(self, sequence):
        """Raw uint8 BGR frames, read by a thread pool over cv2 (``start``
        reads the next sequence's on its prefetch thread, outside the
        timers)."""
        import cv2

        def read(path):
            im = cv2.imread(path, cv2.IMREAD_COLOR)
            if im is None:
                raise ValueError(f"No image found at path: {path}")
            return im

        with ThreadPoolExecutor(max_workers=FRAME_READERS) as pool:
            images = list(pool.map(read, sequence.frame_paths()))
        return np.stack(images), images[0].shape[:2]

    def _schedule(self, n_frames: int, image_hw):
        """(window schedule, network input dims before the /32 padding)."""
        from stemseg_tpu_torch.inference.windows import get_subsequence_frames
        from stemseg_tpu_torch.structures.geometry import compute_resize_params

        h0, w0 = image_hw
        new_w, new_h, _ = compute_resize_params(
            (w0, h0), self.cfg.input.min_dim, self.cfg.input.max_dim)
        windows = get_subsequence_frames(n_frames, self.cfg.input.num_frames,
                                         self.frame_overlap)
        return windows, (new_h, new_w)

    @Timer.log_duration("inference")
    def do_inference(self, frames: np.ndarray, image_hw):
        windows, resize_hw = self._schedule(frames.shape[0], image_hw)
        out = self.engine.infer_sequence(
            frames, windows, resize_hw=resize_hw,
            seediness_fg_threshold=self.seediness_thresh,
            semseg_output_type=self.semseg_output_type)
        synchronize(self.device)
        return out

    @Timer.log_duration("inference")
    def do_fused(self, frames: np.ndarray, image_hw):
        """The fused path: the whole run (clustering and association
        included) under the "inference" timer. The multiclass masks stay on
        the device for the writer."""
        windows, resize_hw = self._schedule(frames.shape[0], image_hw)
        return self.fused.run(frames, windows, seediness_fg_threshold=self.seediness_thresh,
                              semseg_output_type=self.semseg_output_type,
                              resize_hw=resize_hw, fetch_multiclass=False)

    @Timer.log_duration("inference")
    def do_fused_batch(self, frames_list: List[np.ndarray], image_hw):
        """A chunk of sequences of one frame size through ``run_batch``, one
        per device: the whole run under the "inference" timer, as
        ``do_fused``."""
        schedules = [self._schedule(f.shape[0], image_hw) for f in frames_list]
        return self.fused.run_batch(
            frames_list, [windows for windows, _ in schedules], self.devices[:len(frames_list)],
            seediness_fg_threshold=self.seediness_thresh,
            semseg_output_type=self.semseg_output_type, resize_hw=schedules[0][1],
            fetch_multiclass=False)

    @Timer.log_duration("postprocessing")
    def do_clustering(self, out):
        with torch.no_grad():
            result = self.chainer.process(out["fg_masks"], out["windows"])
        synchronize(self.device)
        return result

    def _process_loaded(self, sequence, frames: np.ndarray, image_hw, max_tracks: int):
        """One sequence of raw uint8 ``[T, H, W, 3]`` BGR frames through the
        fused path (at least ``num_frames`` frames) or the engine and the
        chainer, then the writer (with the multiclass masks on the device,
        or None). Returns (labels, counts, lifetimes, per-window
        ClusterResults of the streaming path or None for the fused one)."""
        if self.fused is not None and frames.shape[0] >= self.cfg.input.num_frames:
            labels, counts, lifetimes, _, multiclass = self.do_fused(frames, image_hw)
            result = (labels, counts, lifetimes, None)
        else:
            out = self.do_inference(frames, image_hw)
            result = self.do_clustering(out)
            labels, counts, lifetimes, _ = result
            multiclass = out["multiclass_masks"]
        self._write(sequence, labels, counts, lifetimes, multiclass, len(frames), max_tracks)
        return result

    def _write(self, sequence, labels, counts, lifetimes, multiclass, n_frames: int,
               max_tracks: int):
        self.output_generator.process_sequence(
            sequence, labels, counts, lifetimes, multiclass, mask_scale=4,
            max_tracks=max_tracks, min_dim=self.cfg.input.min_dim,
            max_dim=self.cfg.input.max_dim)
        self.total_frames_processed += n_frames

    def _start_data_parallel(self, todo) -> None:
        """Sequences of at least ``num_frames`` frames grouped by raw frame
        size, in chunks of the device count, through ``do_fused_batch``; the
        shorter ones after them, one by one on the streaming path."""
        groups: Dict[tuple, list] = {}
        shorts = []
        for s in todo:
            if len(s) >= self.cfg.input.num_frames:
                groups.setdefault(tuple(s.image_dims), []).append(s)
            else:
                shorts.append(s)
        n_dev, done = len(self.devices), 0
        for seqs in groups.values():
            for i in range(0, len(seqs), n_dev):
                chunk = seqs[i:i + n_dev]
                loaded = [self._read_frames(s) for s in chunk]
                print(f"Performing inference for sequences {done + 1}-{done + len(chunk)}/"
                      f"{len(todo)} ({len(chunk)}-way data parallel)")
                results = self.do_fused_batch([f for f, _ in loaded], loaded[0][1])
                for seq, (frames, _), (labels, counts, lifetimes, _, mc) in zip(
                        chunk, loaded, results):
                    self._write(seq, labels, counts, lifetimes, mc, len(frames),
                                self.max_tracks)
                done += len(chunk)
        for i, s in enumerate(shorts):
            print(f"Performing inference for sequence {done + i + 1}/{len(todo)} "
                  "(short, per-sequence)")
            frames, image_hw = self._read_frames(s)
            self._process_loaded(s, frames, image_hw, self.max_tracks)

    def start(self, sequences, seqs_to_process: Optional[List[str]] = None):
        todo = [s for s in sequences
                if not seqs_to_process or str(s.id) in seqs_to_process]
        if self.devices is not None:
            self._start_data_parallel(todo)
            self.print_fps_report()
            return
        # one thread reads the next sequence's frames while this one runs
        with ThreadPoolExecutor(max_workers=1) as prefetcher:
            pending = prefetcher.submit(self._read_frames, todo[0]) if todo else None
            for i, sequence in enumerate(todo):
                print(f"Performing inference for sequence {i + 1}/{len(todo)}")
                frames, image_hw = pending.result()
                if i + 1 < len(todo):
                    pending = prefetcher.submit(self._read_frames, todo[i + 1])
                self._process_loaded(sequence, frames, image_hw, self.max_tracks)
        self.print_fps_report()

    def fps_report(self) -> List[str]:
        inf = max(Timer.get_duration("inference"), 1e-9)
        post = max(Timer.get_duration("postprocessing"), 1e-9)
        n = self.total_frames_processed
        lines = [f"Model inference speed: {n / inf:.3f} fps",
                 f"Clustering and postprocessing speed: {n / post:.3f} fps",
                 f"Overall speed: {n / max(Timer.get_durations_sum(), 1e-9):.3f} fps"]
        if self.cluster_time_log is not None:
            lines.append("Clustering durations by point count (points: calls, mean ms):")
            for pts, (calls, mean_s) in self.cluster_time_log.summary().items():
                lines.append(f"  {pts:>9d}: {calls:4d} calls, {mean_s * 1e3:8.2f} ms")
            lines.append(f"  average: {self.cluster_time_log.average_time * 1e3:.2f} ms")
        return lines

    def print_fps_report(self):
        print("----------------------------------------------------")
        for line in self.fps_report():
            print(line)
        print("----------------------------------------------------")


def main(argv=None):
    parser = argparse.ArgumentParser(description="STEm-Seg inference (PyTorch / CUDA)")
    parser.add_argument("model_path")
    parser.add_argument("--output_dir", "-o", required=False)
    parser.add_argument("--seqs", nargs="*", required=False)
    parser.add_argument("--dataset", "-d", required=True, choices=list(DATASET_PRESETS))
    parser.add_argument("--max_tracks", type=int, required=False)
    parser.add_argument("--frame_overlap", "-fo", type=int, default=-1)
    parser.add_argument("--seediness_thresh", "-st", type=float, default=0.25)
    parser.add_argument("--min_dim", type=int, required=False)
    parser.add_argument("--max_dim", type=int, required=False)
    parser.add_argument("--resize_embeddings", action="store_true",
                        help="cluster at the network input scale (4x trilinear "
                             "upscale of each window's maps)")
    parser.add_argument("--min_seediness_prob", "-msp", type=float, required=False)
    parser.add_argument("--save_vis", action="store_true",
                        help="DAVIS: also write each frame with its tracks overlaid")
    parser.add_argument("--bf16", action="store_true",
                        help="run the model forward in bfloat16 (params stay "
                             "fp32; clustering/averaging stay fp32)")
    parser.add_argument("--profile_clustering", action="store_true",
                        help="log per-window clustering durations bucketed by point "
                             "count (a device synchronisation per window)")
    parser.add_argument("--profile", metavar="DIR", required=False,
                        help="write a torch.profiler chrome trace of the whole run "
                             "to DIR/trace.json")
    parser.add_argument("--data_parallel", action="store_true",
                        help="serve one sequence per device over every visible CUDA "
                             "device (fused path, run_batch); sequences are grouped "
                             "by raw frame size")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' runs the plain versions of "
                             "the kernels")
    args = parser.parse_args(argv)

    from stemseg_tpu_torch.data.parsers import parse_generic_video_dataset
    from stemseg_tpu_torch.data.paths import (
        DavisUnsupervisedPaths,
        KITTIMOTSPaths,
        YoutubeVISPaths,
    )
    from stemseg_tpu_torch.inference.output_utils import (
        DavisOutputGenerator,
        KittiMOTSOutputGenerator,
        YoutubeVISOutputGenerator,
    )
    from stemseg_tpu_torch.utils.profiling import start_trace, write_trace

    cfg = load_inference_cfg(args.model_path, args.dataset, args.min_dim,
                             args.max_dim, args.min_seediness_prob)
    output_dir = args.output_dir or os.path.join(
        os.path.dirname(args.model_path), "inference")
    if not os.path.isabs(output_dir):
        output_dir = os.path.join(os.path.dirname(args.model_path), output_dir)
    os.makedirs(output_dir, exist_ok=True)

    writer_kw = dict(upscaled_inputs=cfg.training.loss_at_full_res or args.resize_embeddings,
                     save_visualization=args.save_vis, device=args.device)
    if args.dataset == "davis":
        sequences, _ = parse_generic_video_dataset(
            DavisUnsupervisedPaths.trainval_base_dir(), DavisUnsupervisedPaths.val_vds_file())
        output_generator = DavisOutputGenerator(output_dir, **writer_kw)
        max_tracks = cfg.data.davis.max_inference_tracks
    elif args.dataset == "ytvis":
        sequences, _ = parse_generic_video_dataset(
            YoutubeVISPaths.val_base_dir(), YoutubeVISPaths.val_vds_file())
        output_generator = YoutubeVISOutputGenerator(output_dir, **writer_kw)
        max_tracks = cfg.data.youtube_vis.max_inference_tracks
    else:
        sequences, _ = parse_generic_video_dataset(
            KITTIMOTSPaths.train_images_dir(), KITTIMOTSPaths.val_vds_file())
        output_generator = KittiMOTSOutputGenerator(output_dir, **writer_kw)
        max_tracks = cfg.data.kitti_mots.max_inference_tracks

    model = load_model(cfg, args.model_path, device=args.device,
                       dtype=torch.bfloat16 if args.bf16 else None)
    devices = None
    if args.data_parallel:
        devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                   if next(model.parameters()).is_cuda else ["cpu"] * CPU_DATA_PARALLEL)
    generator = TrackGenerator(cfg, args.dataset, model, output_generator,
                               args.max_tracks or max_tracks,
                               seediness_thresh=args.seediness_thresh,
                               frame_overlap=args.frame_overlap,
                               resize_embeddings=args.resize_embeddings,
                               profile_clustering=args.profile_clustering,
                               devices=devices)
    profiler = start_trace(generator.device) if args.profile else None
    try:
        generator.start(sequences, args.seqs)
    finally:
        if profiler is not None:
            write_trace(profiler, args.profile, generator.device)
    output_generator.save()
    print(f"Results saved to {output_dir}")


if __name__ == "__main__":
    main()
