#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``stemseg_tpu_torch``) on one CUDA GPU,
and (``--four-cards``) its data parallelism on four.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, each of
which raises on failure (the script then exits non-zero):

1. device: name, power limit (nvidia-smi) and the TF32 flags;
2. build: ``nvcc`` builds the CUDA sources of the checkout;
3. kernels: ``cluster_points_single`` and ``cluster_points_tiled`` at
   207,360 and 878,592 points with E = 4, and at path D's 487,424 points
   with E = 3 and no free dims (the tiled one also at path C's 368,640, at
   train -> infer's 439,296, at 3,500,000 and at path C′'s 5,898,240
   points, the last two beyond its on-chip state) against their plain
   PyTorch version on the same mixture-of-Gaussians inputs, both secondary
   modes and one case that exhausts K: labels exact except knife-edge
   points (plain ``exp(-0.5 d)`` within 1e-6 of a threshold, at most
   0.01 %), meta equal; edge cases exact; the single kernel refuses
   3,500,000 points. At the main-path shapes (single 207,360, tiled
   878,592, 487,424 at E = 3 and 5,898,240, and single at 878,592 for the
   crossover): CUDA-event time, the profiler's device time and kernel list
   (one clustering kernel per call, nothing else), host time per call,
   cold-L2 time, executed iterations, plain time and bound; at the first
   two also the sync floor (the kernels' exchanges alone). The wrapper's
   on-chip capacity must equal the CUDA library's for every E;
4. main path A: the ``davis_2`` preset at full width (R-101-FPN, 16-frame
   windows, 704x1248 network input) on a 26-frame 480x854 sequence through
   ``TrackGenerator._process_loaded`` into the DAVIS writer; every window
   must go through ``cluster_points_tiled``;
5. main path B: ``davis_1`` at 480x854 (8-frame windows, 207,360 points a
   window) on 16 frames; every window through ``cluster_points_single``;
6. small input: the slice on the GPU against the slice on the CPU (plain
   versions, CPU convolutions) on the same weights and frames, for a
   DAVIS-shaped and a YT-VIS-shaped (semseg head, fused seediness) config;
7. steady state: main path A once more, timed only; the device time of
   each of its layers; and one profiled run (device busy share);
8. main path C: ``youtube_vis`` (8-frame windows, semseg head of 41 + 1
   channels, logits) on 20 frames of 720x1280, 640x1152 padded: 4 windows
   of 368,640 points, each through ``cluster_points_tiled``; the writer's
   ``results.json`` (at most 10 instances, every mask 720x1280, classes
   1..40) and ``results.zip``;
9. main path D: ``kitti_mots_2`` (``xyt``, E = 3, argmax semseg) on 16
   frames of 375x1242, 544x1792 padded: 3 windows of 487,424 points through
   ``cluster_points_tiled``; every line of ``results/0002.txt`` (class 1 or
   2, id / 1000 = class, mask 375x1242) and the NMS's ``results_nms/``;
10. main path C′: ``youtube_vis`` with ``--resize_embeddings`` on 8 frames:
   one window clustered at the network input scale, 5,898,240 points with
   the tiled kernel's state off chip;
11. training path T: ``davis_1`` with ``training.mode: synthetic`` at full
   width (R-101-FPN, heads (256, 256, 128, 128), 8-frame clips of
   736x1248, E = 4, separate seediness head, 16 instance slots,
   ``batch_size`` 2 = two micro-steps an update) through the port's
   ``Trainer``: 4 optimizer steps with checkpoints every 2, then a new
   ``Trainer`` that resumes (step count, weights and optimizer state equal
   to what was saved) and takes 2 more; every loss finite, every trainable
   tensor changed, the frozen stem and ``layer1`` unchanged. Then train ->
   infer: the last ``.pth`` and its ``config.yaml`` through the inference
   CLI's loaders and ``TrackGenerator`` on path B's frames, every window
   through the clustering kernel its dispatch picks, the PNGs checked, the
   kernel's output on the first window held against the plain version.
   Timings: seconds per optimizer step in the trainer and for the step
   alone, clips per second, the copy of a pinned micro-batch to the card, a
   micro-step split by CUDA events, peak device memory, the loader's wait
   per batch and a profiled device-busy share;
12. training path T′: ``youtube_vis`` synthetic at full width (semseg head
   of (256, 256, 256, 256) with 41 + 1 logits, fused seediness, 640x1196
   clips padded to 640x1216): 2 optimizer steps, cross entropy and fg BCE
   finite, every semseg-head tensor changed;
13. one micro-step on the GPU against the CPU at the tests' small size
   (DAVIS- and YT-VIS-shaped): loss terms within 1e-4 relative, gradients
   within a per-leaf relative L2 of 1e-3, TF32 off;
14. training path R: the six training datasets written to a temporary
   directory in their own layouts and frame sizes
   (``write_training_datasets``: textured JPEG frames, the project JSON
   with RLE masks) and the dataset environment variables set; each
   loader's host ms per clip (median of 5, one process); each mode's
   loader rate through 4 workers;
   ``create_training_dataset`` at ``davis_1``'s 50,000 steps; then
   ``davis_1`` in its own ``davis`` mode (COCO + YT-VIS + DAVIS + VOC) at
   path T's full width through the ``Trainer``: 4 optimizer steps, every
   loss finite, every trainable tensor changed and no frozen one,
   checkpoints at 2 and 4, clips from at least two of the datasets; step
   intervals with each step's padded clip shapes, loader waits, peak
   memory, the H2D copy of a micro-batch. Train -> infer: the checkpoint
   through the inference CLI (``main``, ``--dataset davis``) on the
   written ``davis_val.json``, every window through the clustering kernel
   its dispatch picks, the PNGs checked, the first window's kernel output
   held against the plain version;
15. training paths R′ (``youtube_vis`` in its own mode: COCO + VOC +
   YT-VIS, 41 classes; 4 steps, since VOC's 0.1 of 4 clips rounds to 0)
   and R″ (``kitti_mots_2``: KITTI-MOTS, 544x1792, 30 instance slots, the
   category-3 ignore masks; 2 steps), with phase 14's checks and numbers;
16. bf16 inference at full width: paths A and C in float32 and then with
   the model built as ``--bf16`` builds it (bfloat16 compute, the same
   float32 weights) through ``TrackGenerator`` into their writers, every
   window through ``cluster_points_tiled``, the writers' files checked, the
   first bf16 window's kernel output held against the plain version; the
   fg-mask and label agreement of bf16 with float32 (labels also with the
   track ids matched one to one), peak memory, steady fps, the bf16 layer
   split and a profiled bf16 run; path A also steady in float32 with TF32
   on (set after the engine and the writer are built, off again after), with
   its layer split;
17. training path T with ``training.mixed_precision`` (bf16) for 4 steps:
   every loss finite, every trainable tensor changed and float32, the
   frozen ones unchanged; step time, micro-step split, profile, peak
   memory, the first step's losses against float32 path T's (same seed and
   batches); train -> infer with the model in bf16, the first window held
   against the plain version;
18. the rest of the inference CLI: path T's last checkpoint written as a
   JAX trainer's ``.ckpt`` (this script's msgpack encoder and the inverse
   of ``state_dict_from_jax``, checked to map back to the same tensors)
   through ``main`` with ``--profile_clustering --save_vis --profile`` on
   phase 14's ``davis_val.json``, and the ``.pth`` through ``main``: equal
   labels, every window through the kernel the dispatch picks, the
   clustering report's bucket, a JPEG a frame, a chrome trace with device
   kernels.

19. the fused path: ``lsa_masked`` (the lsap kernel) against its plain
   version and scipy on a fuzz set (heavy ties, random masks, tall, wide
   and empty sides, sides up to 64), its device µs a call at the
   association's 40x20 beside scipy's host µs; one CUDA graph holding both
   clustering kernels replayed 4 times with new inputs (a window that stops
   after one iteration, then one of 20 active iterations, twice), each
   replay held against the plain version; then paths A, C, D, C′ and A in
   bf16 through ``TrackGenerator`` on the fused path and on the streaming
   path with the same model and frames: labels bit-identical, fg and
   multiclass masks equal, writer files byte-equal, a fused run from the
   upload to the dispatch's end under ``set_sync_debug_mode("error")``,
   steady overall fps in turns (streaming, fused, fused, streaming), and a
   profiled run of each (device busy share; the graph-replayed kernels'
   launches); last, one pass over DAVIS
   2017 val's 30 sequence lengths (1,999 frames of 480x854, each sequence
   once, ``davis_2`` in bf16) on each path: labels equal, overall fps, peak
   memory, the fused pipeline's device states and captures;
20. convert -> infer -> score at full width: three validation sets with
   masks written in their datasets' layouts and frame sizes
   (``write_eval_datasets``: DAVIS 2 sequences of 480x854, YT-VIS 2 of
   720x1280, KITTI-MOTS one of 375x1242 with cars, a pedestrian and an
   ignore region); their ground truth as results (DAVIS PNGs and KITTI
   txt through the port's writers, YT-VIS ``results.json``) scored by
   ``python -m stemseg_tpu_torch.eval.main``: every J, F, J&F, AP, AP50,
   AP75, sMOTSA, MOTSA and MOTSP exactly 1.0, the CLI's line equal on two
   runs; phase 18's JAX ``.ckpt`` of path T through
   ``models.convert_checkpoint``, each tensor equal to T's ``.pth``; then
   ``tools.eval_all`` on the card (``--device`` at its default) for DAVIS
   (the converted ``.pth``), YT-VIS and KITTI-MOTS (random ``youtube_vis``
   and ``kitti_mots_2`` models), each on the fused path, once profiled
   (every window's clustering kernel, the tiled one, and lsap kernel
   counted on the device) and once timed, with equal metrics and a
   ``RESULTS.md``: inference and scoring seconds, scoring ms a frame, and
   for DAVIS the scorer's (object, proposal, frame) triples, ms per
   ``db_eval_boundary`` call and the DAVIS 2017 val scoring wall it
   projects;
21. the dilated decoder trunk: an ``EmbeddingDecoder`` with
   ``trunk_type="squeeze_expand_dilated_decoder"`` at ``davis_2``'s widths
   and the plain trunk's, on one 16-frame window of path A's FPN maps:
   forward ms and peak memory in float32 and bf16; the three heads with
   the dilated trunk at the tests' small size (8 and 16 frames) on the GPU
   against the CPU: forward within 1e-3, input and parameter gradients
   within a per-leaf relative L2 of 1e-3, TF32 off;
22. data parallelism, a JAX session, a sustained run: (a) path T for 2
   optimizer steps through the trainer as ``torchrun`` starts it at world 1
   (an NCCL process group: the gradient and loss all-reduces, the global
   normalisers, the rank slices of the stream) against the plain trainer,
   with cuDNN's deterministic algorithms: weights and logged terms bitwise
   equal, or, where ops without a deterministic CUDA implementation ran and
   the weights differ, within a per-leaf relative L2 of 1e-3, said so; (b)
   two gloo ranks sharing the card (``python3 chip_smoke.py --rank-worker
   SPEC``) at ``max_samples_per_chip`` 1 against one process at 2 on the
   same global batch: loss terms within 1e-4, the first micro-step's
   gradient within 1e-3 (phase 13's bounds), each one's step time and the
   gradient all-reduce's; (c) the inference CLI's ``--data_parallel`` on
   path A's preset in bf16 over phase 20's generated DAVIS sequences,
   byte-equal to the serial CLI, and ``run_batch`` over ``cuda:0`` twice
   (two pipelines, two host threads) equal to ``run``, each with its
   clustering and lsap launches counted by the profiler; (d) phase 11's
   last checkpoint written as a whole JAX SGD session and restored by
   ``--restore_session``: weights, momentum, LR schedule and step bitwise
   equal to resuming the ``.pth``, then 2 steps each held as in (a); (e)
   ``tools.train_sustained`` on path T in bf16, 12 steps, SIGINT after
   step 6: resumed, stitched, the loss falling, steps/s and loader waits.
   (b) and (c) run first, alone; (e) runs in a subprocess beside (a) and
   (d), whose checks are numerical.
23. data parallelism on four cards, run alone by ``python3 chip_smoke.py
   --four-cards`` on a host with four cards (it exits non-zero, before it
   builds anything, where there are fewer; the default run prints a line
   saying so and runs none of it). After the build: on each card the
   clustering kernels and ``lsa_masked`` against their plain version, each
   workspace on its own card; (a) path T through the trainer CLI as users
   launch it, ``python -m torch.distributed.run --standalone
   --nproc_per_node 4 -m stemseg_tpu_torch.training.main`` (NCCL, the CLI's
   8 loader workers a rank), 4 steps: a SIGINT to rank 2 after step 2 stops
   every rank after one step, rank 0 alone saves, a relaunch resumes and
   reaches step 4, the logs stitched; (b) four ranks of ``--card-worker``
   (one a card, NCCL): the first micro-step's loss terms and gradient
   against one process on the first card at ``max_samples_per_chip`` 4 over
   the same clips (terms within 1e-4, the whole gradient within a relative
   L2 of 1e-3, the worst leaf printed) and against those clips one at a
   time (``per_clip_reference``: terms within 1e-6, every leaf within
   1e-4), every rank's weights bitwise equal to rank 0's after 2 steps and
   within 1e-3 per leaf of the one-process run's; (c) 24 steps in bf16 at
   world 4, losses finite, ranks bitwise equal; (d) the inference CLI's
   ``--data_parallel`` with ``davis_2`` in bf16 on 8 generated DAVIS
   sequences of 480x854 (the lengths of DAVIS 2017 val's first 8): the
   chunks, PNGs byte-equal to the serial CLI's, the kernels' launches on
   each card from the profiler's device index, and ``run_batch`` over the
   four cards equal to ``run``; (e) the numbers: the gradient's NCCL
   all-reduce and the small int one, s a step and clips/s at world 1 (the
   preset) and 4 in fp32 and bf16, each rank's loader waits after the
   workers' first queue, peak memory a rank, and ``--data_parallel``'s wall
   against the serial CLI's split into frame reads, fused runs and writer
   calls, beside every card's name, power limit and ``nvidia-smi topo -m``.
   Then (d) on mixed frame sizes: phase 24's model through the YT-VIS CLI
   on 4 sequences of each of its four sizes, interleaved, serial and
   ``--data_parallel`` (one chunk of 4 a size): ``results.json``
   byte-equal, and each card's ``memory_reserved()`` after every chunk at
   most its value after the first plus 1 GiB. Every part runs, and the
   phase fails after them if any failed.
24. the fused path across frame sizes: ``youtube_vis`` in float32 (random,
   fg centred) on 20-frame sequences of four raw sizes, 720x1280 and
   1080x1920 (both 640x1152 padded: the tiled kernel), 480x854 (640x1152)
   and 375x1242 (384x1216, 233,472 points a window: the single kernel),
   in three orders, each through one pipeline: (i) alternating, 3 rounds;
   (ii) the same 12 grouped by size; (iii) alternating on the streaming
   path; then (iv) a 36-frame 720x1280 sequence on (i)'s pipeline. Labels
   bit-identical, fg and multiclass masks equal to the streaming path's on
   every sequence; ``memory_reserved()`` after (i)'s 12th sequence and
   after (iv) at most its value after the 4th plus 1 GiB; states made,
   graphs captured, seconds a replacement (a new state's run minus the
   grouped pass's last run of its size), ``memory_reserved()`` and
   ``max_memory_reserved()`` after each, overall fps of each order, and
   the share of the grouped fps the replacements cost; (i) profiled on a
   fresh pipeline (device busy share; both clustering kernels and the lsap
   kernel counted from the fused graphs); both clustering kernels on S4's
   and S1's first real window against the plain version. Then the YT-VIS
   CLI on 8 sequences of the four sizes, interleaved: serial (fused),
   ``--profile_clustering`` (streaming) and ``--data_parallel``, their
   ``results.json`` byte-equal, ``memory_reserved()`` after each.

Phases 4-18 run the streaming path (``use_fused=False``), so their layer
splits stay comparable; the inference CLI in phases 14 and 18 runs its
default, the fused path (``--profile_clustering`` the streaming one),
whose launches the profiler counts; so do phase 20's eval_all runs.
Paths C, D and C′ print the fps report of their checked run and of a
second, steady run, and the device time of each layer (CUDA events). The
kernel's output on each path's first real window is held against the
plain version by the phase-3 rule; path
C also times the DAVIS preset's two heads on its window. With random
weights the fg logit of the semseg head has one sign over whole frames, so
the semseg paths first centre it (``centre_fg_logit``).

The last three lines are the kernel table as JSON, the card's name and
power limit as nvidia-smi prints them, and ``{"ok": true, "device": ...}``;
``--four-cards`` ends with phase 23's numbers as JSON, each card's
nvidia-smi line and the same last line. Without a CUDA device, or outside
a checkout, it exits non-zero and prints no result.
"""

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
KNIFE_EPS = 1e-6
MAX_KNIFE_FRACTION = 1e-4
MAIN_SEED = 0
BEYOND_ON_CHIP = 3_500_000  # over both kernels' on-chip capacity at E = 4
PATH_C_POINTS = 160 * 288 * 8  # youtube_vis window, E = 4
PATH_D_POINTS = 136 * 448 * 8  # kitti_mots_2 window, E = 3
PATH_C2_POINTS = 640 * 1152 * 8  # youtube_vis window at the network input scale
PATH_T_POINTS = 176 * 312 * 8  # davis_1 at 736/1248 on path B's frames (train -> infer)
TRAIN_WORKERS = 4  # loader worker processes of the training paths
# phase 16: a bf16 path whose fg masks disagree with float32 on more than a
# tenth of the pixels is broken, not rounded
BF16_MIN_FG_AGREEMENT = 0.9
TRAIN_DATA_SHAPES = {  # frame (height, width) of each training dataset as it ships
    "coco": (480, 640), "pascal_voc": (375, 500), "youtube_vis": (720, 1280),
    "davis": (480, 854), "kitti_mots": (375, 1242), "mapillary": (1080, 1920)}
SMALL_TRAIN = {  # phase 13: the CPU tests' size
    "input": {"num_frames": 2, "min_dim": 64, "max_dim": 96},
    "model": {"backbone": {"type": "R-50-FPN"}, "embedding_dim_mode": "xyff",
              "use_seediness_head": True, "use_semseg_head": False,
              "resnets": {"backbone_out_channels": 32, "res2_out_channels": 32,
                          "stem_out_channels": 16, "width_per_group": 8},
              "embeddings": {"embedding_size": 4, "inter_channels": [32, 32, 16, 16],
                             "gn_num_groups": 8},
              "seediness": {"inter_channels": [32, 32, 16, 16], "gn_num_groups": 8}},
    "training": {"mode": "synthetic",
                 "losses": {"embedding": {"free_dim_stds": [0.3, 0.3]}}},
}


def log(*args):
    print(*args, flush=True)


class Sequence:
    def __init__(self, seq_id, n_frames, image_dims):
        self.id = seq_id
        self.image_dims = image_dims
        self._n = n_frames

    def __len__(self):
        return self._n


def synthetic_frames(n, h, w, seed):
    """Moving discs over a gradient with pixel noise; BGR uint8."""
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([yy * 0.1 + 40, xx * 0.1 + 60, (yy + xx) * 0.05 + 80], -1)
    discs = [(rng.uniform(0.2, 0.8) * h, rng.uniform(0.2, 0.8) * w,
              rng.uniform(0.08, 0.18) * h, rng.uniform(-4, 4, 2),
              rng.randint(0, 255, 3)) for _ in range(4)]
    frames = np.empty((n, h, w, 3), np.uint8)
    for t in range(n):
        f = base.copy()
        for cy, cx, r, (vy, vx), col in discs:
            f[(yy - cy - vy * t) ** 2 + (xx - cx - vx * t) ** 2 < r * r] = col
        frames[t] = np.clip(f + rng.randn(h, w, 3) * 6, 0, 255).astype(np.uint8)
    return frames


def texture(rng, h, w):
    """Smooth colour noise with stripes and grain, BGR uint8: a JPEG of it is
    about as large, and as slow to decode, as a photograph's."""
    import cv2
    import numpy as np

    low = rng.randint(0, 256, (max(2, h // 24), max(2, w // 24), 3)).astype(np.uint8)
    img = cv2.resize(low, (w, h), interpolation=cv2.INTER_CUBIC).astype(np.float32)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    img += (20 * np.sin(xx * rng.uniform(0.05, 0.3) + yy * rng.uniform(0.05, 0.3)))[..., None]
    img += rng.randint(-12, 13, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def rle_str(mask):
    from stemseg_tpu_torch.utils import rle

    return rle.encode(mask)["counts"].decode("utf-8")


def blob(h, w, cy, cx, ry, rx):
    """A filled ellipse as an [h, w] uint8 mask."""
    import cv2
    import numpy as np

    m = np.zeros((h, w), np.uint8)
    cv2.ellipse(m, (int(round(cx)), int(round(cy))), (max(1, int(round(rx))),
                max(1, int(round(ry)))), 0, 0, 360, 1, -1)
    return m


def paint(img, mask, colour):
    img[mask > 0] = (img[mask > 0] * 0.4 + colour * 0.6).astype(img.dtype)


def write_video_set(rng, base, ann, json_name, h, w, specs, sub="", separate=False):
    """Sequences of textured JPEG frames of ``h x w`` (the camera pans 2 px a
    frame) with moving ellipses, under ``base/sub/<seq id>/``, and their
    project JSON with RLE masks as ``ann/json_name``. ``specs``: (seq id,
    frames, {iid: category}, {iid: frames without it}). With ``separate``
    each object's mask loses the pixels of the objects before it (in
    ``specs``' order), so that no pixel belongs to two. Returns the JSON's
    sequences."""
    import cv2
    import numpy as np

    sequences = []
    for seq_id, n_frames, cats, absent in specs:
        os.makedirs(os.path.join(base, sub, seq_id))
        bg = texture(rng, h, w + 2 * n_frames)  # the camera pans 2 px a frame
        objs = {iid: (rng.uniform(0.3, 0.7) * h, rng.uniform(0.25, 0.75) * w,
                      rng.uniform(0.08, 0.2) * h, rng.uniform(0.05, 0.12) * w,
                      rng.uniform(-0.004, 0.004, 2) * (h, w), rng.randint(0, 256, 3))
                for iid in cats}
        paths, segmentations = [], []
        for t in range(n_frames):
            img = np.ascontiguousarray(bg[:, 2 * t:2 * t + w])
            seg_t = {}
            taken = np.zeros((h, w), np.uint8)
            for iid, (cy, cx, ry, rx, v, col) in objs.items():
                if t not in absent.get(iid, ()):
                    m = blob(h, w, cy + v[0] * t, cx + v[1] * t, ry, rx)
                    if separate:
                        m &= 1 - taken
                        taken |= m
                    paint(img, m, col)
                    seg_t[str(iid)] = rle_str(m)
            paths.append(f"{seq_id}/{t:05d}.jpg")
            cv2.imwrite(os.path.join(base, sub, paths[-1]), img)
            segmentations.append(seg_t)
        sequences.append({"id": seq_id, "height": h, "width": w, "image_paths": paths,
                          "categories": {str(i): c for i, c in cats.items()},
                          "segmentations": segmentations})
    labels = {str(c): str(c) for s in specs for c in s[2].values()}
    with open(os.path.join(ann, json_name), "w") as fh:
        json.dump({"meta": {"category_labels": labels}, "sequences": sequences}, fh)
    return sequences


def write_training_datasets(root, seed=MAIN_SEED, shapes=None):
    """The six training datasets, each in its own on-disk layout (JPEG
    frames, the project JSON with RLE masks) at its frame size
    (``TRAIN_DATA_SHAPES``, or ``shapes``), textured frames with moving
    ellipses, from ``seed``. Returns the environment variables that point
    the loaders at them:

    * COCO: 8 images, 1-6 instances, some of categories no mode keeps;
    * Pascal VOC: 8 images, some instances under the 50-pixel minimum, the
      boundary band of the instances as the ignore RLE;
    * YouTube-VIS ``train/``: 3 sequences of 20-24 frames, 1-3 instances
      (one single-instance sequence), a frame without instances;
    * DAVIS: 3 sequences of 40-44 frames, 1-4 instances (one
      single-instance), empty frames; and ``davis_val.json``, 16 frames of
      one of them, for inference;
    * KITTI-MOTS: cars (1), pedestrians (2) and an ignore region (3), a gap
      of 7 frames with only the ignore region, and a sequence without one;
    * Mapillary: 3 images with 45 instances each, about 36 of them cars and
      persons (every 15th under the 30-pixel minimum), the rest of ignore
      categories or of categories the loader drops."""
    import cv2
    import numpy as np

    shapes = dict(TRAIN_DATA_SHAPES, **(shapes or {}))
    rng = np.random.RandomState(seed)
    ann = os.path.join(root, "annotations")
    os.makedirs(ann)
    env = {"STEMSEG_JSON_ANNOTATIONS_DIR": ann}

    def dump(name, obj):
        with open(os.path.join(ann, name), "w") as fh:
            json.dump(obj, fh)

    def image_set(name, env_var, json_name, n_images, cat_choices, n_inst, radius,
                  ignore_band=False):
        h, w = shapes[name]
        base = os.path.join(root, name)
        os.makedirs(base)
        env[env_var] = base
        images = []
        for i in range(n_images):
            img = texture(rng, h, w)
            cats, segs, union = [], [], np.zeros((h, w), np.uint8)
            for k in range(rng.randint(*n_inst)):
                r = radius(k)
                m = blob(h, w, rng.uniform(0.15, 0.85) * h, rng.uniform(0.15, 0.85) * w,
                         r * h, r * w * rng.uniform(0.6, 1.4))
                paint(img, m, rng.randint(0, 256, 3))
                cats.append(int(cat_choices[rng.randint(len(cat_choices))]))
                segs.append(rle_str(m))
                union |= m
            rel = f"{i:06d}.jpg"
            cv2.imwrite(os.path.join(base, rel), img)
            entry = {"image_path": rel, "height": h, "width": w, "categories": cats,
                     "segmentations": segs}
            if ignore_band:
                band = cv2.dilate(union, np.ones((5, 5), np.uint8)) & (1 - union)
                entry["ignore"] = rle_str(band)
            images.append(entry)
        dump(json_name, {"meta": {"category_labels": {str(c): str(c) for c in cat_choices}},
                         "images": images})

    image_set("coco", "COCO_TRAIN_IMAGES_DIR", "coco_train.json", 8,
              [1, 1, 1, 3, 18, 44, 62], (1, 7), lambda k: rng.uniform(0.06, 0.2))
    image_set("pascal_voc", "PASCAL_VOC_IMAGES_DIR", "pascal_voc_train.json", 8,
              [1, 2, 4, 7, 12, 15, 5], (2, 6), lambda k: rng.uniform(0.04, 0.2),
              ignore_band=True)
    image_set("mapillary", "MAPILLARY_IMAGES_DIR", "mapillary_train.json", 3,
              [20, 56] * 8 + [55, 62, 1, 3], (45, 46),
              lambda k: 0.002 if k % 15 == 0 else rng.uniform(0.08, 0.14))

    def video_set(name, base, json_name, specs, sub=""):
        return write_video_set(rng, base, ann, json_name, *shapes[name], specs, sub=sub)

    env["YOUTUBE_VIS_BASE_DIR"] = os.path.join(root, "youtube_vis")
    video_set("youtube_vis", env["YOUTUBE_VIS_BASE_DIR"], "youtube_vis_train.json", [
        ("y0", 24, {1: 5}, {}),
        ("y1", 22, {1: 1, 2: 7}, {1: {10}, 2: {10, 11}}),
        ("y2", 20, {1: 12, 2: 3, 3: 40}, {3: set(range(8))})], sub="train")
    env["DAVIS_BASE_DIR"] = os.path.join(root, "davis")
    davis = video_set("davis", env["DAVIS_BASE_DIR"], "davis_train.json", [
        ("d0", 40, {1: 1}, {1: {38, 39}}),
        ("d1", 40, {1: 1, 2: 1, 3: 1}, {2: set(range(5, 12))}),
        ("d2", 44, {1: 1, 2: 1, 3: 1, 4: 1}, {})])
    dump("davis_val.json", {"meta": {"category_labels": {"1": "object"}}, "sequences": [
        {"id": "val0", "height": davis[1]["height"], "width": davis[1]["width"],
         "image_paths": davis[1]["image_paths"][:16]}]})
    env["KITTIMOTS_BASE_DIR"] = os.path.join(root, "kitti_mots")
    gap = set(range(15, 22))
    video_set("kitti_mots", env["KITTIMOTS_BASE_DIR"], "kittimots_train.json", [
        ("0000", 40, {1001: 1, 1002: 1, 2001: 2, 10000: 3},
         {1001: gap, 1002: gap, 2001: gap | {0, 1, 2}}),
        ("0001", 20, {1001: 1, 2001: 2}, {})])
    return env


def mixture_points(p, seed, e=4, n_free=2, n_clusters=8, noise=0.05):
    """A DAVIS-like window: Gaussian blobs in embedding space, seediness
    peaked at the blob centres, outliers, ~30 % background."""
    import numpy as np

    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.8, 0.8, size=(n_clusters, e)).astype(np.float32)
    k = rng.randint(0, n_clusters + 1, size=p)
    kc = np.minimum(k, n_clusters - 1)
    inlier = k < n_clusters
    emb = np.where(inlier[:, None], centers[kc] + rng.randn(p, e) * noise,
                   rng.uniform(-1, 1, size=(p, e))).astype(np.float32)
    dist = np.linalg.norm(emb - centers[kc], axis=1)
    seed_v = np.where(inlier, np.exp(-dist / (2 * noise)) * 0.19 + 0.8,
                      rng.uniform(0.0, 0.5, p)).astype(np.float32)
    bw = (np.exp(rng.randn(p, e - n_free) * 0.1 + np.log(3.0)) * 10.0)
    free = np.full((p, n_free), 1.0 / 0.09)
    full_bw = np.concatenate([bw, free], axis=1).astype(np.float32)
    fg = rng.rand(p) > 0.3
    return emb, full_bw, seed_v, fg


def time_cuda(fn, n, warmup=2, queue_first=False):
    """Mean milliseconds per call of ``fn`` on the current stream. With
    ``queue_first`` (for ``fn`` that never waits for the device) the device
    first spins for about 5 ms, so that the host has queued all n calls
    before the first starts, and a host slower than the device does not
    show in the time."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queue_first:
        torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def primary_walk(emb, bw, fg, meta, primary, secondary):
    """Replays the primary assignments of the valid clusters of ``meta``:
    available points per iteration (for the operation count) and the points
    whose ``exp(-0.5 d)`` lies within KNIFE_EPS of a threshold."""
    import torch

    e = emb.shape[1]
    avail = fg.clone()
    knife = torch.zeros_like(fg)
    n_avail = []
    for k in range(meta.shape[0]):
        if meta[k, -1] <= 0.5:
            break
        c, b = meta[k, :e], meta[k, e:2 * e]
        d2 = torch.zeros(emb.shape[0], device=emb.device)
        for j in range(e):
            d2 = d2 + (emb[:, j] - c[j]) ** 2 * b[j]
        prob = torch.exp(-0.5 * torch.sqrt(d2))
        knife |= ((prob - primary).abs() < KNIFE_EPS) | ((prob - secondary).abs() < KNIFE_EPS)
        n_avail.append(int(avail.sum()))
        avail &= ~(prob > primary)
    return n_avail, knife


def check_edge_cases(ops, name):
    """The loop running out of points before K (key 0 must stop it), a
    window without fg points, K = 1, and the same top seediness in two
    blocks (the smaller index wins), against the plain version."""
    import numpy as np
    import torch

    emb, bw, seed, fg = mixture_points(2000, seed=7, n_clusters=2, noise=0.01)
    tie_seed, tie_fg = seed.copy(), fg.copy()
    tie_seed[[100, 1500]], tie_fg[[100, 1500]] = 0.9995, True  # in two blocks
    cases = (("all_taken", np.ones_like(bw), np.ones_like(fg), seed, 20, 0.0),
             ("all_background", bw, np.zeros_like(fg), seed, 20, 0.0),
             ("k1", bw, fg, seed, 1, 0.8),
             ("tie", bw, tie_fg, tie_seed, 20, 0.8))
    for case, case_bw, case_fg, case_seed, k, min_seed in cases:
        tensors = [torch.from_numpy(x).cuda() for x in (emb, case_bw, case_seed, case_fg)]
        for mode in ("reference", "nearest"):
            kwargs = main_kwargs(k, mode, min_seed)
            labels, meta = getattr(ops, name)(*tensors, **kwargs)
            ref_labels, ref_meta = ops.cluster_points_reference(*tensors, **kwargs)
            if not (torch.equal(labels, ref_labels) and torch.equal(meta, ref_meta)):
                raise AssertionError(f"{name} {case} {mode}: differs from the plain version")
        n_valid = int((meta[:, -1] > 0.5).sum())
        if case == "all_taken" and not (n_valid < k and bool((labels >= 0).all())):
            raise AssertionError(f"{name} all_taken: {n_valid} clusters, points left")
        if case == "tie" and not torch.equal(meta[0, :4], tensors[0][100]):
            raise AssertionError(f"{name} tie: the first seed is not the smaller index")
        log(f"  {name} edge case {case}: {n_valid} clusters, exact in both modes")


def cuda_inputs(p, e=4, n_free=2):
    import torch

    return tuple(torch.from_numpy(x).cuda()
                 for x in mixture_points(p, seed=p % 1000, e=e, n_free=n_free))


def main_kwargs(k=20, mode="reference", min_seed=0.8, e=4):
    return dict(e_dims=e, max_instances=k, primary=0.5, secondary=0.3,
                min_seediness=min_seed, reference_secondary=mode == "reference")


def compare_with_plain(ops, tag, tensors, labels, meta, kwargs):
    """A kernel's ``labels`` and ``meta`` on ``tensors`` against the plain
    version's: meta equal, labels equal except knife-edge points, at most
    MAX_KNIFE_FRACTION of them. Returns (clusters, label mismatches,
    available points per active iteration)."""
    import torch

    p = tensors[0].shape[0]
    ref_labels, ref_meta = ops.cluster_points_reference(*tensors, **kwargs)
    torch.cuda.synchronize()
    err = float((meta - ref_meta).abs().max())
    if err != 0.0:
        raise AssertionError(f"{tag}: meta differs by {err}")
    n_avail, knife = primary_walk(tensors[0], tensors[1], tensors[3], ref_meta,
                                  kwargs["primary"], kwargs["secondary"])
    mism = labels != ref_labels
    n_mism = int(mism.sum())
    if bool((mism & ~knife).any()) or n_mism > MAX_KNIFE_FRACTION * p:
        raise AssertionError(f"{tag}: {n_mism} label mismatches, "
                             f"{int((mism & ~knife).sum())} not on a knife edge")
    return int((meta[:, -1] > 0.5).sum()), n_mism, n_avail


def check_exact(ops, name, tensors):
    """Both secondary modes at K = 20 and the reference mode at K = 3
    against the plain version (``compare_with_plain``). Returns (max abs
    meta error, label mismatches, available points per active iteration of
    the K = 20 reference run)."""
    p, e = tensors[0].shape
    wrapper = getattr(ops, name)
    mism_total, n_iter_avail = 0, None
    for mode, k in (("reference", 20), ("nearest", 20), ("reference", 3)):
        kwargs = main_kwargs(k, mode, e=e)
        labels, meta = wrapper(*tensors, **kwargs)
        tag = f"{name} P={p} {mode} K={k}"
        n_valid, n_mism, n_avail = compare_with_plain(ops, tag, tensors, labels, meta, kwargs)
        if n_valid < min(k, 3):
            raise AssertionError(f"{tag}: only {n_valid} clusters formed")
        log(f"  {name} P={p} E={e} {mode:9s} K={k:2d}: {n_valid} clusters, "
            f"{n_mism} knife-edge label mismatches, meta max abs err 0.0")
        mism_total += n_mism
        if (mode, k) == ("reference", 20):
            n_iter_avail = n_avail
    return 0.0, mism_total, n_iter_avail


def device_kernels(fn, n, attempts=3):
    """Kernels the device ran per call of ``fn`` (torch.profiler): by name,
    (launches per call, device ms per call). On the H100 the profiler has
    been seen to return no device event at all for a session, and to lose
    one launch of a kernel out of 20 (19 recorded for 20 calls that each
    launch it once). Such a session is profiled again; it raises after
    ``attempts`` sessions without an event. Where every session lost
    launches, the last one is read with each kernel's launches per call
    rounded to the nearest whole number (kept as it is below 0.5) and its
    device ms per call the mean of the launches it recorded times that."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    by_name = {}
    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        session = {}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                count, us = session.get(evt.name, (0, 0.0))
                session[evt.name] = (count + 1, us + evt.time_range.elapsed_us())
        if not session:
            log(f"  profiler: no device event in session {attempt + 1} of {attempts}")
            continue
        by_name = session
        if all(count % n == 0 for count, _ in session.values()):
            break
        log(f"  profiler: session {attempt + 1} of {attempts} lost launches "
            f"({ {name[:60]: count for name, (count, _) in session.items()} } over {n} calls)")
    if not by_name:
        raise RuntimeError(f"torch.profiler recorded no device event in {attempts} sessions")
    per_call = {}
    for name, (count, us) in by_name.items():
        launches = round(count / n) if count / n >= 0.5 else count / n
        per_call[name] = (launches, us / count * launches / 1e3)
    return per_call


def host_ms_per_call(fn, n):
    """Host wall time per call, the device's queue never full (no
    synchronise between the calls)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return host


def cold_l2_ms(fn, n):
    """Median ms of one call after writing over 512 MB (10x the L2; the
    write also covers the host's time to queue the call)."""
    import torch

    flush = torch.empty(128 * 2**20, dtype=torch.float32, device="cuda")
    pairs = []
    for _ in range(n):
        flush.fill_(1.0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in pairs)[n // 2]


def kernel_split(ops, name, p, tensors=None):
    """Where one wrapper call's time goes at ``p`` points (K = 20, reference
    mode): CUDA-event ms over 20 calls queued before the first starts, the
    device time of the clustering kernels (torch.profiler; any other kernel
    is listed but not counted), host ms per call, cold-L2 ms and the executed iterations (the
    active ones plus the one that stopped the loop). Needs nothing but the
    wrappers, so it also measures older trees of the port."""
    tensors = cuda_inputs(p) if tensors is None else tensors
    kw = main_kwargs(e=tensors[0].shape[1])
    wrapper = getattr(ops, name)
    fn = lambda: wrapper(*tensors, **kw)  # noqa: E731
    _, meta = fn()
    n_active = int((meta[:, -1] > 0.5).sum())
    per_call = device_kernels(fn, 20)
    row = {"ms": time_cuda(fn, 20, queue_first=True),
           "device_ms": sum(ms for k, (c, ms) in per_call.items() if "cluster" in k),
           "host_ms_per_call": host_ms_per_call(fn, 20),
           "cold_l2_ms": cold_l2_ms(fn, 10),
           "iterations": n_active + (1 if n_active < kw["max_instances"] else 0),
           "clusters": n_active,
           "device_kernels_per_call": {k[:80]: c for k, (c, ms) in per_call.items()}}
    log(f"  {name} P={p} E={kw['e_dims']}: events {row['ms']:.4f} ms, device {row['device_ms']:.4f} ms, "
        f"host {row['host_ms_per_call']:.4f} ms/call, cold L2 {row['cold_l2_ms']:.4f} ms, "
        f"{row['iterations']} executed iterations ({n_active} clusters)")
    log(f"  {name} P={p} E={kw['e_dims']}: device kernels per call {row['device_kernels_per_call']}")
    return row


def kernel_splits(ops):
    """``kernel_split`` at the main-path shapes and of
    ``cluster_points_single`` at path A's 878,592 points."""
    return {f"{name}@{p}": kernel_split(ops, name, p)
            for name, p in (("cluster_points_single", 207_360),
                            ("cluster_points_tiled", 878_592),
                            ("cluster_points_single", 878_592))}


def bound(p, e, n_iter_avail):
    """Least time of one call: inputs read once as far as the function needs
    them (emb 4E B, seed 4 B and fg 1 B a point; bw 4E B at each active
    iteration's seed only), labels (4 B a point) and meta written once;
    3E + 4 operations (sub, mul, mul, add per dim, sqrt, scale, exp,
    compare) for each available point of each active iteration."""
    n_bytes = p * (4 * e + 4 + 1) + len(n_iter_avail) * 4 * e + p * 4 + 32 * 128 * 4
    n_ops = sum(n_iter_avail) * (3 * e + 4)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                points=p, e_dims=e, bytes=n_bytes, ops=n_ops)


def timed_row(ops, name, tensors, n_iter_avail):
    """``kernel_split`` on ``tensors`` (which must run one clustering kernel
    a call and nothing else), the plain version's ms and the bound."""
    p, e = tensors[0].shape
    row = kernel_split(ops, name, p, tensors)
    kernels_per_call = row.pop("device_kernels_per_call")
    if len(kernels_per_call) != 1 or list(kernels_per_call.values()) != [1.0] \
            or "cluster" not in next(iter(kernels_per_call)):
        raise AssertionError(f"{name} P={p}: a call ran {kernels_per_call}, expected one "
                             "clustering kernel and nothing else")
    kw = main_kwargs(e=e)
    row["plain_ms"] = time_cuda(lambda: ops.cluster_points_reference(*tensors, **kw),
                                3, warmup=1)
    row.update(bound(p, e, n_iter_avail))
    log(f"  {name} P={p} E={e}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}: {row['bytes']} B, "
        f"{row['ops']} ops over {len(n_iter_avail)} active iterations)")
    return row


def check_kernels(ops):
    import torch

    sms, smem = ops.device_limits(torch.cuda.current_device())
    for e in range(1, ops.MAX_E_DIMS + 1):
        for resident in (True, False):
            py, lib = (f(e, resident, sms, smem)
                       for f in (ops.on_chip_capacity, ops.library_capacity))
            if py != lib:
                raise AssertionError(f"on-chip capacity E={e} resident={resident}: "
                                     f"wrapper {py}, CUDA library {lib}")
    log(f"  {sms} SMs, {smem} B of shared memory a block; on-chip capacity at E=4 (wrapper "
        f"and library agree for E=1..8): single {ops.on_chip_capacity(4, True, sms, smem)} points, "
        f"tiled state {ops.on_chip_capacity(4, False, sms, smem)} points")
    results = {}
    for name, main_p, extra in (("cluster_points_single", 207_360, ()),
                                ("cluster_points_tiled", 878_592,
                                 (PATH_C_POINTS, PATH_T_POINTS, BEYOND_ON_CHIP,
                                  PATH_C2_POINTS))):
        row = {"max_abs_err": 0.0, "label_mismatches": 0}
        shapes = [(p, 4, 2) for p in (207_360, 878_592) + extra] + [(PATH_D_POINTS, 3, 0)]
        for p, e, n_free in shapes:
            tensors = cuda_inputs(p, e, n_free)
            err, n_mism, n_avail = check_exact(ops, name, tensors)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            row["label_mismatches"] += n_mism
            if p == main_p:
                main_tensors, n_iter_avail = tensors, n_avail
            elif name == "cluster_points_tiled" and p in (PATH_D_POINTS, PATH_C2_POINTS):
                # the shapes of paths D and C′
                row[f"at_{p}_e{e}"] = timed_row(ops, name, tensors, n_avail)
            del tensors
        check_edge_cases(ops, name)
        if name == "cluster_points_single":
            try:
                ops.cluster_points_single(*cuda_inputs(BEYOND_ON_CHIP), **main_kwargs())
            except ValueError as exc:
                log(f"  cluster_points_single P={BEYOND_ON_CHIP}: refused ({exc})")
            else:
                raise AssertionError("cluster_points_single took a window beyond its capacity")
        else:
            log(f"  cluster_points_tiled P={BEYOND_ON_CHIP} and P={PATH_C2_POINTS}: "
                "state off chip, exact above")

        # times at the main-path shape, K = 20, reference mode
        row.update(timed_row(ops, name, main_tensors, n_iter_avail))
        floor = device_kernels(lambda: ops.sync_floor(main_p, row["iterations"]), 20)
        if [c for k, (c, ms) in floor.items() if "sync_floor" in k] != [1.0]:
            raise AssertionError(f"{name}: the sync floor ran {floor}, expected one "
                                 "sync-floor kernel a call")
        row["sync_floor_ms"] = sum(ms for k, (c, ms) in floor.items() if "sync_floor" in k)
        log(f"  {name} P={main_p}: sync floor {row['sync_floor_ms']:.4f} ms over "
            f"{row['iterations']} exchanges")
        results[name] = row
    # the single/tiled crossover at path A's window
    cross = kernel_split(ops, "cluster_points_single", 878_592)
    cross.pop("device_kernels_per_call")
    results["cluster_points_single"]["at_878592"] = cross
    return results


def make_writer(dataset, out_dir, upscaled_inputs=False, device="cuda"):
    from stemseg_tpu_torch.inference.output_utils import (
        DavisOutputGenerator,
        KittiMOTSOutputGenerator,
        YoutubeVISOutputGenerator,
    )

    cls = {"davis": DavisOutputGenerator, "ytvis": YoutubeVISOutputGenerator,
           "kittimots": KittiMOTSOutputGenerator}[dataset]
    return cls(out_dir, upscaled_inputs=upscaled_inputs, device=device)


def max_tracks_of(cfg, dataset):
    return {"davis": cfg.data.davis.max_inference_tracks,
            "ytvis": cfg.data.youtube_vis.max_inference_tracks,
            "kittimots": cfg.data.kitti_mots.max_inference_tracks}[dataset]


def resize_hw(cfg, frames):
    from stemseg_tpu_torch.structures.geometry import compute_resize_params

    new_w, new_h, _ = compute_resize_params((frames.shape[2], frames.shape[1]),
                                            cfg.input.min_dim, cfg.input.max_dim)
    return new_h, new_w


def window_features(eng, frames):
    """Backbone + FPN of the first window of ``frames``, as the heads take
    them: coarsest first, each ``[1, C, T, h_s, w_s]``."""
    import torch

    raw = torch.from_numpy(frames[:eng.cfg.input.num_frames]).to(eng.device)
    with torch.no_grad():
        feats = eng.model.backbone_features(eng.preprocess(raw, resize_hw(eng.cfg, frames)))
    return [f.permute(1, 0, 2, 3)[None] for f in feats[::-1]]


def centre_fg_logit(model, cfg, frames):
    """The fg channel's weights of the semseg head lose their component
    along the head trunk's mean output on the first window of ``frames``
    (with 2 channels, the difference of the two channels' weights does), so
    that the fg decision of random weights varies over the pixels."""
    import torch

    from stemseg_tpu_torch.inference.engine import InferenceEngine

    head = model.semseg_head
    with torch.no_grad():
        trunk = head.trunk(window_features(InferenceEngine(cfg, model), frames))
        mu = trunk.mean(dim=(0, 2, 3, 4)).double()
        w = head.conv_out.weight[:, :, 0, 0, 0]
        d = (w[-1] - (w[0] if w.shape[0] == 2 else 0.0)).double()
        w[-1] -= ((d @ mu) / (mu @ mu) * mu).float()


def build_random_model(cfg, frames, seed, device="cuda"):
    from stemseg_tpu_torch.models import build_model, init_random_weights

    model = build_model(cfg, device=device)
    init_random_weights(model, seed)
    if model.semseg_head is not None:
        centre_fg_logit(model, cfg, frames)
    return model


def run_main_path(tg, frames, seq_id):
    """The port's main path, as a user drives it: one sequence of raw frames
    through the TrackGenerator into its writer, then the writer's
    ``save()``. Returns the chainer's output and the launch counts of the
    run."""
    from stemseg_tpu_torch.ops import launch_counts, reset_launch_counts
    from stemseg_tpu_torch.utils.timer import Timer

    seq = Sequence(seq_id, len(frames), frames.shape[1:3])
    Timer.reset()
    reset_launch_counts()
    labels, counts, lifetimes, metas = tg._process_loaded(
        seq, frames, frames.shape[1:3], tg.max_tracks)
    launches = dict(launch_counts)
    tg.output_generator.save()
    return labels, counts, metas, launches


def make_track_generator(cfg, dataset, model, out_dir, resize_embeddings=False,
                         frame_overlap=-1, use_fused=False):
    """A ``TrackGenerator`` into the dataset's writer; the streaming path
    unless ``use_fused`` (the phases that split a path per window, 4-18,
    keep the streaming path their tables were taken on)."""
    from stemseg_tpu_torch.inference.main import TrackGenerator

    writer = make_writer(dataset, out_dir, upscaled_inputs=resize_embeddings,
                         device=next(model.parameters()).device)
    return TrackGenerator(cfg, dataset, model, writer, max_tracks_of(cfg, dataset),
                          frame_overlap=frame_overlap, resize_embeddings=resize_embeddings,
                          use_fused=use_fused)


def fused_first_run_launches(n_windows):
    """Host launch counts of a kernel of pass B in a shape bucket's first
    fused run: the first window's call runs eagerly (one launch), the
    second is captured into a CUDA graph (no launch) and replayed, every
    later call replays the graph; each replay counts the graph's launch."""
    return n_windows


def profiled_launches(fn, expect, tag, attempts=2):
    """Runs ``fn`` under torch.profiler and counts the device launches of
    the clustering kernels and the lsap kernel, graph replays included
    (the wrappers' host counts include replays too: ``ops.launches``).
    ``expect()``, read after each run, gives the counts it must find; a
    session that found others is run again (the profiler has been seen to
    lose a launch on the H100, see ``device_kernels``), and the last one
    raises. Returns the
    counts, {"cluster_kernel": n, "lsa_kernel": n}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts = {"cluster_kernel": 0, "lsa_kernel": 0}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                for name in counts:
                    counts[name] += name in evt.name
        if counts == expect():
            return counts
        log(f"  {tag}: profiler session {attempt + 1} of {attempts} counted {counts}, "
            f"expected {expect()}")
    raise AssertionError(f"{tag}: device launches {counts}, expected {expect()}")


def check_outputs(tag, tg, out_dir, seq_id, frames):
    """The writer's files, by the repo's own readers."""
    from stemseg_tpu_torch.inference.output_utils.kitti_mots_postprocessing import Detection
    from stemseg_tpu_torch.utils import rle

    n_frames, image_hw = len(frames), tuple(frames.shape[1:3])
    if tg.dataset == "davis":
        pngs = sorted(os.listdir(os.path.join(out_dir, "results", seq_id)))
        if pngs != [f"{t:05d}.png" for t in range(n_frames)]:
            raise AssertionError(f"path {tag}: wrote {len(pngs)} PNGs, expected {n_frames}")
        return f"{len(pngs)} PNGs"
    if tg.dataset == "ytvis":
        with open(os.path.join(out_dir, "results.json")) as fh:
            results = json.load(fh)
        n_classes = tg.cfg.input.num_classes
        if not 0 < len(results) <= tg.max_tracks or \
                not os.path.isfile(os.path.join(out_dir, "results.zip")):
            raise AssertionError(f"path {tag}: {len(results)} instances, or no results.zip")
        for r in results:
            shapes = {rle.decode(m).shape for m in r["segmentations"]}
            if r["video_id"] != seq_id or len(r["segmentations"]) != n_frames \
                    or shapes != {image_hw} or not 1 <= r["category_id"] <= n_classes - 1 \
                    or not 0 < r["score"] <= 1:
                raise AssertionError(f"path {tag}: instance {r['category_id']} "
                                     f"{r['score']} {len(r['segmentations'])} {shapes}")
        classes = sorted({r["category_id"] for r in results})
        return f"results.json: {len(results)} instances, classes {classes}"
    with open(os.path.join(out_dir, "results", f"{seq_id}.txt")) as fh:
        dets = [Detection.from_txt(line) for line in fh]
    for d in dets:
        if d.class_id not in (1, 2) or d.track_id // 1000 != d.class_id \
                or rle.decode(d.mask).shape != image_hw or not 0 <= d.frame_id < n_frames:
            raise AssertionError(f"path {tag}: bad line {d.as_txt()[:80]}")
    nms_file = os.path.join(out_dir, "results_nms", f"{seq_id}.txt")
    if not dets or not os.path.isfile(nms_file):
        raise AssertionError(f"path {tag}: {len(dets)} detections, NMS output missing")
    with open(nms_file) as fh:
        n_nms = len(fh.readlines())
    return (f"{seq_id}.txt: {len(dets)} detections of {len({d.track_id for d in dets})} "
            f"tracks, {n_nms} after the NMS")


def check_main_path(tag, preset, overrides, dataset, frames, seq_id, kernel, expect_windows,
                    expect_shape, out_root, resize_embeddings=False):
    import numpy as np
    import torch

    from stemseg_tpu_torch.config import load_preset, merge

    cfg = merge(load_preset(preset), overrides)
    model = build_random_model(cfg, frames, MAIN_SEED)
    out_dir = os.path.join(out_root, tag)
    tg = make_track_generator(cfg, dataset, model, out_dir, resize_embeddings)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    labels, counts, metas, launches = run_main_path(tg, frames, seq_id)
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    other = "cluster_points_single" if kernel == "cluster_points_tiled" else "cluster_points_tiled"
    if launches[kernel] != expect_windows or launches[other] != 0 \
            or launches["cluster_points_reference"] != 0:
        raise AssertionError(f"path {tag}: launches {launches}, expected {expect_windows} "
                             f"of {kernel} and no other")
    if labels.shape != expect_shape:
        raise AssertionError(f"path {tag}: labels {labels.shape}, expected {expect_shape}")
    written = check_outputs(tag, tg, out_dir, seq_id, frames)
    per_window = [int(m.valid.sum()) for m in metas]
    n_points = [int(np.prod(m.labels.shape)) for m in metas]
    if not all(per_window) or len(counts) < 2:
        raise AssertionError(f"path {tag}: no clusters formed ({per_window})")
    log(f"  path {tag}: {preset} min/max dim {cfg.input.min_dim}/{cfg.input.max_dim}, "
        f"{len(frames)} frames of {frames.shape[1]}x{frames.shape[2]}, {len(metas)} windows of "
        f"{n_points[0]} points, labels {labels.shape}, {len(counts) - 1} tracks, {written}, "
        f"wall {wall:.3f} s (writer included), peak device memory {peak_gib:.2f} GiB")
    log(f"  path {tag}: clusters per window {per_window}; launches {launches}")
    for line in tg.fps_report():
        log(f"  path {tag}: {line}")
    return cfg, model, launches


def check_small_input(out_root):
    """The slice on the GPU against the slice on the CPU on one small input,
    for a DAVIS-shaped config and a YT-VIS-shaped one (semseg head of
    (256, 256, 256, 256) channels with 4 + 1 logits, fused seediness):
    engine outputs within 1e-3, labels and the argmax of the multiclass
    logits on >= 99.9 % of the pixels."""
    import numpy as np
    import torch

    from stemseg_tpu_torch.config import load_config

    base = {"input": {"num_frames": 4, "min_dim": 64, "max_dim": 96},
            "model": {"backbone": {"type": "R-50-FPN"}, "embedding_dim_mode": "xyff",
                      "use_seediness_head": True, "use_semseg_head": False,
                      "embeddings": {"embedding_size": 4}},
            "training": {"losses": {"embedding": {"free_dim_stds": [0.3, 0.3]}}},
            "clustering": {"min_seediness_prob": 0.05}}
    semseg = json.loads(json.dumps(base))
    semseg["input"]["num_classes"] = 4
    semseg["model"].update(use_seediness_head=False, use_semseg_head=True,
                           semseg={"inter_channels": [256, 256, 256, 256]})
    frames = synthetic_frames(10, 32, 48, seed=1)
    for dataset, over in (("davis", base), ("ytvis", semseg)):
        cfg = load_config(over)
        cpu_model = build_random_model(cfg, frames, 1, device="cpu")
        outs = {}
        for dev in ("cuda", "cpu"):
            model = cpu_model
            if dev == "cuda":
                model = build_random_model(cfg, frames, 1, device="cuda")
                model.load_state_dict(cpu_model.state_dict())
            tg = make_track_generator(cfg, dataset, model, os.path.join(out_root, "small_" + dev),
                                      frame_overlap=2)
            out = tg.do_inference(frames, (32, 48))
            outs[dev] = (out, tg.do_clustering(out)[0])
        (g_out, g_labels), (c_out, c_labels) = outs["cuda"], outs["cpu"]
        err = max(float((gw[k].cpu() - cw[k]).abs().max())
                  for gw, cw in zip(g_out["windows"], c_out["windows"])
                  for k in ("embeddings", "bandwidths", "seediness"))
        agree = float((g_labels == c_labels).mean())
        extra, argmax_agree = "", 1.0
        if g_out["multiclass_masks"] is not None:
            g_mc, c_mc = g_out["multiclass_masks"].cpu(), c_out["multiclass_masks"]
            err = max(err, float((g_mc - c_mc).abs().max()))
            argmax_agree = float((g_mc.argmax(-1) == c_mc.argmax(-1)).float().mean())
            fg_share = float(c_out["fg_masks"].float().mean())
            extra = f", argmax agreement {argmax_agree:.6f}, fg share {fg_share:.3f}"
        log(f"  small input {dataset}: GPU vs CPU engine max abs err {err:.3g}, label "
            f"agreement {agree:.6f}{extra}")
        if not err < 1e-3 or agree < 0.999 or argmax_agree < 0.999 or not np.isfinite(err):
            raise AssertionError(f"small input {dataset}: err {err}, agreement {agree}, "
                                 f"argmax agreement {argmax_agree}")


def window_cluster_ms(tg, frames):
    """CUDA-event ms of clustering the first window of ``frames`` as the
    chainer does (upscale if full scale, flatten, kernel, relabel), and of
    the kernel alone on the inputs it got, with its point count and E. The
    kernel's output on those inputs is held against the plain version
    (``compare_with_plain``)."""
    import torch

    import stemseg_tpu_torch.inference.clustering as clustering
    from stemseg_tpu_torch.ops import cluster as ops

    with torch.no_grad():
        out = tg.do_inference(frames, tuple(frames.shape[1:3]))
    w0 = out["windows"][0]
    fg = out["fg_masks"][torch.tensor(w0["frames"], device=tg.device)]
    del out
    fn = lambda: tg.chainer.cluster_fn(w0["embeddings"], w0["bandwidths"],  # noqa: E731
                                       w0["seediness"], fg, 1)
    seen = {}
    kernel_fn = clustering.cluster_points

    def spy(*args, **kwargs):
        out = kernel_fn(*args, **kwargs)
        seen.update(args=args, kwargs=kwargs, out=tuple(t.clone() for t in out))
        return out

    clustering.cluster_points = spy
    try:
        fn()
    finally:
        clustering.cluster_points = kernel_fn
    shape = seen["args"][0].shape
    n_valid, n_mism, _ = compare_with_plain(
        ops, f"window of {tuple(shape)}", seen["args"], *seen["out"], seen["kwargs"])
    log(f"  first window {tuple(shape)}: {n_valid} clusters, {n_mism} knife-edge label "
        "mismatches against the plain version, meta equal")
    window_ms = time_cuda(fn, 3, warmup=1)
    kernel_ms = time_cuda(lambda: kernel_fn(*seen["args"], **seen["kwargs"]), 5, warmup=1)
    return window_ms, kernel_ms, shape


def layer_split(tag, tg, frames, n_windows, kernel_ms=None, window_ms=None, compare_heads=None):
    """Device time of each layer of a path at its real shapes (CUDA events,
    warm): preprocessing and backbone + FPN on one window's frames scaled to
    the sequence, each 3D head (and the 4x semseg upscale) on one window
    times the windows, and the clustering of one window times the
    windows."""
    import torch

    from stemseg_tpu_torch.models.layers import upsample_trilinear

    eng = tg.engine
    t_win = tg.cfg.input.num_frames
    hw = resize_hw(tg.cfg, frames)
    raw = torch.from_numpy(frames[:t_win]).to(eng.device)
    n_frames = len(frames)
    parts = {}
    with torch.no_grad():
        parts["preprocess"] = time_cuda(lambda: eng.preprocess(raw, hw), 3) * n_frames / t_win
        batch = eng.preprocess(raw, hw)
        parts["backbone+FPN"] = time_cuda(lambda: eng.model.backbone_features(batch),
                                          3) * n_frames / t_win
        feats = window_features(eng, frames)
        heads = {"embedding head": eng.model.embedding_head,
                 "seediness head": eng.model.seediness_head,
                 "semseg head": eng.model.semseg_head}
        for name, head in heads.items():
            if head is not None:
                parts[name] = time_cuda(lambda: head(feats), 3) * n_windows
        if eng.semseg_resize_scale != 1.0:
            logits = eng.model.semseg_head(feats)
            s = eng.semseg_resize_scale
            parts["semseg 4x upscale"] = time_cuda(
                lambda: upsample_trilinear(logits, (1.0, s, s)), 3) * n_windows
            del logits
        if window_ms is not None:
            parts["clustering, window prep"] = (window_ms - kernel_ms) * n_windows
        if kernel_ms is not None:
            parts["clustering kernels"] = kernel_ms * n_windows
        for name, ms in parts.items():
            log(f"  layer split {tag}: {name:24s} {ms:9.3f} ms for {n_frames} frames")
        if compare_heads:
            ms = sum(time_cuda(lambda: h(feats), 3) for h in compare_heads.values())
            mine = sum(v for k, v in parts.items() if "head" in k) / n_windows
            log(f"  layer split {tag}: one window's heads {mine:.3f} ms; the DAVIS preset's "
                f"{' + '.join(compare_heads)} on the same window {ms:.3f} ms "
                f"(ratio {mine / ms:.3f})")
    return parts


def davis_heads():
    """The DAVIS presets' embedding (E = 4, no fused seediness) and
    seediness heads for 8-frame windows, random weights."""
    from stemseg_tpu_torch.config import load_preset
    from stemseg_tpu_torch.models import init_random_weights
    from stemseg_tpu_torch.models.decoders import EmbeddingDecoder, SeedinessDecoder

    m = load_preset("davis_1").model
    c = m.resnets.backbone_out_channels
    heads = {"embedding": EmbeddingDecoder(
                 c, tuple(m.embeddings.inter_channels), m.embeddings.embedding_size,
                 m.embedding_dim_mode, m.embeddings.tanh_activation, seediness_output=False,
                 num_frames=8, gn_groups=m.embeddings.gn_num_groups),
             "seediness": SeedinessDecoder(c, tuple(m.seediness.inter_channels), num_frames=8,
                                           gn_groups=m.seediness.gn_num_groups)}
    for i, h in enumerate(heads.values()):
        init_random_weights(h, i)
        h.cuda().eval()
    return heads


def semseg_path(tag, preset, dataset, frames, seq_id, n_windows, expect_shape, out_root,
                resize_embeddings=False, compare_heads=None):
    """A YT-VIS or KITTI-MOTS path: checked run, steady run, layer split."""
    cfg, model, launches = check_main_path(
        tag, preset, {"clustering": {"min_seediness_prob": 0.05}}, dataset, frames, seq_id,
        "cluster_points_tiled", n_windows, expect_shape, out_root, resize_embeddings)
    tg = make_track_generator(cfg, dataset, model, os.path.join(out_root, tag + "2"),
                              resize_embeddings)
    t0 = time.perf_counter()
    run_main_path(tg, frames, seq_id)
    log(f"  path {tag} steady: wall {time.perf_counter() - t0:.3f} s (writer included)")
    for line in tg.fps_report():
        log(f"  path {tag} steady: {line}")
    window_ms, kernel_ms, shape = window_cluster_ms(tg, frames)
    log(f"  path {tag}: cluster_points_tiled on the first window's inputs {tuple(shape)}: "
        f"{kernel_ms:.4f} ms; the window's whole clustering step {window_ms:.4f} ms")
    parts = layer_split(tag, tg, frames, n_windows, kernel_ms, window_ms, compare_heads)
    return launches, {"kernel_ms_real_window": kernel_ms, "points": int(shape[0]),
                      "layer_split_ms": parts}


def device_profile(tg, frames, tag="A"):
    """One more sequence through ``tg`` under torch.profiler: the device's
    busy share of the wall time (sum of kernel, copy and memset time on
    the device over the host's wall clock) and the largest device items."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seq = Sequence(tag + "_profiled", len(frames), frames.shape[1:3])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tg._process_loaded(seq, frames, frames.shape[1:3], tg.max_tracks)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    log(f"  profile {tag}: wall {wall_us / 1e3:.3f} ms (profiled, writer included), device busy "
        f"{busy_us / 1e3:.3f} ms = {busy_us / wall_us:.3f} of the wall")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  profile {tag}: {us / 1e3:9.3f} ms  {name[:90]}")


def training_cfg(preset, max_iterations, mode="synthetic"):
    """The preset with ``max_iterations``; ``mode=None`` keeps its own mode."""
    from stemseg_tpu_torch.config import load_preset, merge

    over = {"max_iterations": max_iterations}
    if mode:
        over["mode"] = mode
    return merge(load_preset(preset), {"training": over})


def new_trainer(cfg, model_dir, *extra):
    """The port's ``Trainer`` with the CLI's arguments (every optimizer step
    logged and summarised)."""
    from stemseg_tpu_torch.training.main import Trainer, make_parser

    args = make_parser().parse_args(
        ["--model_dir", model_dir, "--cfg", "unused", "--display_interval", "1",
         "--summary_interval", "1", "--num_cpu_workers", str(TRAIN_WORKERS), *extra])
    return Trainer(cfg, model_dir, args)


def read_metrics(model_dir, keys):
    """The trainer's ``metrics.jsonl``; raises unless every ``keys`` value of
    every record is finite."""
    import math

    with open(os.path.join(model_dir, "logs", "metrics.jsonl")) as fh:
        records = [json.loads(line) for line in fh]
    for r in records:
        if not all(k in r and math.isfinite(r[k]) for k in keys):
            raise AssertionError(f"{model_dir}: metrics {r}")
    return records


def changed_params(model, before, names=None):
    """(trainable tensors unchanged, frozen tensors changed) against
    ``before``; ``names`` limits the check."""
    import torch

    stale, moved = [], []
    for name, p in model.named_parameters():
        if names is not None and not name.startswith(names):
            continue
        same = torch.equal(p.detach(), before[name])
        if p.requires_grad and same:
            stale.append(name)
        elif not p.requires_grad and not same:
            moved.append(name)
    return stale, moved


def steady_intervals(trainer, skip):
    """Host seconds between the trainer's optimizer-step ends, the first
    ``skip`` intervals left out."""
    t = trainer.iteration_end_times
    return [b - a for a, b in zip(t[:-1], t[1:])][skip:]


def assert_full_width(tag, cfg):
    """Path T (and R): R-101-FPN, heads (256, 256, 128, 128), 8 frames of
    736x1248, E = 4 ``xyff``, seediness head, 16 instance slots, 2 clips an
    update. Path T' (and R'): semseg head (256, 256, 256, 256) with 41 + 1
    logits, fused seediness, 640x1196 padded to 640x1216. Path R'': 8 frames
    of 736x1792, E = 3 ``xyt``, semseg 3 + 1, 30 instance slots, 2 clips an
    update."""
    from stemseg_tpu_torch.config import resolve_max_instances
    from stemseg_tpu_torch.structures.geometry import pad_to_multiple

    m = cfg.model
    if tag in ("T", "R"):
        got = (m.backbone.type, tuple(m.embeddings.inter_channels), cfg.input.num_frames,
               cfg.input.min_dim, cfg.input.max_dim, m.embeddings.embedding_size,
               m.embedding_dim_mode, m.use_seediness_head, resolve_max_instances(cfg),
               cfg.training.batch_size)
        want = ("R-101-FPN", (256, 256, 128, 128), 8, 736, 1248, 4, "xyff", True, 16, 2)
    elif tag in ("T'", "R'"):
        got = (m.backbone.type, tuple(m.semseg.inter_channels), cfg.input.num_classes,
               pad_to_multiple(cfg.input.min_dim, cfg.input.max_dim), m.use_seediness_head)
        want = ("R-101-FPN", (256, 256, 256, 256), 41, (640, 1216), False)
    else:
        got = (m.backbone.type, tuple(m.embeddings.inter_channels), cfg.input.num_frames,
               cfg.input.min_dim, cfg.input.max_dim, m.embedding_dim_mode, cfg.input.num_classes,
               m.use_semseg_head, resolve_max_instances(cfg), cfg.training.batch_size)
        want = ("R-101-FPN", (256, 256, 128, 128), 8, 736, 1792, "xyt", 3, True, 30, 2)
    if got != want:
        raise AssertionError(f"path {tag}: not at the preset's full width: {got}")


def train_path_t(out_root):
    """Phase 11: 4 steps, resume, 2 more; returns the resumed trainer and the
    run's numbers."""
    import torch

    model_dir = os.path.join(out_root, "T")
    cfg = training_cfg("davis_1", 4)
    assert_full_width("T", cfg)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    first = new_trainer(cfg, model_dir, "--save_interval", "2")
    init = {k: v.detach().clone() for k, v in first.model.state_dict().items()}
    first.start()
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    keys = ("total", "lovasz", "var_smoothness", "seediness", "total_embedding", "grad_norm")
    records = read_metrics(model_dir, keys)
    stale, moved = changed_params(first.model, init)
    frozen = [n for n, p in first.model.named_parameters() if not p.requires_grad]
    if [r["step"] for r in records] != [1, 2, 3, 4] or stale or moved or not frozen \
            or not all(n.startswith(("backbone.body.stem.", "backbone.body.layer1."))
                       for n in frozen):
        raise AssertionError(f"path T: steps {[r['step'] for r in records]}, unchanged "
                             f"trainable {stale[:3]}, changed frozen {moved[:3]}")
    ckpts = sorted(f for f in os.listdir(model_dir) if f.endswith(".pth"))
    if ckpts != ["000002.pth", "000004.pth"]:
        raise AssertionError(f"path T: checkpoints {ckpts}")
    log(f"  path T: {first.accumulate_steps} micro-steps an update, 4 steps in {wall:.3f} s "
        f"(build and first-step set-up included), peak device memory {peak_gib:.2f} GiB; "
        f"{len(frozen)} frozen tensors unchanged, all "
        f"{sum(p.requires_grad for p in first.model.parameters())} trainable changed")
    for r in records:
        log(f"  path T step {r['step']}: " + ", ".join(f"{k} {r[k]:.5f}" for k in keys))

    resumed = new_trainer(training_cfg("davis_1", 6), model_dir, "--save_interval", "2")
    opt_a, opt_b = first.optimizer.state_dict(), resumed.optimizer.state_dict()
    model_a, model_b = first.model.state_dict(), resumed.model.state_dict()
    same = (resumed.elapsed_iterations == 4 and resumed.scheduler.last_epoch == 4
            and all(torch.equal(model_a[k], model_b[k]) for k in model_a)
            and opt_a["state"].keys() == opt_b["state"].keys()
            and all(torch.equal(opt_a["state"][i]["momentum_buffer"],
                                opt_b["state"][i]["momentum_buffer"]) for i in opt_a["state"]))
    if not same:
        raise AssertionError(f"path T: the resumed session differs from the saved one "
                             f"(step {resumed.elapsed_iterations})")
    waits_first = list(first.loader_waits)
    intervals_first = steady_intervals(first, 1)
    del first, init, opt_a, opt_b, model_a, model_b
    torch.cuda.empty_cache()
    resumed.start()
    records = read_metrics(model_dir, keys)
    if [r["step"] for r in records][-2:] != [5, 6] or resumed.elapsed_iterations != 6:
        raise AssertionError(f"path T resumed: steps {[r['step'] for r in records]}")
    log("  path T: resumed at step 4 with the saved weights, momentum buffers and LR "
        "step; 2 more steps: " + "; ".join(
            f"step {r['step']} total {r['total']:.5f}" for r in records[-2:]))
    # each trainer's first wait is its loader's start-up
    firsts = [waits_first[0], resumed.loader_waits[0]]
    steady = waits_first[1:] + list(resumed.loader_waits[1:])
    stats = {"trainer_intervals_s": intervals_first + steady_intervals(resumed, 0),
             "loader_wait_firsts_s": firsts,
             "loader_wait_mean_s": sum(steady) / max(len(steady), 1),
             "loader_wait_max_s": max(steady, default=0.0),
             "peak_gib_first_run": peak_gib}
    log(f"  path T: trainer step intervals {['%.4f' % s for s in stats['trainer_intervals_s']]} s "
        f"(the first after a checkpoint includes its save); loader wait per batch after the "
        f"first {stats['loader_wait_mean_s'] * 1e3:.3f} ms mean, "
        f"{stats['loader_wait_max_s'] * 1e3:.3f} ms max over {len(steady)} batches; the "
        f"first of each trainer {['%.3f' % s for s in firsts]} s")
    return resumed, stats


def placed_batches(trainer, n):
    """``n`` batches of the trainer's config and mode on its device."""
    from stemseg_tpu_torch.config import resolve_max_instances
    from stemseg_tpu_torch.training.datasets import create_training_dataset
    from stemseg_tpu_torch.training.loader import collate_batch, to_device
    from stemseg_tpu_torch.training.main import INIT_SEED

    ds = create_training_dataset(trainer.cfg, n * trainer.samples_per_step, seed=INIT_SEED,
                                 print_fn=lambda *a: None)
    k = trainer.samples_per_step
    return [to_device(collate_batch(
        [ds[i * k + j] for j in range(k)], resolve_max_instances(trainer.cfg),
        overflow=trainer.cfg.training.instance_overflow), trainer.device) for i in range(n)]


def time_h2d(tag, trainer, batch, smi):
    """CUDA-event ms of copying the device keys of ``batch`` (a host or a
    device batch) to the device from pinned host memory, as the trainer
    does."""
    from stemseg_tpu_torch.training.loader import DEVICE_KEYS, to_device

    pinned = {k: batch[k].cpu().pin_memory() for k in DEVICE_KEYS}
    ms = time_cuda(lambda: to_device(pinned, trainer.device), 5, warmup=1)
    mb = sum(v.numel() * v.element_size() for v in pinned.values()) / 1e6
    log(f"  {tag} H2D ({smi}): {ms:.3f} ms for one micro-batch of {mb:.1f} MB from "
        f"pinned memory ({mb / ms:.3f} GB/s)")
    return ms


def micro_step_split(step, batch):
    """Device ms of one micro-step's parts (CUDA events); the optimizer
    update runs when it is due."""
    import torch

    from stemseg_tpu_torch.training.optim import global_norm

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
    ev[0].record()
    feats = step.model.clip_features(batch["images"].permute(0, 1, 4, 2, 3))
    ev[1].record()
    out = step.model.clip_heads(feats)
    ev[2].record()
    total, _ = step.loss_fn(out, batch)
    ev[3].record()
    grads = torch.autograd.grad(total, step.params, allow_unused=True, materialize_grads=True)
    ev[4].record()
    global_norm(grads)
    step.accumulate(grads)
    ev[5].record()
    step.update()
    ev[6].record()
    torch.cuda.synchronize()
    names = ("backbone+FPN forward", "heads forward", "targets + losses", "backward",
             "grad norm + accumulate", "optimizer update")
    return dict(zip(names, (ev[i].elapsed_time(ev[i + 1]) for i in range(6))))


def training_timings(tag, trainer, smi, n_steps=3):
    """Steady step time of ``trainer.train_step`` on batches already on the
    device, the micro-step split, and a profiled device-busy share over 2
    optimizer steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step = trainer.train_step
    acc = trainer.accumulate_steps
    batches = placed_batches(trainer, 2)
    for k in range(acc):  # warm, and ends on an update
        step(batches[k % 2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(n_steps * acc):
        step(batches[k % 2])
    torch.cuda.synchronize()
    s_per_step = (time.perf_counter() - t0) / n_steps
    clips = acc * trainer.samples_per_step
    log(f"  {tag} timing ({smi}): {s_per_step:.4f} s per optimizer step of {clips} clips "
        f"({clips / s_per_step:.3f} clips/s), step alone, batches on the device")
    h2d_ms = time_h2d(tag, trainer, batches[0], smi)

    parts = {}
    for k in range(acc):  # one optimizer step
        for name, ms in micro_step_split(step, batches[k % 2]).items():
            parts[name] = parts.get(name, 0.0) + ms
    for name, ms in parts.items():
        per = "optimizer step" if name == "optimizer update" else "micro-step"
        value = ms if per == "optimizer step" else ms / acc
        log(f"  {tag} split ({smi}): {name:24s} {value:9.3f} ms a {per}")

    for attempt in range(2):  # a session without device events is profiled again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for k in range(2 * acc):
                step(batches[k % 2])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name = {}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
        if by_name:
            break
        log(f"  {tag} profile: no device event in session {attempt + 1} of 2")
    busy_us = sum(by_name.values())
    if not by_name:
        raise RuntimeError(f"{tag}: torch.profiler recorded no device event")
    log(f"  {tag} profile ({smi}): 2 optimizer steps, wall {wall_us / 1e3:.3f} ms "
        f"(profiled), device busy {busy_us / 1e3:.3f} ms = {busy_us / wall_us:.3f} of the wall")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"  {tag} profile: {us / 1e3:9.3f} ms  {name[:90]}")
    return {"s_per_step": s_per_step, "clips_per_s": clips / s_per_step, "h2d_ms": h2d_ms,
            "split_ms": parts, "busy_share": busy_us / wall_us}


def train_then_infer(trainer, frames, out_root, dtype=None, tag="T"):
    """The trainer's last ``.pth`` and ``config.yaml`` through the inference
    CLI's loaders (the model computing in ``dtype``, as ``--bf16`` builds
    it) and ``TrackGenerator`` into the DAVIS writer; every window through
    the kernel the dispatch picks, the first window's kernel output held
    against the plain version. Returns the launch counts and (the kernel,
    its ms on the first window's inputs)."""
    import numpy as np
    import torch

    from stemseg_tpu_torch.inference.main import load_inference_cfg, load_model
    from stemseg_tpu_torch.inference.windows import get_subsequence_frames
    from stemseg_tpu_torch.ops.cluster import single_block_supported
    from stemseg_tpu_torch.training.checkpoint import find_latest_checkpoint

    ckpt = find_latest_checkpoint(trainer.model_dir)
    cfg = load_inference_cfg(ckpt, "davis", None, None, 0.05)
    model = load_model(cfg, ckpt, device="cuda", dtype=dtype)
    out_dir = os.path.join(out_root, tag + "_infer")
    tg = make_track_generator(cfg, "davis", model, out_dir)
    labels, counts, metas, launches = run_main_path(tg, frames, tag)
    n_windows = len(get_subsequence_frames(len(frames), cfg.input.num_frames,
                                           tg.frame_overlap))
    n_points = int(np.prod(metas[0].labels.shape))
    kernel = ("cluster_points_single" if single_block_supported(
        n_points, cfg.clustering.max_instances, cfg.model.embeddings.embedding_size)
        else "cluster_points_tiled")
    other = ({"cluster_points_single", "cluster_points_tiled"} - {kernel}).pop()
    if launches[kernel] != n_windows or launches[other] or launches["cluster_points_reference"]:
        raise AssertionError(f"train -> infer: launches {launches}, expected {n_windows} "
                             f"of {kernel}")
    written = check_outputs(tag, tg, out_dir, tag, frames)
    log(f"  train -> infer ({tag}): {os.path.basename(ckpt)} + config.yaml ({cfg.input.min_dim}/"
        f"{cfg.input.max_dim}), {len(frames)} frames of {frames.shape[1]}x{frames.shape[2]}: "
        f"{len(metas)} windows of {n_points} points through {kernel}, labels "
        f"{tuple(labels.shape)}, {len(counts) - 1} tracks, clusters per window "
        f"{[int(m.valid.sum()) for m in metas]}, {written}; launches {launches}")
    window_ms, kernel_ms, shape = window_cluster_ms(tg, frames)
    if shape[0] != n_points:
        raise AssertionError(f"train -> infer: first window of {tuple(shape)}, expected "
                             f"{n_points} points")
    log(f"  train -> infer ({tag}): {kernel} on the first window's inputs {tuple(shape)}: "
        f"{kernel_ms:.4f} ms; the window's whole clustering step {window_ms:.4f} ms")
    del model, tg
    torch.cuda.empty_cache()
    return launches, (kernel, kernel_ms)


def train_path_t2(out_root, smi):
    """Phase 12: ``youtube_vis`` synthetic, 2 optimizer steps."""
    import torch

    from stemseg_tpu_torch.structures.geometry import pad_to_multiple

    cfg = training_cfg("youtube_vis", 2)
    assert_full_width("T'", cfg)
    padded = pad_to_multiple(cfg.input.min_dim, cfg.input.max_dim)
    model_dir = os.path.join(out_root, "T2")
    torch.cuda.reset_peak_memory_stats()
    trainer = new_trainer(cfg, model_dir, "--save_interval", "1000")
    head = "semseg_head."
    before = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()
              if k.startswith(head)}
    t0 = time.perf_counter()
    trainer.start()
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    records = read_metrics(model_dir, ("total", "semseg", "fg", "lovasz", "seediness"))
    stale, _ = changed_params(trainer.model, before, names=head)
    if len(records) != 2 or stale:
        raise AssertionError(f"path T': {len(records)} steps, unchanged {stale[:3]}")
    interval = steady_intervals(trainer, 0)
    log(f"  path T': {cfg.input.min_dim}x{cfg.input.max_dim} padded {padded[0]}x{padded[1]}, "
        f"41 + 1 logits; 2 steps in {wall:.3f} s (first-step set-up included), step 2 "
        f"{interval[0]:.4f} s ({smi}), peak device memory {peak_gib:.2f} GiB; every "
        f"semseg-head tensor changed")
    for r in records:
        log(f"  path T' step {r['step']}: " + ", ".join(
            f"{k} {r[k]:.5f}" for k in ("total", "semseg", "fg", "lovasz", "seediness")))
    return {"step2_s": interval[0], "peak_gib": peak_gib}


def loader_clip_ms(n=5):
    """Phase 14: host ms per clip of each of the six loaders as its mode's
    factory builds it (COCO, YouTube-VIS, DAVIS and VOC in ``davis_1``,
    Mapillary in ``kitti_mots_1``, KITTI-MOTS in ``kitti_mots_2``): the
    median of ``n`` clips in this process."""
    import statistics

    import cv2

    from stemseg_tpu_torch.data import SparseDataset, sample_generators
    from stemseg_tpu_torch.training.datasets import create_training_dataset

    for preset in ("davis_1", "kitti_mots_1", "kitti_mots_2"):
        mix = create_training_dataset(training_cfg(preset, 10, mode=None), 20, seed=MAIN_SEED,
                                      print_fn=lambda *a: None)
        for ds in mix.datasets:
            name = type(ds.dataset if isinstance(ds, SparseDataset) else ds).__name__
            ms = []
            for i in range(n):
                t0 = time.perf_counter()
                sample = ds.get(i % len(ds), *sample_generators(MAIN_SEED, i))
                ms.append((time.perf_counter() - t0) * 1e3)
            log(f"  per clip, {preset} {name}: {statistics.median(ms):.3f} ms (median of {n}; "
                f"min {min(ms):.3f}, max {max(ms):.3f}); frames of {sample['orig_dims']} "
                f"-> {sample['images'].shape}, {sample['masks'].shape[0]} instances; cv2 on "
                f"{cv2.getNumThreads()} threads")


def worker_clip_ms():
    """Phase 14: the loader's rate in each mode: each preset's mix through a
    DataLoader of TRAIN_WORKERS workers, one clip a batch, collated and
    pinned as in the trainer; the wait for the first batch (worker start-up)
    and the seconds a clip after it."""
    from functools import partial

    from torch.utils.data import DataLoader

    from stemseg_tpu_torch.config import resolve_max_instances
    from stemseg_tpu_torch.training.datasets import create_training_dataset
    from stemseg_tpu_torch.training.loader import collate_batch

    # kitti_mots_1 (Mapillary, about 1 s a clip) takes fewer clips
    for preset, n_clips in (("davis_1", 20), ("youtube_vis", 12), ("kitti_mots_1", 8),
                            ("kitti_mots_2", 12)):
        cfg = training_cfg(preset, n_clips // 2, mode=None)
        mix = create_training_dataset(cfg, n_clips, seed=MAIN_SEED, print_fn=lambda *a: None)
        loader = DataLoader(mix, batch_sampler=[[i] for i in range(n_clips)],
                            collate_fn=partial(collate_batch,
                                               max_instances=resolve_max_instances(cfg)),
                            num_workers=TRAIN_WORKERS, pin_memory=True, timeout=300)
        t0 = time.perf_counter()
        stamps = [time.perf_counter() - t0 for _ in loader]
        per_clip = (stamps[-1] - stamps[0]) / (n_clips - 1)
        log(f"  {TRAIN_WORKERS} workers, {preset}: first batch after {stamps[0]:.3f} s, then "
            f"{per_clip * 1e3:.3f} ms a clip ({1 / per_clip:.3f} clips/s) over {n_clips - 1} clips")


def construction_seconds():
    """Phase 14: ``create_training_dataset`` at ``davis_1``'s own length
    (50,000 steps of 2 clips)."""
    from stemseg_tpu_torch.config import load_preset
    from stemseg_tpu_torch.data import SparseDataset
    from stemseg_tpu_torch.training.datasets import create_training_dataset
    from stemseg_tpu_torch.training.main import INIT_SEED

    cfg = load_preset("davis_1")
    total = cfg.training.max_iterations * cfg.training.batch_size
    t0 = time.perf_counter()
    mix = create_training_dataset(cfg, total, seed=INIT_SEED, print_fn=lambda *a: None)
    seconds = time.perf_counter() - t0
    sizes = [(type(d.dataset if isinstance(d, SparseDataset) else d).__name__, len(d))
             for d in mix.datasets]
    log(f"  construction at {cfg.training.max_iterations} steps ({total} clips): {seconds:.3f} s; "
        f"{sizes}")


def real_training_path(tag, preset, steps, out_root, smi):
    """Phases 14 and 15: the trainer in the preset's own mode on the written
    datasets, ``steps`` optimizer steps; losses finite, every trainable
    tensor changed and no frozen one, checkpoints written, batches from at
    least two of the mix's datasets where it has two. Returns the trainer."""
    import torch

    from stemseg_tpu_torch.data import SparseDataset

    cfg = training_cfg(preset, steps, mode=None)
    assert_full_width(tag, cfg)
    model_dir = os.path.join(out_root, "R" + str(len(tag)))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = new_trainer(cfg, model_dir, "--save_interval", "2")
    init = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
    trainer.start()
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    keys = ("total", "lovasz", "var_smoothness", "seediness", "grad_norm") + (
        ("semseg",) if cfg.model.use_semseg_head else ())
    records = read_metrics(model_dir, keys)
    stale, moved = changed_params(trainer.model, init)
    n_frozen = sum(not p.requires_grad for p in trainer.model.parameters())
    if [r["step"] for r in records] != list(range(1, steps + 1)) or stale or moved \
            or not n_frozen:
        raise AssertionError(f"path {tag}: steps {[r['step'] for r in records]}, unchanged "
                             f"trainable {stale[:3]}, changed frozen {moved[:3]}")
    ckpts = sorted(f for f in os.listdir(model_dir) if f.endswith(".pth"))
    if ckpts != [f"{i:06d}.pth" for i in range(2, steps + 1, 2)]:
        raise AssertionError(f"path {tag}: checkpoints {ckpts}")
    loader = trainer.make_loader(0)
    loader.batch_sampler.start_iter = 0  # the run's whole stream, not its rest
    mix = loader.dataset
    names = [type(d.dataset if isinstance(d, SparseDataset) else d).__name__
             for d in mix.datasets]
    used = [names[mix.id_mapping[i][0]] for batch in loader.batch_sampler for i in batch]
    if len(set(used)) < min(2, len(names)):
        raise AssertionError(f"path {tag}: batches from {used} only")

    waits = trainer.loader_waits
    intervals = steady_intervals(trainer, 0)
    acc = trainer.accumulate_steps
    log(f"  path {tag}: {preset} ({cfg.training.mode} mode), {steps} steps of {acc} clips in "
        f"{wall:.3f} s (build, dataset and first-step set-up included), peak device memory "
        f"{peak_gib:.2f} GiB; {n_frozen} frozen tensors unchanged, all "
        f"{sum(p.requires_grad for p in trainer.model.parameters())} trainable changed; "
        f"checkpoints {ckpts}")
    log(f"  path {tag}: clips from {used}")
    for r in records:
        log(f"  path {tag} step {r['step']}: " + ", ".join(f"{k} {r[k]:.5f}" for k in keys))
    for k, interval in enumerate(intervals, start=2):
        log(f"  path {tag} step {k}: {interval:.4f} s in the trainer ({smi}; after a checkpoint "
            f"save: {(k - 1) % 2 == 0})")
    log(f"  path {tag}: loader wait, first batch {waits[0]:.3f} s, then "
        f"{sum(waits[1:]) / max(len(waits) - 1, 1) * 1e3:.3f} ms mean, "
        f"{max(waits[1:], default=0.0) * 1e3:.3f} ms max over {len(waits) - 1} batches")
    time_h2d(f"path {tag}", trainer, next(iter(loader)), smi)
    return trainer


def train_then_infer_cli(trainer, out_root):
    """Path R's checkpoint through the inference CLI (``main``, ``--dataset
    davis``) on the written ``davis_val.json``: every window through the
    clustering kernel its dispatch picks, a PNG a frame; then the first
    window's kernel output held against the plain version. Returns the
    CLI's launch counts (the kernel's and ``lsa_masked``'s from the
    profiler) and (the kernel, its ms on the first window)."""
    import cv2
    import numpy as np

    from stemseg_tpu_torch.data.parsers import parse_generic_video_dataset
    from stemseg_tpu_torch.data.paths import DavisUnsupervisedPaths
    from stemseg_tpu_torch.inference import main as cli
    from stemseg_tpu_torch.inference.windows import get_subsequence_frames
    from stemseg_tpu_torch.ops import launch_counts, reset_launch_counts
    from stemseg_tpu_torch.ops.cluster import single_block_supported
    from stemseg_tpu_torch.structures.geometry import pad_to_multiple
    from stemseg_tpu_torch.training.checkpoint import find_latest_checkpoint

    ckpt = find_latest_checkpoint(trainer.model_dir)
    out_dir = os.path.join(out_root, "R_infer")
    (seq,), _ = parse_generic_video_dataset(DavisUnsupervisedPaths.trainval_base_dir(),
                                            DavisUnsupervisedPaths.val_vds_file())
    frames = np.stack([cv2.imread(p, cv2.IMREAD_COLOR) for p in seq.frame_paths()])
    cfg = cli.load_inference_cfg(ckpt, "davis", None, None, 0.05)
    n_windows = len(get_subsequence_frames(len(frames), cfg.input.num_frames,
                                           cfg.data.davis.inference_frame_overlap))

    def run_cli():
        reset_launch_counts()
        cli.main([ckpt, "-o", out_dir, "--dataset", "davis", "-msp", "0.05"])

    # the CLI takes the fused path: its windows replay from CUDA graphs, so
    # the profiler counts the launches
    t0 = time.perf_counter()
    device = profiled_launches(run_cli, lambda: {"cluster_kernel": n_windows,
                                                 "lsa_kernel": n_windows}, "R train -> infer")
    wall = time.perf_counter() - t0
    host = dict(launch_counts)

    tg = make_track_generator(cfg, "davis", cli.load_model(cfg, ckpt, device="cuda"),
                              os.path.join(out_root, "R_infer_check"))
    h, w = pad_to_multiple(*resize_hw(cfg, frames))
    n_points = h // 4 * w // 4 * cfg.input.num_frames
    kernel = ("cluster_points_single" if single_block_supported(
        n_points, cfg.clustering.max_instances, cfg.model.embeddings.embedding_size)
        else "cluster_points_tiled")
    other = ({"cluster_points_single", "cluster_points_tiled"} - {kernel}).pop()
    # on the host: one launch a window, eager or replayed
    expect = fused_first_run_launches(n_windows)
    if host[kernel] != expect or host[other] or host["cluster_points_reference"]:
        raise AssertionError(f"R train -> infer: host launches {host}, expected {expect} "
                             f"of {kernel} (fused path, {n_windows} windows)")
    launches = dict(host, **{kernel: device["cluster_kernel"], "lsa_masked": device["lsa_kernel"]})
    written = check_outputs("R", tg, out_dir, seq.id, frames)
    log(f"  train -> infer (R): {os.path.basename(ckpt)} + config.yaml through the inference "
        f"CLI (fused path) on davis_val.json ({len(frames)} frames of {frames.shape[1]}x"
        f"{frames.shape[2]}): {n_windows} windows through {kernel}, {written}, wall "
        f"{wall:.3f} s under torch.profiler; device launches {device} (profiler), host "
        f"{host} (first window eager, second captured, the rest replayed)")
    window_ms, kernel_ms, shape = window_cluster_ms(tg, frames)
    if shape[0] != n_points:
        raise AssertionError(f"R train -> infer: first window of {tuple(shape)}, expected "
                             f"{n_points} points")
    log(f"  train -> infer (R): {kernel} on the first window's inputs {tuple(shape)}: "
        f"{kernel_ms:.4f} ms; the window's whole clustering step {window_ms:.4f} ms")
    return launches, (kernel, kernel_ms)


def real_data_phases(out_root, smi):
    """Phases 14 and 15 on datasets written to ``out_root``; returns path
    R's train -> infer launch counts and (kernel, ms on its first window)."""
    import torch

    log("== phase 14: training path R (davis_1 in davis mode: COCO + YT-VIS + DAVIS + VOC)")
    t_phase = time.perf_counter()
    env = write_training_datasets(os.path.join(out_root, "datasets"))
    os.environ.update(env)
    mb = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
             os.walk(os.path.join(out_root, "datasets")) for f in fs) / 1e6
    log(f"  six datasets written in {time.perf_counter() - t_phase:.1f} s, {mb:.1f} MB")
    loader_clip_ms()
    worker_clip_ms()
    construction_seconds()
    trainer = real_training_path("R", "davis_1", 4, out_root, smi)
    launches, real = train_then_infer_cli(trainer, out_root)
    del trainer
    torch.cuda.empty_cache()
    log(f"  phase 14: {time.perf_counter() - t_phase:.1f} s")
    log("== phase 15: training paths R' (youtube_vis) and R'' (kitti_mots_2) in their own modes")
    t_phase = time.perf_counter()
    # youtube_vis takes 4 steps: at 4 clips VOC's quota (0.1) rounds to 0
    for tag, preset, steps in (("R'", "youtube_vis", 4), ("R''", "kitti_mots_2", 2)):
        trainer = real_training_path(tag, preset, steps, out_root, smi)
        del trainer
        torch.cuda.empty_cache()
    log(f"  phase 15: {time.perf_counter() - t_phase:.1f} s")
    return launches, real


def check_train_step_gpu_vs_cpu():
    """Phase 13: one micro-step of the same weights and batch on both
    devices, DAVIS- and YT-VIS-shaped."""
    import copy

    import numpy as np
    import torch

    from stemseg_tpu_torch.config import load_config, resolve_max_instances
    from stemseg_tpu_torch.data.collate import collate_fn
    from stemseg_tpu_torch.data.synthetic import SyntheticBlobDataset
    from stemseg_tpu_torch.models import build_model, init_random_weights
    from stemseg_tpu_torch.training.optim import make_optimizer, trainable_parameters
    from stemseg_tpu_torch.training.step import TrainStep

    semseg = copy.deepcopy(SMALL_TRAIN)
    semseg["input"]["num_classes"] = 4
    semseg["model"].update(use_seediness_head=False, use_semseg_head=True,
                           semseg={"inter_channels": [32, 32, 24, 24], "gn_num_groups": 8})
    for tag, over in (("davis", SMALL_TRAIN), ("ytvis", semseg)):
        cfg = load_config(over)
        sample = SyntheticBlobDataset(cfg.input, 2, max_instances=3, seed=2)[1]
        sample["category_ids"] = np.arange(1, len(sample["category_ids"]) + 1, dtype=np.int32)
        host = collate_fn([sample], resolve_max_instances(cfg))
        results = {}
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, device=dev, for_training=True)
            init_random_weights(model, 3)
            step = TrainStep(model, cfg, *make_optimizer(cfg.training,
                                                         trainable_parameters(model)),
                             accumulate_steps=2)
            batch = {k: torch.from_numpy(host[k]).to(dev)
                     for k in ("images", "masks", "ignore_masks", "category_ids")}
            metrics = {k: float(v) for k, v in step(batch).items()}
            results[dev] = (metrics, {n: p.grad.double().cpu() for n, p in
                                      model.named_parameters() if p.requires_grad})
        (m_cpu, g_cpu), (m_gpu, g_gpu) = results["cpu"], results["cuda"]
        loss_err = max(abs(m_gpu[k] - v) / abs(v) if v else abs(m_gpu[k]) for k, v in m_cpu.items())
        grad_err = max(float((g_gpu[n] - g).norm() / g.norm().clamp(min=1e-30))
                       for n, g in g_cpu.items())
        log(f"  micro-step {tag}: GPU vs CPU, loss terms max relative error {loss_err:.3g} "
            f"({', '.join(f'{k} {v:.5f}' for k, v in m_cpu.items())}), gradients max per-leaf "
            f"relative L2 {grad_err:.3g} over {len(g_cpu)} tensors")
        if not loss_err <= 1e-4 or not grad_err <= 1e-3:
            raise AssertionError(f"micro-step {tag}: loss error {loss_err}, grad error {grad_err}")


def matched_label_agreement(a, b):
    """Share of the pixels of two label volumes that agree after the
    one-to-one matching of ``a``'s track ids to ``b``'s that maximises the
    agreement (the outlier label -1 matches only itself)."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    ids_a, ia = np.unique(a, return_inverse=True)
    ids_b, ib = np.unique(b, return_inverse=True)
    overlap = np.bincount(ia.ravel() * len(ids_b) + ib.ravel(),
                          minlength=len(ids_a) * len(ids_b)).reshape(len(ids_a), len(ids_b))
    overlap[(ids_a[:, None] < 0) != (ids_b[None, :] < 0)] = 0
    rows, cols = linear_sum_assignment(-overlap)
    return float(overlap[rows, cols].sum() / a.size)


def keep_fg_masks(tg):
    """Has ``tg`` keep the fg masks of each sequence it runs (on the host)."""
    seen = []
    inner = tg.do_inference

    def do_inference(frames, image_hw):
        out = inner(frames, image_hw)
        seen.append(out["fg_masks"].cpu().numpy())
        return out

    tg.do_inference = do_inference
    return seen


def set_tf32(on):
    import torch

    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on


def bf16_path(tag, preset, dataset, frames, seq_id, n_windows, expect_shape, out_root, smi,
              tf32_reading=False):
    """Phase 16: one path at full width in float32, then with ``--bf16`` (a
    model built with ``dtype=torch.bfloat16`` on the same weights) through
    ``TrackGenerator`` into the writer: every window through
    ``cluster_points_tiled``, the writer's files checked, the first bf16
    window's kernel output held against the plain version; the fg-mask and
    label agreement of bf16 with float32, each run's peak memory, the steady
    fps reports, the bf16 layer split and a profiled bf16 run. With
    ``tf32_reading`` the float32 model also runs steady with TF32 on (set
    after the engine and the writer are built, off again after), with its
    layer split. Returns the bf16 run's launch counts and numbers."""
    import torch

    from stemseg_tpu_torch.config import load_preset, merge
    from stemseg_tpu_torch.models import build_model

    cfg = merge(load_preset(preset), {"clustering": {"min_seediness_prob": 0.05}})
    model = build_random_model(cfg, frames, MAIN_SEED)
    runs = {}
    for name in ("fp32", "bf16"):
        if name == "bf16":
            weights = model.state_dict()
            model = build_model(cfg, dtype=torch.bfloat16)
            model.load_state_dict(weights)
            del weights
            torch.cuda.empty_cache()
        out_dir = os.path.join(out_root, f"{tag}_{name}")
        tg = make_track_generator(cfg, dataset, model, out_dir)
        fg = keep_fg_masks(tg)
        torch.cuda.reset_peak_memory_stats()
        labels, counts, metas, launches = run_main_path(tg, frames, seq_id)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if launches["cluster_points_tiled"] != n_windows or launches["cluster_points_single"] \
                or launches["cluster_points_reference"]:
            raise AssertionError(f"path {tag} {name}: launches {launches}, expected "
                                 f"{n_windows} of cluster_points_tiled")
        if tuple(labels.shape) != expect_shape or len(counts) < 2:
            raise AssertionError(f"path {tag} {name}: labels {tuple(labels.shape)}, "
                                 f"{len(counts) - 1} tracks")
        written = check_outputs(f"{tag} {name}", tg, out_dir, seq_id, frames)
        runs[name] = {"fg": fg[0], "labels": labels.cpu().numpy() if torch.is_tensor(labels)
                      else labels, "launches": launches, "peak_gib": peak_gib}
        log(f"  path {tag} {name}: {len(metas)} windows, clusters per window "
            f"{[int(m.valid.sum()) for m in metas]}, {len(counts) - 1} tracks, {written}, peak "
            f"device memory {peak_gib:.2f} GiB; launches {launches}")
        for line in tg.fps_report():
            log(f"  path {tag} {name} (first run): {line}")
        steady = make_track_generator(cfg, dataset, model, out_dir + "_steady")
        run_main_path(steady, frames, seq_id)
        runs[name]["fps"] = steady.fps_report()
        for line in runs[name]["fps"]:
            log(f"  path {tag} {name} steady ({smi}): {line}")
        if name == "fp32" and tf32_reading:
            # the first run picks cuDNN's TF32 engines; each run needs its own
            # TrackGenerator, whose frame count the fps report divides
            warm = make_track_generator(cfg, dataset, model, out_dir + "_tf32_warm")
            tf32 = make_track_generator(cfg, dataset, model, out_dir + "_tf32")
            set_tf32(True)
            try:
                run_main_path(warm, frames, seq_id)
                run_main_path(tf32, frames, seq_id)
                if not (torch.backends.cudnn.allow_tf32
                        and torch.backends.cuda.matmul.allow_tf32):
                    raise AssertionError(f"path {tag}: TF32 was switched off during the run")
                runs["fp32"]["tf32_fps"] = tf32.fps_report()
                for line in runs["fp32"]["tf32_fps"]:
                    log(f"  path {tag} fp32 + TF32 steady ({smi}): {line}")
                layer_split(f"{tag} fp32+TF32", tf32, frames, n_windows)
            finally:
                set_tf32(False)
            del warm, tf32
    window_ms, kernel_ms, shape = window_cluster_ms(steady, frames)
    log(f"  path {tag} bf16: cluster_points_tiled on the first window's inputs {tuple(shape)} "
        f"(float32, from the bf16 heads): {kernel_ms:.4f} ms")
    parts = layer_split(f"{tag} bf16", steady, frames, n_windows, kernel_ms, window_ms)
    device_profile(steady, frames, f"{tag} bf16")
    fp32, bf16 = runs["fp32"], runs["bf16"]
    fg_agree = float((fp32["fg"] == bf16["fg"]).mean())
    raw = float((fp32["labels"] == bf16["labels"]).mean())
    matched = matched_label_agreement(bf16["labels"], fp32["labels"])
    log(f"  path {tag}: bf16 against fp32 on the same weights: fg masks agree on {fg_agree:.6f} "
        f"of {fp32['fg'].size} pixels (fg share {fp32['fg'].mean():.3f} / "
        f"{bf16['fg'].mean():.3f}), labels on {raw:.6f} ({matched:.6f} with the track ids "
        f"matched one to one)")
    if fg_agree < BF16_MIN_FG_AGREEMENT:
        raise AssertionError(f"path {tag}: bf16 fg masks agree with fp32 on {fg_agree}")
    del model, steady
    torch.cuda.empty_cache()
    return bf16["launches"], {"fg_agreement": fg_agree, "label_agreement": raw,
                              "matched_label_agreement": matched, "layer_split_ms": parts,
                              "kernel_ms_real_window": kernel_ms}


def train_path_t_bf16(out_root, smi, frames):
    """Phase 17: path T with ``training.mixed_precision`` for 4 steps: every
    loss finite, every trainable tensor changed and float32, the frozen ones
    unchanged; step time, micro-step split and profile, peak memory, and the
    first step's losses against float32 path T's from the same seed (phase
    11, its ``metrics.jsonl``); then train -> infer with the model in bf16.
    Returns the launch counts and (kernel, ms on the first window)."""
    import torch

    from stemseg_tpu_torch.config import merge

    cfg = merge(training_cfg("davis_1", 4), {"training": {"mixed_precision": True}})
    assert_full_width("T", cfg)
    model_dir = os.path.join(out_root, "T_bf16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = new_trainer(cfg, model_dir, "--save_interval", "2")
    if trainer.model.compute_dtype != torch.bfloat16:
        raise AssertionError(f"path T bf16: the model computes in {trainer.model.compute_dtype}")
    init = {k: v.detach().clone() for k, v in trainer.model.named_parameters()}
    trainer.start()
    wall = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    keys = ("total", "lovasz", "var_smoothness", "seediness", "total_embedding", "grad_norm")
    records = read_metrics(model_dir, keys)
    stale, moved = changed_params(trainer.model, init)
    dtypes = {p.dtype for p in trainer.model.parameters()}
    if [r["step"] for r in records] != [1, 2, 3, 4] or stale or moved or \
            dtypes != {torch.float32}:
        raise AssertionError(f"path T bf16: steps {[r['step'] for r in records]}, unchanged "
                             f"trainable {stale[:3]}, changed frozen {moved[:3]}, {dtypes}")
    fp32_first = read_metrics(os.path.join(out_root, "T"), keys)[0]
    log(f"  path T bf16: 4 steps in {wall:.3f} s (build and first-step set-up included), peak "
        f"device memory {peak_gib:.2f} GiB; every trainable tensor changed and float32, the "
        f"frozen ones unchanged; step intervals "
        f"{['%.4f' % s for s in steady_intervals(trainer, 0)]} s")
    log("  path T bf16 step 1 against fp32 step 1 (same seed and batches): " + ", ".join(
        f"{k} {records[0][k]:.5f} / {fp32_first[k]:.5f} "
        f"({(records[0][k] - fp32_first[k]) / abs(fp32_first[k]):+.2e})" for k in keys))
    training_timings("path T bf16", trainer, smi)
    launches, real = train_then_infer(trainer, frames, out_root, dtype=torch.bfloat16,
                                      tag="T_bf16")
    del trainer, init
    torch.cuda.empty_cache()
    return launches, real


def jax_variables_from_state_dict(sd):
    """The JAX package's ``{'params', 'constants'}`` tree (numpy leaves) of a
    state dict of the port's model: the inverse of
    ``models.weights.state_dict_from_jax`` (conv kernels ``[O, I, (T,) H, W]``
    -> ``[(T,) H, W, I, O]`` under ``.../conv/kernel``, GroupNorm affines
    under ``.../gn/scale|bias``, FrozenBN statistics and ``time_scale`` in
    ``constants``)."""
    params, constants = {}, {}

    def put(tree, path, value):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = value

    def kernel(w):
        return w.transpose((2, 3, 1, 0) if w.ndim == 4 else (2, 3, 4, 1, 0)).copy()

    def conv(tree_path, leaf, v):
        put(params, tree_path + ("conv", "kernel" if leaf == "weight" else leaf),
            kernel(v) if leaf == "weight" else v)

    for key, t in sd.items():
        v = t.detach().cpu().numpy()
        parts = key.split(".")
        leaf = parts[-1]
        if parts[0] == "backbone" and parts[1] == "fpn":
            conv(("fpn", parts[2]), leaf, v)
        elif parts[0] == "backbone" and parts[2] == "stem":
            if parts[3].startswith("conv"):
                conv(("body", "stem", parts[3]), leaf, v)
            else:
                put(constants, ("body", "stem", parts[3], leaf), v)
        elif parts[0] == "backbone":
            block, mod = f"{parts[2]}_{parts[3]}", parts[4]
            if mod == "downsample":
                mod = {"0": "downsample_conv", "1": "downsample_bn"}[parts[5]]
            if "conv" in mod:
                conv(("body", block, mod), leaf, v)
            else:
                put(constants, ("body", block, mod, leaf), v)
        elif leaf == "time_scale":
            put(constants, tuple(parts), v)
        elif parts[1].startswith("block_"):
            slot, norm = divmod(int(parts[2]), 4)
            name = f"{parts[1]}_{'norm' if norm else 'conv'}{slot}"
            if norm:
                put(params, (parts[0], "trunk", name, "gn",
                             "scale" if leaf == "weight" else leaf), v)
            else:
                conv((parts[0], "trunk", name), leaf, v)
        elif parts[1] in ("conv_16", "conv_8", "conv_4"):
            conv((parts[0], "trunk", parts[1]), leaf, v)
        else:
            conv((parts[0], parts[1]), leaf, v)
    return {"params": params, "constants": constants}


def msgpack_pack(obj):
    """msgpack bytes of ``obj`` as flax's ``msgpack_serialize`` writes them
    (maps, lists, str, bytes, int, float, bool, None; numpy arrays as ext 1
    ``(shape, dtype name, C-order bytes)``, numpy scalars as ext 3), so
    that this script writes a JAX package ``.ckpt`` without flax or
    msgpack."""
    import struct

    import numpy as np

    out = bytearray()

    def header(n, fix, fix_max, codes):
        if fix is not None and n <= fix_max:
            out.append(fix | n)
            return
        for code, fmt in codes:
            if n < 256 ** struct.calcsize(fmt):
                out.append(code)
                out.extend(struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack: {n} is too long")

    def ext(code, data):
        header(len(data), None, 0, ((0xc7, ">B"), (0xc8, ">H"), (0xc9, ">I")))
        out.extend(struct.pack(">b", code))
        out.extend(data)

    def put(o):
        if o is None or isinstance(o, bool):
            out.append({None: 0xc0, False: 0xc2, True: 0xc3}[o])
        elif isinstance(o, int):
            out.extend(b"\xd3" + struct.pack(">q", o) if o < 0 else b"\xcf" + struct.pack(">Q", o))
        elif isinstance(o, float):
            out.extend(b"\xcb" + struct.pack(">d", o))
        elif isinstance(o, str):
            data = o.encode("utf-8")
            header(len(data), 0xa0, 31, ((0xd9, ">B"), (0xda, ">H"), (0xdb, ">I")))
            out.extend(data)
        elif isinstance(o, bytes):
            header(len(o), None, 0, ((0xc4, ">B"), (0xc5, ">H"), (0xc6, ">I")))
            out.extend(o)
        elif isinstance(o, dict):
            header(len(o), 0x80, 15, ((0xde, ">H"), (0xdf, ">I")))
            for k, v in o.items():
                put(k)
                put(v)
        elif isinstance(o, (list, tuple)):
            header(len(o), 0x90, 15, ((0xdc, ">H"), (0xdd, ">I")))
            for v in o:
                put(v)
        elif isinstance(o, (np.ndarray, np.generic)):
            a = np.asarray(o)
            ext(1 if isinstance(o, np.ndarray) else 3,
                msgpack_pack([list(a.shape), a.dtype.name, a.tobytes(order="C")]))
        else:
            raise TypeError(f"msgpack: cannot pack {type(o).__name__}")

    put(obj)
    return bytes(out)


def write_jax_session(pth, step, ckpt_path, cfg=None):
    """The port trainer's ``pth`` as a JAX trainer's session file:
    ``{"state": {"step", "params", "constants", "opt_state"}, "extra",
    "step"}``. Without ``cfg`` the optimizer state is ``optax.MultiSteps``'s
    top level alone (zero accumulated gradients, no inner state): a file for
    the weights. With ``cfg`` (an SGD config) it is the whole session, the
    inverse of ``training/optax_state.py``: the momentum buffers as the
    ``trace`` of the ``multi_transform`` chain (frozen leaves empty), the
    LR schedule's ``last_epoch`` as its ``count``, under ``MultiSteps`` when
    the config accumulates; the logger state is carried in ``extra``.
    Raises unless the port's ``state_dict_from_jax`` maps the tree back to
    the same tensors."""
    import numpy as np
    import torch

    from stemseg_tpu_torch.models import state_dict_from_jax

    ckpt = torch.load(pth, map_location="cpu", weights_only=True)
    sd = ckpt["model"]
    variables = jax_variables_from_state_dict(sd)
    back = state_dict_from_jax(variables)
    if back.keys() != sd.keys() or not all(torch.equal(back[k], sd[k].float()) for k in sd):
        raise AssertionError("the JAX tree of the checkpoint does not map back to its weights")

    def zeros(tree):
        return {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)
                for k, v in tree.items()}

    def masked(tree, frozen):
        return {k: masked(v, frozen.get(k, {})) if isinstance(v, dict)
                else ({} if k in frozen else v) for k, v in tree.items()}

    accumulate, inner, extra = 2, {}, {"logger": {}}
    if cfg is not None:
        from stemseg_tpu_torch.models import build_model

        if cfg.training.optimizer.lower() != "sgd":
            raise NotImplementedError("a whole session is written for SGD configs")
        model = build_model(cfg, device="meta", for_training=True)
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
        opt = ckpt["optimizer"]
        buffers = {names[i]: opt["state"][i]["momentum_buffer"] if i in opt["state"]
                   else torch.zeros_like(sd[names[i]]) for i in opt["param_groups"][0]["params"]}
        trace = masked(jax_variables_from_state_dict(
            {**buffers, **{n: torch.zeros_like(sd[n]) for n in frozen}})["params"],
            jax_variables_from_state_dict({n: sd[n] for n in frozen})["params"])
        chain = {"0": {}, "1": {"trace": trace},
                 "2": {"count": np.asarray(ckpt["scheduler"]["last_epoch"], np.int32)}}
        if cfg.training.clip_gradients:
            chain = {"0": {}, "1": chain}
        inner = {"inner_states": {"frozen": {"inner_state": {}},
                                  "trainable": {"inner_state": chain}}}
        accumulate = max(1, round(cfg.training.batch_size / cfg.training.max_samples_per_chip))
        extra = ckpt.get("extra") or extra
    opt_state = inner if accumulate == 1 else {
        "mini_step": np.asarray(0, np.int32), "gradient_step": np.asarray(step, np.int32),
        "inner_opt_state": inner, "acc_grads": zeros(variables["params"]), "skip_state": {}}
    # a JAX TrainState counts micro-steps (the weights-only file keeps its step)
    state = {"step": np.asarray(step * accumulate if cfg is not None else step, np.int32),
             **variables,
             "opt_state": opt_state}
    data = msgpack_pack({"state": state, "extra": extra, "step": int(step)})
    with open(ckpt_path, "wb") as fh:
        fh.write(data)
    return len(data)


def cli_rest_phase(out_root, smi):
    """Phase 18: path T's last checkpoint, written as a JAX trainer's
    ``.ckpt`` (``write_jax_session``) beside its ``config.yaml``, through the
    inference CLI's ``main`` (``--dataset davis`` on phase 14's
    ``davis_val.json``) with ``--profile_clustering --save_vis --profile``,
    and its ``.pth`` through ``main`` with no flag: equal labels, every
    window through the clustering kernel the dispatch picks in both, the
    clustering report's bucket, a JPEG a frame, a chrome trace with the
    device's kernels. Returns the ``.ckpt`` run's launch counts (host) and
    the ``.pth`` run's (the profiler's: the fused path replays graphs)."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch

    from stemseg_tpu_torch.inference import main as cli
    from stemseg_tpu_torch.inference.windows import get_subsequence_frames
    from stemseg_tpu_torch.ops import launch_counts, reset_launch_counts
    from stemseg_tpu_torch.training.checkpoint import find_latest_checkpoint

    pth = find_latest_checkpoint(os.path.join(out_root, "T"))
    step = int(os.path.basename(pth).split(".")[0])
    ckpt_dir = os.path.join(out_root, "T_jax")
    os.makedirs(ckpt_dir)
    shutil.copy(os.path.join(out_root, "T", "config.yaml"), ckpt_dir)
    ckpt = os.path.join(ckpt_dir, f"{step:06d}.ckpt")
    t0 = time.perf_counter()
    n_bytes = write_jax_session(pth, step, ckpt)
    log(f"  {os.path.basename(pth)} as a JAX session {ckpt}: {n_bytes / 1e6:.1f} MB in "
        f"{time.perf_counter() - t0:.3f} s; its tree maps back to the same weights")

    inner = cli.TrackGenerator._process_loaded
    runs = {}
    for kind, path, flags in (("pth", pth, []),
                              ("ckpt", ckpt, ["--profile_clustering", "--save_vis", "--profile",
                                              os.path.join(out_root, "trace")])):
        seen = {}

        def process_loaded(self, sequence, frames, image_hw, max_tracks, _seen=seen):
            result = inner(self, sequence, frames, image_hw, max_tracks)
            _seen["labels"] = np.asarray(result[0].cpu() if torch.is_tensor(result[0])
                                         else result[0])
            _seen["n_windows"] = len(get_subsequence_frames(
                len(frames), self.cfg.input.num_frames, self.frame_overlap))
            _seen["n_frames"], _seen["fused"] = len(frames), result[3] is None
            return result

        cli.TrackGenerator._process_loaded = process_loaded
        out_dir = os.path.join(out_root, "cli_" + kind)
        printed = io.StringIO()

        def run_cli(_argv=[path, "-o", out_dir, "--dataset", "davis", "-msp", "0.05", *flags],
                    _printed=printed):
            reset_launch_counts()
            _printed.seek(0)
            _printed.truncate()
            with contextlib.redirect_stdout(_printed):
                cli.main(_argv)

        t0 = time.perf_counter()
        try:
            if kind == "pth":
                # the fused path replays its windows from CUDA graphs: the
                # profiler counts the launches (the .ckpt run profiles itself)
                seen["device"] = profiled_launches(
                    run_cli, lambda: {"cluster_kernel": seen["n_windows"],
                                      "lsa_kernel": seen["n_windows"]}, "CLI .pth")
            else:
                run_cli()
        finally:
            cli.TrackGenerator._process_loaded = inner
        seen["wall"] = time.perf_counter() - t0
        seen["launches"] = dict(launch_counts)
        seen["printed"] = printed.getvalue().splitlines()
        runs[kind] = seen
        # with no flag the CLI takes the fused path (on the host: one launch
        # a window, eager or replayed), with --profile_clustering the
        # streaming one
        expect = (fused_first_run_launches(seen["n_windows"]) if kind == "pth"
                  else seen["n_windows"])
        tiled = seen["launches"]["cluster_points_tiled"]
        if seen["fused"] != (kind == "pth") or tiled != expect \
                or seen["launches"]["cluster_points_single"] \
                or seen["launches"]["cluster_points_reference"]:
            raise AssertionError(f"CLI {kind}: fused {seen['fused']}, launches "
                                 f"{seen['launches']}, expected {expect} of cluster_points_tiled")
        log(f"  CLI on the .{kind} {' '.join(flags[:3])} ({'fused' if seen['fused'] else 'streaming'}"
            f" path): wall {seen['wall']:.3f} s{' under torch.profiler' if kind == 'pth' else ''}; "
            f"host launches {seen['launches']}"
            + (f", device launches {seen['device']} (profiler)" if kind == "pth" else ""))
        for line in seen["printed"]:
            if "speed" in line or line.startswith("  "):
                log(f"  CLI .{kind} ({smi}): {line}")
    ckpt_run = runs["ckpt"]
    if not np.array_equal(ckpt_run["labels"], runs["pth"]["labels"]):
        raise AssertionError("CLI: the labels from the .ckpt (streaming) differ from the "
                             ".pth's (fused)")
    t_win = cli.load_inference_cfg(ckpt, "davis", None, None, None).input.num_frames
    n_points = ckpt_run["labels"][0].size * t_win
    report = ckpt_run["printed"]
    head = "Clustering durations by point count (points: calls, mean ms):"
    if head not in report or not report[report.index(head) + 1].startswith(
            f"  {n_points:>9d}: {ckpt_run['n_windows']:4d} calls, "):
        raise AssertionError(f"CLI: no clustering report for {n_points} points in {report}")
    vis = sorted(os.listdir(os.path.join(out_root, "cli_ckpt", "vis", "val0")))
    if vis != [f"{t:05d}.jpg" for t in range(ckpt_run["n_frames"])] or \
            os.path.exists(os.path.join(out_root, "cli_pth", "vis")):
        raise AssertionError(f"CLI: --save_vis wrote {vis}")
    trace = os.path.join(out_root, "trace", "trace.json")
    with open(trace) as fh:
        n_kernels = fh.read().count('"cat": "kernel"')
    if not n_kernels:
        raise AssertionError("CLI: the trace holds no device kernel")
    log(f"  CLI: labels of the .ckpt equal to the .pth's ({ckpt_run['labels'].shape}); "
        f"{len(vis)} JPEGs; trace {os.path.getsize(trace) / 1e6:.1f} MB with {n_kernels} "
        f"device kernels")
    device = runs["pth"]["device"]
    return ckpt_run["launches"], {"cluster_points_single": 0,
                                  "cluster_points_tiled": device["cluster_kernel"],
                                  "lsa_masked": device["lsa_kernel"]}


LSA_FUZZ_CASES = 300
LSA_TIMED_SHAPE = (40, 20)  # the association's band x K at K = 20 (paths A-D)


def lsa_fuzz_cases(seed=MAIN_SEED, n=LSA_FUZZ_CASES, dyadic=True):
    """The lsap fuzz set: (cost [R, C] float32, row mask, column mask).
    Costs: heavy integer ties (0..2), quarters, uniform, and IoU-shaped
    (``1 - IoU``, most entries exactly 1); masks kept with probability 0,
    0.3, 0.6 or 1 (empty sides included); every fifth case the association
    shape ``LSA_TIMED_SHAPE`` (IoU costs, rows kept with probability 0.5,
    columns 0.9), every tenth (from the third) an 8-frame
    window's band at DAVIS's overlap, 80 x 20, every twenty-fifth (from the
    tenth) 300 x 20 or 20 x 300, the others tall, wide or square up to 64.
    With ``dyadic`` the uniform and IoU costs are rounded to 1/1024, so
    that the solver's float32 sums of them are exact and scipy's float64
    solve takes the same decisions as float32; without it they keep every
    bit (for the kernel against its plain version, both float32)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cases = []
    for i in range(n):
        r, c = (int(rng.integers(1, 65)), int(rng.integers(1, 65)))
        if i % 5 == 0:
            r, c = LSA_TIMED_SHAPE
        elif i % 10 == 3:
            r, c = 80, 20
        elif i % 25 == 9:
            r, c = (300, 20) if i % 50 == 9 else (20, 300)
        # the timed shape as the association's: IoU costs, most rows and columns kept
        timed = (r, c) == LSA_TIMED_SHAPE
        kind = 3 if timed else i % 4
        if kind == 0:
            cost = rng.integers(0, 3, (r, c)).astype(np.float32)
        elif kind == 1:
            cost = (np.round(rng.random((r, c)) * 4) / 4).astype(np.float32)
        elif kind == 2:
            cost = rng.random((r, c))
        else:
            inter = rng.integers(0, 50, (r, c)) * (rng.random((r, c)) < 0.15)
            n1, n2 = rng.integers(50, 200, r), rng.integers(50, 200, c)
            cost = 1.0 - inter / (n1[:, None] + n2[None, :] - inter)
        cost = (np.round(cost * 1024) / 1024 if dyadic else cost).astype(np.float32)
        keep_r, keep_c = (0.5, 0.9) if timed else (
            (0.0, 0.3, 0.6, 1.0)[i % 4], (1.0, 0.6, 0.3, 0.0)[(i // 4) % 4])
        cases.append((cost, rng.random(r) < keep_r, rng.random(c) < keep_c))
    return cases


def scipy_masked(cost, row_valid, col_valid):
    """scipy's assignment on the compacted matrix, in the original index
    space (-1 where unmatched or invalid), and its host seconds."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    rows, cols = np.where(row_valid)[0], np.where(col_valid)[0]
    c4r = np.full(len(row_valid), -1, np.int32)
    r4c = np.full(len(col_valid), -1, np.int32)
    t0 = time.perf_counter()
    if len(rows) and len(cols):
        rr, cc = linear_sum_assignment(cost[np.ix_(rows, cols)])
    else:
        rr = cc = []
    seconds = time.perf_counter() - t0
    for a, b in zip(rr, cc):
        c4r[rows[a]], r4c[cols[b]] = cols[b], rows[a]
    return c4r, r4c, seconds


def check_lsap():
    """Phase 19: ``lsa_masked`` (the CUDA kernel) against its plain version
    and scipy on the fuzz set, exactly, and against its plain version on
    the set's unrounded twin; at the association shape its device
    time per call (20 calls queued, CUDA events; and the profiler's), its
    host time per call, scipy's host time, the plain version's, and the
    bound. Returns the kernel table's row."""
    import numpy as np
    import torch

    from stemseg_tpu_torch.ops import lsap

    cases = lsa_fuzz_cases()
    scipy_masked(*cases[0])  # scipy's first call loads it
    timed, scipy_s, plain_s, steps = [], [], [], []
    n_empty = n_tall = n_wide = 0
    for i, (cost, rv, cv) in enumerate(cases):
        want_c4r, want_r4c, seconds = scipy_masked(cost, rv, cv)
        cpu = [torch.from_numpy(x) for x in (cost, rv, cv)]
        stats = {}
        t0 = time.perf_counter()
        plain = lsap.lsa_masked_reference(*cpu, stats=stats)
        plain_seconds = time.perf_counter() - t0
        dev = [x.cuda() for x in cpu]
        got = [t.cpu().numpy() for t in lsap.lsa_masked(*dev)]
        for name, (c4r, r4c) in (("plain", [t.numpy() for t in plain]), ("kernel", got)):
            if not (np.array_equal(c4r, want_c4r) and np.array_equal(r4c, want_r4c)):
                raise AssertionError(f"lsa_masked {name}, case {i} {cost.shape} rows "
                                     f"{int(rv.sum())} cols {int(cv.sum())}: differs from scipy")
        n_empty += int(not rv.any() or not cv.any())
        n_tall += int(rv.sum() > cv.sum() > 0)
        n_wide += int(0 < rv.sum() < cv.sum())
        if cost.shape == LSA_TIMED_SHAPE:
            timed.append(dev)
            scipy_s.append(seconds)
            plain_s.append(plain_seconds)
            steps.append((stats.get("steps", 0), max(cost.shape)))
    n_raw = LSA_FUZZ_CASES // 3
    for i, (cost, rv, cv) in enumerate(lsa_fuzz_cases(MAIN_SEED + 1, n_raw, dyadic=False)):
        cpu = [torch.from_numpy(x) for x in (cost, rv, cv)]
        plain = [t.numpy() for t in lsap.lsa_masked_reference(*cpu)]
        got = [t.cpu().numpy() for t in lsap.lsa_masked(*[x.cuda() for x in cpu])]
        if not all(np.array_equal(a, b) for a, b in zip(plain, got)):
            raise AssertionError(f"lsa_masked, unrounded case {i} {cost.shape}: the kernel "
                                 "differs from its plain version")
    log(f"  lsa_masked: {len(cases)} fuzz cases (sides up to 300; {n_empty} with an empty side, "
        f"{n_tall} tall, {n_wide} wide after the masks), kernel and plain version equal to scipy; "
        f"{n_raw} unrounded float cases, kernel equal to its plain version")
    calls = iter(range(10 ** 9))

    def one():
        lsap.lsa_masked(*timed[next(calls) % len(timed)])

    ms = time_cuda(one, 20 * len(timed), queue_first=True)
    per_call = device_kernels(one, len(timed))
    device_ms = sum(m for k, (c, m) in per_call.items() if "lsa_kernel" in k)
    r, c = LSA_TIMED_SHAPE
    n_bytes = r * c * 4 + r + c + 4 * (r + c)
    # each augmenting step touches every column once: add, two subtracts, compare
    n_ops = sum(s * b * 4 for s, b in steps) / len(steps)
    bytes_ms, ops_ms = n_bytes / PEAK_BYTES_PER_S * 1e3, n_ops / PEAK_FP32_OPS_PER_S * 1e3
    row = {"ms": ms, "device_ms": device_ms, "host_ms_per_call": host_ms_per_call(one, 50),
           "plain_ms": sum(plain_s) / len(plain_s) * 1e3,
           "library_ms": sum(scipy_s) / len(scipy_s) * 1e3,
           "bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms
           else "operations", "max_abs_err": 0, "shape": list(LSA_TIMED_SHAPE),
           "steps_per_call": sum(s for s, _ in steps) / len(steps), "fuzz_cases": len(cases)}
    log(f"  lsa_masked at {r}x{c} ({len(timed)} matrices, {row['steps_per_call']:.1f} augmenting "
        f"steps a call): kernel {ms * 1e3:.2f} us (events), device {device_ms * 1e3:.2f} us "
        f"(profiler), host {row['host_ms_per_call'] * 1e3:.2f} us a call; scipy "
        f"{row['library_ms'] * 1e3:.2f} us (host, compacted matrix); plain version "
        f"{row['plain_ms']:.3f} ms (CPU); bound {row['bound_ms'] * 1e3:.5f} us ({row['bound_by']})")
    return row


def check_graph_replays(ops):
    """Phase 19: one CUDA graph holding ``cluster_points_single`` (207,360
    points) and ``cluster_points_tiled`` (878,592), E = 4, K = 20, replayed
    4 times with new inputs copied in between: a window that stops after one
    iteration (every seediness below ``min_seediness``), then one whose 20
    iterations are all active, twice. Each replay's labels and meta are held
    against the plain version (``compare_with_plain``). A nonce passed from
    the host would be the same in every replay, and the second window would
    read the first one's leftover records as its own."""
    import torch

    kw = main_kwargs()
    sizes = {"cluster_points_single": 207_360, "cluster_points_tiled": 878_592}
    inputs = {}
    for name, p in sizes.items():
        full = [torch.from_numpy(x).cuda() for x in mixture_points(p, seed=11, n_clusters=24,
                                                                   noise=0.02)]
        early = [t.clone() for t in full]
        early[2] *= 0.5  # every seediness under min_seediness 0.8
        inputs[name] = {"early": early, "full": full}
    static = {name: [t.clone() for t in v["early"]] for name, v in inputs.items()}
    stream = torch.cuda.Stream()
    ops.prepare_records(stream)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up on the capture stream
        for name in sizes:
            getattr(ops, name)(*static[name], **kw)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        outs = {name: getattr(ops, name)(*static[name], **kw) for name in sizes}
    readings = []
    for kind in ("early", "full", "early", "full"):
        for name in sizes:
            for dst, src in zip(static[name], inputs[name][kind]):
                dst.copy_(src)
        graph.replay()
        for name, (labels, meta) in outs.items():
            n_valid, n_mism, _ = compare_with_plain(ops, f"graph replay {kind} {name}",
                                                    static[name], labels.clone(), meta.clone(),
                                                    kw)
            want = 0 if kind == "early" else 20
            if n_valid != want:
                raise AssertionError(f"graph replay {kind} {name}: {n_valid} clusters, "
                                     f"expected {want}")
            readings.append(f"{kind} {name.split('_')[-1]} {n_valid} clusters, {n_mism} knife")
    per_replay = device_kernels(graph.replay, 5)
    n_cluster = sum(c for k, (c, _) in per_replay.items() if "cluster_kernel" in k)
    if n_cluster != 2:
        raise AssertionError(f"graph replay ran {per_replay}, expected 2 clustering kernels")
    log(f"  one CUDA graph of both clustering kernels, 4 replays: {'; '.join(readings)}; "
        f"meta equal, labels exact but knife-edge points; the profiler sees {n_cluster} "
        "clustering kernels a replay")


def tree_bytes(root):
    """{relative path: bytes} of the files under ``root`` (zip archives left
    out: they stamp the time)."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".zip"):
                with open(os.path.join(d, f), "rb") as fh:
                    out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def keep_outputs(tg):
    """Has ``tg`` keep the fg and multiclass masks of its last sequence (on
    the host) from whichever path it takes."""
    import torch

    seen = {}

    def host(x):
        return None if x is None else (x.cpu().numpy() if torch.is_tensor(x) else x)

    inner_inf, inner_fused = tg.do_inference, tg.do_fused

    def do_inference(frames, image_hw):
        out = inner_inf(frames, image_hw)
        seen.update(fg=host(out["fg_masks"]), mc=host(out["multiclass_masks"]))
        return out

    def do_fused(frames, image_hw):
        out = inner_fused(frames, image_hw)
        seen.update(fg=host(out[3]), mc=host(out[4]))
        return out

    tg.do_inference, tg.do_fused = do_inference, do_fused
    return seen


def profile_run(tg, frames, seq_id, writer=False):
    """One sequence through ``tg`` under torch.profiler: (device busy share
    of the wall, {kernel name: launches}, wall ms). The wall is the CLI's
    timed phases (``do_fused``, or ``do_inference`` + ``do_clustering``);
    with ``writer`` the whole ``_process_loaded``, the writer included."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    seq = Sequence(seq_id, len(frames), frames.shape[1:3])
    hw = frames.shape[1:3]
    for attempt in range(2):  # a session without device events is profiled again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if writer:
                tg._process_loaded(seq, frames, hw, tg.max_tracks)
            elif tg.fused is not None:
                tg.do_fused(frames, hw)
            else:
                tg.do_clustering(tg.do_inference(frames, hw))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy, counts = 0.0, {}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                busy += evt.time_range.elapsed_us()
                counts[evt.name] = counts.get(evt.name, 0) + 1
        if counts:
            return busy / wall_us, counts, wall_us / 1e3
        log(f"  profile {seq_id}: no device event in session {attempt + 1} of 2")
    raise RuntimeError(f"{seq_id}: torch.profiler recorded no device event")


def fused_path(tag, preset, dataset, frames, seq_id, out_root, smi, resize_embeddings=False,
               bf16=False):
    """Phase 19, one path: the same model and frames through the streaming
    and the fused path of ``TrackGenerator``. The fused path's first run
    (its bodies warmed, the ones called twice captured) must launch the
    clustering kernel and the lsap kernel; its second (the rest captured)
    must give the streaming run's labels bit for bit, its fg and multiclass
    masks equal, its writer files byte-equal; a third, from the upload to
    the dispatch's end, runs under ``torch.cuda.set_sync_debug_mode("error")``.
    Then steady overall fps in turns (streaming, fused, fused, streaming),
    and one profiled run of each path: device busy share and the kernels'
    launches. Returns the numbers."""
    import numpy as np
    import torch

    from stemseg_tpu_torch.config import load_preset, merge
    from stemseg_tpu_torch.models import build_model
    from stemseg_tpu_torch.ops import launch_counts, lsap, reset_launch_counts
    from stemseg_tpu_torch.utils.timer import Timer

    cfg = merge(load_preset(preset), {"clustering": {"min_seediness_prob": 0.05}})
    model = build_random_model(cfg, frames, MAIN_SEED)
    if bf16:
        weights = model.state_dict()
        model = build_model(cfg, dtype=torch.bfloat16)
        model.load_state_dict(weights)
        del weights
    tgs = {name: make_track_generator(cfg, dataset, model, os.path.join(out_root, f"{tag}_{name}"),
                                      resize_embeddings, use_fused=name == "fused")
           for name in ("streaming", "fused")}
    kept = {name: keep_outputs(tg) for name, tg in tgs.items()}
    seq = Sequence(seq_id, len(frames), frames.shape[1:3])
    n_windows = len(tgs["fused"]._schedule(len(frames), frames.shape[1:3])[0])

    def one(name, out_dir=None):
        tg = tgs[name]
        if out_dir is not None:
            tg.output_generator = make_writer(dataset, out_dir, resize_embeddings,
                                              device="cuda")
        Timer.reset()
        result = tg._process_loaded(seq, frames, frames.shape[1:3], tg.max_tracks)
        fps = len(frames) / Timer.get_durations_sum()
        if out_dir is not None:
            tg.output_generator.save()
        return result, fps

    reset_launch_counts()
    lsap.reset_launch_counts()
    one("fused")
    first = dict(launch_counts, **lsap.launch_counts)
    expect = fused_first_run_launches(n_windows)
    if first["cluster_points_tiled"] + first["cluster_points_single"] != expect \
            or first["lsa_masked"] != expect or first["cluster_points_reference"] \
            or first["lsa_masked_reference"]:
        raise AssertionError(f"path {tag} fused, first run: launches {first}, expected {expect} "
                             f"of a clustering kernel and of lsa_masked")
    s_res, _ = one("streaming", os.path.join(out_root, f"{tag}_files_streaming"))
    f_res, _ = one("fused", os.path.join(out_root, f"{tag}_files_fused"))
    if s_res[3] is None or f_res[3] is not None:
        raise AssertionError(f"path {tag}: the paths were not the ones asked for")
    labels_equal = np.array_equal(s_res[0], f_res[0])
    fg_equal = np.array_equal(kept["streaming"]["fg"], kept["fused"]["fg"])
    s_mc, f_mc = kept["streaming"]["mc"], kept["fused"]["mc"]
    mc_equal = (s_mc is None and f_mc is None) or np.array_equal(s_mc, f_mc)
    files = [tree_bytes(os.path.join(out_root, f"{tag}_files_{n}")) for n in ("streaming", "fused")]
    files_equal = files[0] == files[1] and len(files[0]) > 0
    agree = float((s_res[0] == f_res[0]).mean())
    log(f"  path {tag}: fused against streaming, labels {tuple(f_res[0].shape)} bit-identical "
        f"{labels_equal} (agreement {agree:.6f}, {len(f_res[1]) - 1} tracks), fg masks equal "
        f"{fg_equal}, multiclass equal {mc_equal}, {len(files[0])} writer files byte-equal "
        f"{files_equal}; fused first run launches {first}")
    if not (labels_equal and fg_equal and mc_equal and files_equal):
        raise AssertionError(f"path {tag}: the fused path differs from the streaming path")

    fused = tgs["fused"]
    windows, resize = fused._schedule(len(frames), frames.shape[1:3])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fused.fused.run(frames, windows, seediness_fg_threshold=fused.seediness_thresh,
                              semseg_output_type=fused.semseg_output_type, resize_hw=resize,
                              device_outputs=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    if not np.array_equal(out[0][:len(frames)].int().cpu().numpy(), s_res[0]):
        raise AssertionError(f"path {tag}: the sync-checked fused run's labels differ")
    log(f"  path {tag}: fused run from upload to dispatch under set_sync_debug_mode('error'): "
        "no host sync")

    fps = {"streaming": [], "fused": []}
    for name in ("streaming", "fused", "fused", "streaming"):
        fps[name].append(one(name)[1])
    log(f"  path {tag} steady overall fps in turns ({smi}): streaming {fps['streaming'][0]:.3f}, "
        f"fused {fps['fused'][0]:.3f}, fused {fps['fused'][1]:.3f}, streaming "
        f"{fps['streaming'][1]:.3f}; fused / streaming "
        f"{sum(fps['fused']) / sum(fps['streaming']):.3f}")
    prof = {}
    for name in ("streaming", "fused"):
        busy, counts, wall_ms = profile_run(tgs[name], frames, seq_id)
        launches = {k: sum(c for n, c in counts.items() if k in n)
                    for k in ("cluster_kernel", "lsa_kernel")}
        prof[name] = {"busy": busy, "launches": launches, "wall_ms": wall_ms}
        log(f"  path {tag} {name} profiled, the CLI's timed phases: wall {wall_ms:.3f} ms, "
            f"device busy {busy:.3f} of the wall; clustering kernels "
            f"{launches['cluster_kernel']}, lsap kernel {launches['lsa_kernel']}; "
            f"{sum(counts.values())} device items")
        if bf16:  # as phase 16 read it: the writer in the wall
            busy_w, _, wall_w = profile_run(tgs[name], frames, seq_id, writer=True)
            prof[name]["busy_with_writer"] = busy_w
            log(f"  path {tag} {name} profiled with the writer: wall {wall_w:.3f} ms, device "
                f"busy {busy_w:.3f} of the wall")
    if prof["fused"]["launches"] != {"cluster_kernel": n_windows, "lsa_kernel": n_windows}:
        raise AssertionError(f"path {tag}: the profiled fused run launched "
                             f"{prof['fused']['launches']}, expected {n_windows} of each")
    del tgs, kept, model, fused, out
    torch.cuda.empty_cache()
    return {"fps": fps, "profile": prof, "windows": n_windows, "first_launches": first}


# DAVIS 2017 val (davischallenge.org, DAVIS-2017-trainval-480p, ImageSets/2017/
# val.txt): its 30 sequences in the dataset's order and their lengths, 1,999
# frames of 480x854
DAVIS17_VAL_LENGTHS = {
    "bike-packing": 69, "blackswan": 50, "bmx-trees": 80, "breakdance": 84, "camel": 90,
    "car-roundabout": 75, "car-shadow": 40, "cows": 104, "dance-twirl": 90, "dog": 60,
    "dogs-jump": 66, "drift-chicane": 52, "drift-straight": 50, "goat": 90, "gold-fish": 78,
    "horsejump-high": 50, "india": 81, "judo": 34, "kite-surf": 50, "lab-coat": 47,
    "libby": 49, "loading": 50, "mbike-trick": 79, "motocross-jump": 40,
    "paragliding-launch": 80, "parkour": 100, "pigs": 79, "scooter-black": 43,
    "shooting": 40, "soapbox": 99}


class NullWriter:
    """A writer that keeps nothing: the dataset pass times the CLI's timed
    phases, which leave the writer out."""

    def process_sequence(self, *args, **kwargs):
        pass


def dataset_pass(smi):
    """Phase 19: one pass of the CLI's ``TrackGenerator`` over DAVIS 2017
    val's sequence lengths in the dataset's order, each sequence once on
    each path, ``davis_2`` in bf16 (the model where host work weighs most)
    on the 480x854 frames of one synthetic sequence (each sequence its first
    ``n``). The paths take turns a sequence, the first of each pair
    alternating, so that both meet the costs of a new batch shape; a
    throwaway streaming run of the shortest length first takes the
    process's own first-use costs. The fused pipeline is fresh: its device
    states, warm-ups and captures are in the pass. Labels of every sequence
    equal on both paths; overall fps of the CLI's timers over the pass, the
    timed seconds of the sequences that made a fused state on each path,
    peak device memory above the pass's start (the fused state stays
    between its runs), and the fused pipeline's states and captures."""
    import hashlib

    import numpy as np
    import torch

    from stemseg_tpu_torch.config import load_preset, merge
    from stemseg_tpu_torch.inference.main import TrackGenerator
    from stemseg_tpu_torch.models import build_model
    from stemseg_tpu_torch.utils.timer import Timer

    cfg = merge(load_preset("davis_2"), {"clustering": {"min_seediness_prob": 0.05}})
    pool = synthetic_frames(max(DAVIS17_VAL_LENGTHS.values()), 480, 854, seed=MAIN_SEED)
    weights = build_random_model(cfg, pool, MAIN_SEED).state_dict()
    model = build_model(cfg, dtype=torch.bfloat16)
    model.load_state_dict(weights)
    del weights
    hw = pool.shape[1:3]

    def new_tg(fused):
        return TrackGenerator(cfg, "davis", model, NullWriter(), max_tracks_of(cfg, "davis"),
                              use_fused=fused)

    n_warm = min(DAVIS17_VAL_LENGTHS.values())
    new_tg(False)._process_loaded(Sequence("warm-up", n_warm, hw), pool[:n_warm], hw, 1)
    tgs = {"streaming": new_tg(False), "fused": new_tg(True)}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    timed = {name: [] for name in tgs}
    hashes = {name: [] for name in tgs}
    peak = {name: 0 for name in tgs}
    made = []  # sequences that made a fused state
    for i, (seq_id, n) in enumerate(DAVIS17_VAL_LENGTHS.items()):
        for name in ("streaming", "fused")[::1 if i % 2 == 0 else -1]:
            tg = tgs[name]
            states = tg.fused.states_made if tg.fused is not None else 0
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            Timer.reset()
            labels = tg._process_loaded(Sequence(seq_id, n, hw), pool[:n], hw, tg.max_tracks)[0]
            timed[name].append(Timer.get_durations_sum())
            # the streaming path keeps nothing between sequences; the fused
            # path keeps its state, so it counts from the pass's start
            peak[name] = max(peak[name], torch.cuda.max_memory_allocated()
                             - (before if tg.fused is None else base))
            if tg.fused is not None and tg.fused.states_made > states:
                made.append(i)
            labels = labels.cpu().numpy() if torch.is_tensor(labels) else labels
            hashes[name].append(hashlib.sha1(labels.astype(np.int32).tobytes()).hexdigest())
    n_total = sum(DAVIS17_VAL_LENGTHS.values())
    fps = {name: n_total / sum(t) for name, t in timed.items()}
    pipe = tgs["fused"].fused
    for name in tgs:
        log(f"  DAVIS 2017 val pass ({len(DAVIS17_VAL_LENGTHS)} sequences, {n_total} frames of "
            f"480x854, bf16, {smi}), {name}: overall fps {fps[name]:.3f}; the {len(made)} "
            f"sequences that made a fused state "
            f"{sum(timed[name][i] for i in made):.3f} s timed (the first "
            f"{timed[name][0]:.3f}), the other {len(timed[name]) - len(made)} "
            f"{sum(t for i, t in enumerate(timed[name]) if i not in made):.3f} s; peak device "
            f"memory {peak[name] / 2 ** 30:.2f} GiB above the pass's start "
            f"({base / 2 ** 30:.2f} GiB)")
    same = [a == b for a, b in zip(hashes["streaming"], hashes["fused"])]
    log(f"  DAVIS 2017 val pass: fused / streaming overall fps "
        f"{fps['fused'] / fps['streaming']:.3f}; {pipe.states_made} fused states made (at "
        f"sequences {made}), {pipe.captures} graphs captured, buffers for "
        f"{pipe._state.l_cap} frames and {pipe._state.w_cap} windows; labels equal on "
        f"{sum(same)} of {len(same)} sequences")
    if not all(same):
        raise AssertionError(f"DAVIS 2017 val pass: labels differ on "
                             f"{[s for s, ok in zip(DAVIS17_VAL_LENGTHS, same) if not ok]}")
    del tgs, pipe, model
    torch.cuda.empty_cache()


def fused_phase(out_root, smi):
    """Phase 19: the lsap kernel, the clustering kernels replayed from a
    graph, the fused path against the streaming path on A, C, D, C′ and A
    in bf16, and a pass over DAVIS 2017 val's sequence lengths on both.
    Returns (the lsap kernel's row, the paths' numbers)."""
    from stemseg_tpu_torch.ops import cluster as ops

    lsap_row = check_lsap()
    check_graph_replays(ops)
    frames_a = synthetic_frames(26, 480, 854, seed=MAIN_SEED)
    frames_c = synthetic_frames(20, 720, 1280, seed=MAIN_SEED)
    paths = {
        "A": fused_path("A", "davis_2", "davis", frames_a, "A", out_root, smi),
        "C": fused_path("C", "youtube_vis", "ytvis", frames_c, "C", out_root, smi),
        "D": fused_path("D", "kitti_mots_2", "kittimots",
                        synthetic_frames(16, 375, 1242, seed=MAIN_SEED), "0002", out_root, smi),
        "C'": fused_path("C'", "youtube_vis", "ytvis", frames_c[:8], "C2", out_root, smi,
                         resize_embeddings=True),
        "A bf16": fused_path("A_bf16", "davis_2", "davis", frames_a, "A", out_root, smi,
                             bf16=True),
    }
    dataset_pass(smi)
    return lsap_row, paths


# DAVIS 2017 val: the number of objects in each sequence's annotation, in the
# order of DAVIS17_VAL_LENGTHS (61 objects, 3,984 object-frames)
DAVIS17_VAL_OBJECTS = {
    "bike-packing": 2, "blackswan": 1, "bmx-trees": 2, "breakdance": 1, "camel": 1,
    "car-roundabout": 1, "car-shadow": 1, "cows": 1, "dance-twirl": 1, "dog": 1,
    "dogs-jump": 3, "drift-chicane": 1, "drift-straight": 1, "goat": 1, "gold-fish": 5,
    "horsejump-high": 2, "india": 3, "judo": 2, "kite-surf": 3, "lab-coat": 5,
    "libby": 1, "loading": 3, "mbike-trick": 2, "motocross-jump": 2,
    "paragliding-launch": 3, "parkour": 1, "pigs": 3, "scooter-black": 2,
    "shooting": 3, "soapbox": 3}
EVAL_SHAPES = {"davis": (480, 854), "ytvis": (720, 1280), "kittimots": (375, 1242)}
EVAL_PRESETS = {"davis": None, "ytvis": "youtube_vis", "kittimots": "kitti_mots_2"}
EVAL_CKPT_NAMES = {"davis": "davis.pth", "ytvis": "youtube_vis.pth",
                   "kittimots": "kitti_mots.pth"}


def write_eval_datasets(root, seed=MAIN_SEED, shapes=None):
    """Phase 20's validation sets with masks, each in its dataset's layout
    and frame size (``EVAL_SHAPES``, or ``shapes``), no pixel in two
    objects: ``davis_val.json`` (2 sequences of 24 and 30 frames, 1 and 3
    objects, an object absent for a few frames), ``youtube_vis_val.json`` (2
    sequences of 20 frames, categories among the 40) and
    ``kittimots_val.json`` (sequence 0002, 16 frames: two cars, a
    pedestrian, an ignore region of category 3). Returns the environment
    variables and {dataset: the JSON's sequences}."""
    import numpy as np

    shapes = dict(EVAL_SHAPES, **(shapes or {}))
    rng = np.random.RandomState(seed + 20)
    ann = os.path.join(root, "annotations")
    os.makedirs(ann)
    env = {"STEMSEG_JSON_ANNOTATIONS_DIR": ann,
           "DAVIS_BASE_DIR": os.path.join(root, "davis"),
           "YOUTUBE_VIS_BASE_DIR": os.path.join(root, "youtube_vis"),
           "KITTIMOTS_BASE_DIR": os.path.join(root, "kitti_mots")}
    sets = {
        "davis": write_video_set(
            rng, env["DAVIS_BASE_DIR"], ann, "davis_val.json", *shapes["davis"],
            [("dv0", 24, {1: 1}, {1: {20, 21}}),
             ("dv1", 30, {1: 1, 2: 1, 3: 1}, {3: set(range(4, 9))})], separate=True),
        "ytvis": write_video_set(
            rng, env["YOUTUBE_VIS_BASE_DIR"], ann, "youtube_vis_val.json", *shapes["ytvis"],
            [("yv0", 20, {1: 5, 2: 17}, {}), ("yv1", 20, {1: 33, 2: 40, 3: 8}, {3: set(range(6))})],
            sub="valid", separate=True),
        "kittimots": write_video_set(
            rng, env["KITTIMOTS_BASE_DIR"], ann, "kittimots_val.json", *shapes["kittimots"],
            [("0002", 16, {1001: 1, 1002: 1, 2001: 2, 10000: 3}, {1002: {0, 1, 2}})],
            separate=True)}
    return env, sets


def ground_truth_as_results(dataset, sequences, out_dir, device="cuda"):
    """Each ground-truth object of ``sequences`` (category 3 excepted) as a
    prediction: DAVIS PNGs and KITTI-MOTS txt through the port's writers
    (the label volume at full size, ``mask_scale`` 1, so the resize chain is
    the identity), YT-VIS ``results.json`` in its on-disk format (a track's
    RLE masks, its category, score 1). Returns the ``--results`` path."""
    import numpy as np
    import torch

    from stemseg_tpu_torch.inference.chainer import OUTLIER_LABEL
    from stemseg_tpu_torch.utils import rle

    entries = []
    writer = None if dataset == "ytvis" else make_writer(dataset, out_dir, device=device)
    for seq in sequences:
        h, w, n = seq["height"], seq["width"], len(seq["image_paths"])
        objects = [(int(iid), cat) for iid, cat in seq["categories"].items() if cat != 3]
        masks = {iid: [rle.decode({"counts": s[str(iid)].encode(), "size": [h, w]})
                       if str(iid) in s else None for s in seq["segmentations"]]
                 for iid, _ in objects}
        if dataset == "ytvis":
            for iid, cat in objects:
                entries.append({"video_id": seq["id"], "score": 1.0, "category_id": cat,
                                "segmentations": [None if m is None else dict(
                                    rle.encode(m), counts=rle.encode(m)["counts"].decode())
                                    for m in masks[iid]]})
            continue
        labels = np.full((n, h, w), OUTLIER_LABEL, np.int32)
        classes = np.zeros((n, h, w), np.int64)
        for k, (iid, cat) in enumerate(objects, 1):  # track ids start at 1, as the chainer's
            for t, m in enumerate(masks[iid]):
                if m is not None:
                    labels[t][m > 0] = k
                    classes[t][m > 0] = cat
        ids, counts = np.unique(labels, return_counts=True)
        lifetimes = {int(i): int((labels == i).any(axis=(1, 2)).sum()) for i in ids}
        writer.process_sequence(Sequence(seq["id"], n, (h, w)), torch.from_numpy(labels),
                                dict(zip(map(int, ids), map(int, counts))), lifetimes,
                                torch.from_numpy(classes), mask_scale=1, max_tracks=255,
                                min_dim=min(h, w), max_dim=max(h, w))
    if dataset == "ytvis":
        os.makedirs(out_dir)
        with open(os.path.join(out_dir, "results.json"), "w") as fh:
            json.dump(entries, fh)
        return os.path.join(out_dir, "results.json")
    writer.save()
    return os.path.join(out_dir, "results")


PERFECT_KEYS = {"davis": ("J_mean", "F_mean", "J&F"), "ytvis": ("AP", "AP50", "AP75"),
                "kittimots": ("sMOTSA", "MOTSA", "MOTSP", "sMOTSA_car", "MOTSA_car",
                              "MOTSP_car", "sMOTSA_pedestrian", "MOTSA_pedestrian",
                              "MOTSP_pedestrian")}


def score_cli(dataset, results):
    """``python -m stemseg_tpu_torch.eval.main`` in a process of its own;
    returns its JSON line."""
    out = subprocess.run([sys.executable, "-m", "stemseg_tpu_torch.eval.main", "--dataset",
                          dataset, "--results", results], cwd=HERE, env=dict(os.environ),
                         capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise AssertionError(f"eval.main {dataset}: exit {out.returncode}\n{out.stderr[-4000:]}")
    return out.stdout.strip().splitlines()[-1]


def check_perfect_scores(root, sets, device="cuda"):
    """Ground truth scored as a prediction: every J, F, J&F, AP, AP50, AP75,
    sMOTSA, MOTSA and MOTSP exactly 1.0 (unrounded, in this process), and
    the scoring CLI's JSON line equal on two runs."""
    from stemseg_tpu_torch.eval.main import eval_davis, eval_kittimots, eval_ytvis

    scorers = {"davis": eval_davis, "ytvis": eval_ytvis, "kittimots": eval_kittimots}
    for dataset, sequences in sets.items():
        t0 = time.perf_counter()
        results = ground_truth_as_results(dataset, sequences,
                                          os.path.join(root, "perfect_" + dataset), device)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        metrics = scorers[dataset](results)
        t_score = time.perf_counter() - t0
        bad = {k: metrics[k] for k in PERFECT_KEYS[dataset] if metrics[k] != 1.0}
        if bad or (dataset == "kittimots" and (metrics["FP"] or metrics["IDS"])):
            raise AssertionError(f"{dataset}: ground truth as results scored {metrics}")
        lines = [score_cli(dataset, results) for _ in range(2)]
        if lines[0] != lines[1]:
            raise AssertionError(f"{dataset}: two runs of the scoring CLI printed {lines}")
        log(f"  {dataset} ground truth as results ({len(sequences)} sequences, written in "
            f"{t_write:.3f} s, scored in {t_score:.3f} s): {lines[0]}; the CLI's line equal "
            f"on two runs")


def convert_path_t(out_root, models_dir):
    """Phase 18's JAX ``.ckpt`` of path T's weights through the port's
    converter into ``models_dir/davis.pth``, held tensor for tensor against
    T's own ``.pth``; T's ``config.yaml`` beside it with
    ``min_seediness_prob`` 0.05."""
    import glob

    import torch

    from stemseg_tpu_torch.config import load_config, merge, save_config
    from stemseg_tpu_torch.models import convert_checkpoint
    from stemseg_tpu_torch.training.checkpoint import find_latest_checkpoint

    ckpt = sorted(glob.glob(os.path.join(out_root, "T_jax", "*.ckpt")))[-1]
    pth = find_latest_checkpoint(os.path.join(out_root, "T"))
    os.makedirs(models_dir)
    out = os.path.join(models_dir, "davis.pth")
    t0 = time.perf_counter()
    convert_checkpoint.main([ckpt, out])  # the config.yaml beside the .ckpt
    seconds = time.perf_counter() - t0
    want = torch.load(pth, map_location="cpu", weights_only=True)["model"]
    got = torch.load(out, map_location="cpu", weights_only=True)["model"]
    if got.keys() != want.keys() or not all(torch.equal(got[k], want[k]) for k in want):
        raise AssertionError("the converted .pth differs from path T's")
    cfg = load_config(os.path.join(os.path.dirname(ckpt), "config.yaml"))
    save_config(merge(cfg, {"clustering": {"min_seediness_prob": 0.05}}),
                os.path.join(models_dir, "config.yaml"))
    log(f"  {os.path.basename(ckpt)} -> {out} in {seconds:.3f} s: {len(want)} tensors, "
        f"each equal to {os.path.basename(pth)}'s")


def random_eval_model(dataset, sequences, models_dir, device="cuda"):
    """A random-weight model of the dataset's preset (fg logit centred on
    the first sequence's first window) as ``models_dir/<name>.pth`` beside
    its ``config.yaml`` (``min_seediness_prob`` 0.05)."""
    import cv2
    import numpy as np
    import torch

    from stemseg_tpu_torch.config import load_preset, merge, save_config

    cfg = merge(load_preset(EVAL_PRESETS[dataset]), {"clustering": {"min_seediness_prob": 0.05}})
    seq = sequences[0]
    base = os.path.join(os.environ["YOUTUBE_VIS_BASE_DIR"], "valid") if dataset == "ytvis" \
        else os.environ["KITTIMOTS_BASE_DIR"]
    frames = np.stack([cv2.imread(os.path.join(base, p)) for p in
                       seq["image_paths"][:cfg.input.num_frames]])
    model = build_random_model(cfg, frames, MAIN_SEED, device=device)
    os.makedirs(models_dir)
    torch.save({"model": model.state_dict()}, os.path.join(models_dir, EVAL_CKPT_NAMES[dataset]))
    save_config(cfg, os.path.join(models_dir, "config.yaml"))
    del model
    torch.cuda.empty_cache()


class ScorerTimes:
    """Counts and times the calls of the DAVIS scorer's ``db_eval_iou`` and
    ``db_eval_boundary`` (each call one (object, proposal) pair over the
    sequence's frames) while it is installed."""

    def __init__(self):
        from stemseg_tpu_torch.eval import davis

        self.module = davis
        self.inner = {name: getattr(davis, name) for name in ("db_eval_iou", "db_eval_boundary")}
        self.calls = {name: 0 for name in self.inner}
        self.frames = {name: 0 for name in self.inner}
        self.seconds = {name: 0.0 for name in self.inner}

    def __enter__(self):
        for name, fn in self.inner.items():
            def timed(gt, pred, *args, _name=name, _fn=fn):
                t0 = time.perf_counter()
                out = _fn(gt, pred, *args)
                self.seconds[_name] += time.perf_counter() - t0
                self.calls[_name] += 1
                self.frames[_name] += len(gt)
                return out
            setattr(self.module, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.inner.items():
            setattr(self.module, name, fn)


def eval_all_run(dataset, models_dir, out_dir, profiled):
    """``python -m stemseg_tpu_torch.tools.eval_all --datasets <dataset>``
    in this process, ``--device`` at its default (cuda); with ``profiled``
    under ``profiled_launches`` (every window's clustering and lsap kernel
    counted on the device, graph replays included), else with the DAVIS
    scorer's calls timed. Every sequence must take the fused path and no
    launch go to the single-block kernel or a plain version. Returns
    eval_all's result for the dataset, the windows, the device counts (or
    None) and the scorer's times (or None)."""
    from stemseg_tpu_torch.inference import main as cli
    from stemseg_tpu_torch.inference.windows import get_subsequence_frames
    from stemseg_tpu_torch.ops import launch_counts, lsap, reset_launch_counts
    from stemseg_tpu_torch.tools import eval_all

    inner = cli.TrackGenerator._process_loaded
    seen, res = [], {}

    def process_loaded(self, sequence, frames, image_hw, max_tracks):
        result = inner(self, sequence, frames, image_hw, max_tracks)
        seen.append((len(get_subsequence_frames(len(frames), self.cfg.input.num_frames,
                                                self.frame_overlap)), result[3] is None))
        return result

    def run():
        seen.clear()
        reset_launch_counts()
        lsap.reset_launch_counts()
        res["out"] = eval_all.main(["--models_dir", models_dir, "--output_dir", out_dir,
                                    "--datasets", dataset])[dataset]

    def expect():
        n = sum(w for w, _ in seen)
        return {"cluster_kernel": n, "lsa_kernel": n}

    cli.TrackGenerator._process_loaded = process_loaded
    times = None
    try:
        if profiled:
            device = profiled_launches(run, expect, f"eval_all {dataset}")
        else:
            device = None
            with ScorerTimes() as times:
                run()
    finally:
        cli.TrackGenerator._process_loaded = inner
    host = dict(launch_counts, **lsap.launch_counts)
    if not all(fused for _, fused in seen) or not host["cluster_points_tiled"] \
            or not host["lsa_masked"] or host["cluster_points_single"] \
            or host["cluster_points_reference"] or host["lsa_masked_reference"]:
        raise AssertionError(f"eval_all {dataset}: sequences (windows, fused) {seen}, host "
                             f"launches {host}")
    if not os.path.exists(os.path.join(out_dir, "RESULTS.md")):
        raise AssertionError(f"eval_all {dataset}: no RESULTS.md in {out_dir}")
    return res["out"], sum(w for w, _ in seen), device, times


def eval_phase(out_root, smi, device="cuda"):
    """Phase 20: convert -> infer -> score at full width. Writes the three
    validation sets (``write_eval_datasets``) and points the dataset
    variables at them; scores their ground truth as results (exactly 1.0,
    the CLI deterministic); converts phase 18's JAX ``.ckpt`` of path T into
    a ``.pth`` (equal to T's); then runs ``tools.eval_all`` on the card for
    DAVIS (the converted ``.pth``), YT-VIS and KITTI-MOTS (random
    ``youtube_vis`` and ``kitti_mots_2`` models), each twice: profiled (the
    kernels' device launches), then timed (inference and scoring seconds;
    for DAVIS the scorer's (object, proposal, frame) triples and its
    ``db_eval_boundary`` calls), with equal metrics. Returns each run's
    launches for the kernel table."""
    import torch

    root = os.path.join(out_root, "eval")
    t0 = time.perf_counter()
    env, sets = write_eval_datasets(root)
    os.environ.update(env)
    log(f"  three validation sets written in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(f"{ds} {len(seqs)} sequences of {[len(s['image_paths']) for s in seqs]} "
                    f"frames of {seqs[0]['height']}x{seqs[0]['width']}"
                    for ds, seqs in sets.items()))
    check_perfect_scores(root, sets, device)
    convert_path_t(out_root, os.path.join(root, "models_davis"))
    launches = {}
    for dataset in ("davis", "ytvis", "kittimots"):
        models_dir = os.path.join(root, "models_" + dataset)
        if dataset != "davis":
            random_eval_model(dataset, sets[dataset], models_dir, device)
        first, n_windows, counts, _ = eval_all_run(dataset, models_dir,
                                                   os.path.join(root, "run1"), True)
        res, _, _, times = eval_all_run(dataset, models_dir, os.path.join(root, "run2"), False)
        if res["metrics"] != first["metrics"]:
            raise AssertionError(f"eval_all {dataset}: metrics {res['metrics']} on the second "
                                 f"run, {first['metrics']} on the first")
        launches[f"eval_all {dataset} (profiled)"] = {
            "cluster_points_single": 0, "cluster_points_tiled": counts["cluster_kernel"],
            "lsa_masked": counts["lsa_kernel"]}
        n_frames = sum(len(s["image_paths"]) for s in sets[dataset])
        log(f"  eval_all {dataset} ({smi}; scoring on the host's CPU): "
            f"{json.dumps(res['metrics'])}")
        log(f"  eval_all {dataset}: {n_frames} frames, {n_windows} windows, device launches "
            f"{counts} (profiler, first run); inference_s {res['inference_s']:.3f} "
            f"(first run, profiled: {first['inference_s']:.3f}), scoring_s "
            f"{res['scoring_s']:.3f} (first run {first['scoring_s']:.3f}), scoring "
            f"{1e3 * res['scoring_s'] / n_frames:.3f} ms a frame, scoring / inference "
            f"{res['scoring_s'] / res['inference_s']:.3f}")
        if dataset == "davis":
            davis_scoring_projection(res, times, sets["davis"])
    torch.cuda.empty_cache()
    return launches


def davis_scoring_projection(res, times, sequences):
    """The DAVIS scorer's cost in the timed run, and what it projects for
    DAVIS 2017 val (``DAVIS17_VAL_LENGTHS``, ``DAVIS17_VAL_OBJECTS``) with
    each sequence's proposals at the run's mean and at the writer's limit
    of 20: boundary and IoU time per (object, proposal, frame) triple, the
    rest of the scoring wall per frame."""
    n_frames = sum(len(s["image_paths"]) for s in sequences)
    triples = times.frames["db_eval_boundary"]
    pairs = times.calls["db_eval_boundary"]
    run_obj_frames = sum(len(s["categories"]) * len(s["image_paths"]) for s in sequences)
    t_b, t_j = times.seconds["db_eval_boundary"], times.seconds["db_eval_iou"]
    rest = res["scoring_s"] - t_b - t_j
    per_triple = (t_b + t_j) / triples
    log(f"  DAVIS scoring: {triples} (object, proposal, frame) triples in {pairs} "
        f"db_eval_boundary calls ({run_obj_frames} object-frames, "
        f"{triples / run_obj_frames:.2f} proposals an object-frame), "
        f"{1e3 * t_b / pairs:.3f} ms a call, {1e3 * t_b / triples:.4f} ms a triple; "
        f"db_eval_iou {1e3 * t_j / triples:.4f} ms a triple; the rest (PNG and RLE decode, "
        f"matching) {1e3 * rest / n_frames:.3f} ms a frame; scoring {res['scoring_s']:.3f} s")
    obj_frames = sum(DAVIS17_VAL_OBJECTS[s] * n for s, n in DAVIS17_VAL_LENGTHS.items())
    val_frames = sum(DAVIS17_VAL_LENGTHS.values())
    for label, n_prop in (("this run's mean", triples / run_obj_frames), ("the limit", 20)):
        seconds = obj_frames * n_prop * per_triple + val_frames * rest / n_frames
        log(f"  DAVIS 2017 val scoring, projected ({val_frames} frames, {obj_frames} "
            f"object-frames, {n_prop:.2f} proposals an object-frame, {label}): "
            f"{obj_frames * n_prop:.0f} triples, {seconds:.1f} s")


def dilated_phase(smi, device="cuda"):
    """Phase 21: the dilated decoder trunk. An ``EmbeddingDecoder`` with
    ``trunk_type="squeeze_expand_dilated_decoder"`` at ``davis_2``'s widths
    on one 16-frame window of path A's FPN maps (704x1248 input), and the
    plain trunk's head on the same window: forward ms (CUDA events) and
    peak memory above the inputs, in float32 and bf16. Then at the tests'
    small size each head with the dilated trunk on the GPU against the CPU
    (same weights and inputs, TF32 off): forward within 1e-3, input and
    parameter gradients within a per-leaf relative L2 of 1e-3."""
    import numpy as np
    import torch

    from stemseg_tpu_torch.config import load_preset
    from stemseg_tpu_torch.inference.engine import InferenceEngine
    from stemseg_tpu_torch.models import init_random_weights
    from stemseg_tpu_torch.models.decoders import (
        EmbeddingDecoder,
        SeedinessDecoder,
        SemsegDecoder,
    )
    from stemseg_tpu_torch.models.embedding_utils import get_nb_embedding_dims, get_nb_free_dims
    from stemseg_tpu_torch.utils.device import resolve_device

    resolve_device(device)  # TF32 off
    cfg = load_preset("davis_2")
    m, e = cfg.model, cfg.model.embeddings
    c = m.resnets.backbone_out_channels
    frames = synthetic_frames(cfg.input.num_frames, 480, 854, seed=MAIN_SEED)
    model = build_random_model(cfg, frames, MAIN_SEED, device=device)
    feats = window_features(InferenceEngine(cfg, model), frames)
    mode = m.embedding_dim_mode  # channels: embeddings | variances | fused seediness
    out_shape = (1, get_nb_embedding_dims(mode) + e.embedding_size - get_nb_free_dims(mode)
                 + (not m.use_seediness_head), *feats[-1].shape[2:])
    del model
    torch.cuda.empty_cache()

    def head(trunk_type, dtype=None):
        return EmbeddingDecoder(c, tuple(e.inter_channels), e.embedding_size,
                                m.embedding_dim_mode, e.tanh_activation,
                                seediness_output=not m.use_seediness_head,
                                num_frames=cfg.input.num_frames, norm_type=e.normalization_layer,
                                gn_groups=e.gn_num_groups, pool_type=e.pool_type, dtype=dtype,
                                trunk_type=trunk_type)

    for trunk_type in ("squeeze_expand_decoder", "squeeze_expand_dilated_decoder"):
        ref = head(trunk_type)
        init_random_weights(ref, 1)
        for dtype in (None, torch.bfloat16):
            h = head(trunk_type, dtype)
            h.load_state_dict(ref.state_dict())
            h.to(device).eval()
            with torch.no_grad():
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = h(feats)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
                ms = time_cuda(lambda: h(feats), 5)
            if tuple(out.shape) != out_shape or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{trunk_type}: output {tuple(out.shape)}, finite "
                                     f"{bool(torch.isfinite(out).all())}")
            n_params = sum(p.numel() for p in h.parameters())
            log(f"  {trunk_type} embedding head ({'bf16' if dtype else 'fp32'}, {n_params:,} "
                f"parameters, {smi}): forward {ms:.3f} ms to {out_shape} (CUDA events, "
                f"mean of 5), peak {peak / 2 ** 30:.3f} GiB above the inputs")
            del h, out
        torch.cuda.empty_cache()
    del feats
    torch.cuda.empty_cache()

    rng = np.random.RandomState(21)
    for name, make in (("embedding", lambda t: EmbeddingDecoder(
            16, (16, 16, 8, 8), 4, "xyff", seediness_output=True, num_frames=t,
            gn_groups=4, trunk_type="squeeze_expand_dilated_decoder")),
                       ("seediness", lambda t: SeedinessDecoder(
            16, (16, 16, 8, 8), num_frames=t, gn_groups=4,
            trunk_type="squeeze_expand_dilated_decoder")),
                       ("semseg", lambda t: SemsegDecoder(
            16, 3, (16, 16, 8, 8), num_frames=t, gn_groups=4,
            trunk_type="squeeze_expand_dilated_decoder"))):
        for t in (8, 16):
            feats = [torch.from_numpy(rng.randn(1, 16, t, s, 3 * s // 2).astype(np.float32))
                     for s in (2, 4, 8, 16)]
            cpu = make(t)
            init_random_weights(cpu, t)

            def run(dev, weight=None, _feats=feats, _make=make, _t=t, _cpu=cpu):
                h = _make(_t).to(dev)
                h.load_state_dict(_cpu.state_dict())
                xs = [f.to(dev).clone().requires_grad_(True) for f in _feats]
                y = h(xs)
                if weight is None:
                    weight = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
                (y * weight.to(dev)).sum().backward()
                return (y.detach().double().cpu(),
                        {n: p.grad.double().cpu() for n, p in h.named_parameters()},
                        [x.grad.double().cpu() for x in xs], weight)

            results = {"cpu": run("cpu")}
            results[device] = run(device, results["cpu"][3])
            (y_c, g_c, x_c, _), (y_g, g_g, x_g, _) = results["cpu"], results[device]
            fwd = float((y_g - y_c).abs().max())
            grads = [(float((g_g[n] - g).norm() / g.norm().clamp(min=1e-30)), n)
                     for n, g in g_c.items()]
            grads += [(float((a - b).norm() / b.norm().clamp(min=1e-30)), f"input {i}")
                      for i, (a, b) in enumerate(zip(x_g, x_c))]
            worst = max(grads)
            log(f"  dilated {name} head, {t} frames, GPU vs CPU: forward max abs "
                f"{fwd:.3g}, gradients max per-leaf relative L2 {worst[0]:.3g} ({worst[1]}) "
                f"over {len(grads)} tensors")
            if not fwd <= 1e-3 or not worst[0] <= 1e-3:
                raise AssertionError(f"dilated {name} head, {t} frames: forward {fwd}, "
                                     f"gradients {worst}")


# -- phase 22: data parallelism, a JAX session, a sustained run ---------------

DIST_KEYS = ("total", "lovasz", "var_smoothness", "seediness", "total_embedding", "grad_norm")


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank, world, port):
    """The variables torchrun gives rank ``rank``; both ranks on cuda:0."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": "0",
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "GLOO_SOCKET_IFNAME": "lo"}


class DeterministicTraining:
    """cuDNN's deterministic algorithms and PyTorch's deterministic mode
    (warn-only) inside the block; ``nondeterministic`` lists the ops that
    warned they have no deterministic CUDA implementation."""

    def __enter__(self):
        import warnings

        import torch

        self.prev = (torch.backends.cudnn.deterministic,
                     torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled())
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
        self.catcher = warnings.catch_warnings(record=True)
        self.caught = self.catcher.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        import torch

        self.catcher.__exit__(*exc)
        torch.backends.cudnn.deterministic = self.prev[0]
        torch.use_deterministic_algorithms(self.prev[1], warn_only=self.prev[2])
        return False

    @property
    def nondeterministic(self):
        return sorted({str(w.message).split(" does not have")[0] for w in self.caught
                       if "deterministic" in str(w.message)})


def compare_states(a, b):
    """(bitwise equal, worst per-leaf relative L2 and its key) of two state
    dicts."""
    import torch

    worst = (0.0, "")
    for k in a:
        x, y = a[k].double(), b[k].double()
        rel = float(torch.linalg.vector_norm(x - y) / max(float(torch.linalg.vector_norm(y)),
                                                          1e-30))
        worst = max(worst, (rel, k))
    return all(torch.equal(a[k], b[k]) for k in a), worst


def hold_bitwise(tag, a, b, det):
    """Holds two runs of the same computation bitwise equal. Their backward
    passes the ops in ``det.nondeterministic`` (atomics), so where those
    ran and the two differ, holds them within a per-leaf relative L2 of
    1e-3 (phase 13's gradient bound) and says so. Returns the numbers."""
    bitwise, worst = compare_states(a, b)
    out = {"bitwise": bitwise, "worst_rel_l2": worst[0], "worst_key": worst[1],
           "nondeterministic_ops": det.nondeterministic}
    if not bitwise and (not det.nondeterministic or worst[0] > 1e-3):
        raise AssertionError(f"{tag}: not bitwise equal, worst {worst}; ops without a "
                             f"deterministic CUDA implementation: {det.nondeterministic}")
    log(f"  {tag}: {'bitwise equal' if bitwise else 'NOT bitwise equal'}; worst leaf relative "
        f"L2 {worst[0]:.3e} ({worst[1]}); ops that warned of no deterministic CUDA "
        f"implementation: {det.nondeterministic or 'none'}")
    return out


def cpu_state(model):
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def world_one_phase(out_root):
    """Phase 22 (a): path T for 2 optimizer steps through the trainer as
    torchrun starts it at world 1 (NCCL process group, all-reduces of the
    gradient and the loss terms, global normalisers, rank slices of the
    stream), against the plain trainer on the same seed and stream."""
    import torch
    import torch.distributed as dist

    cfg = training_cfg("davis_1", 2)
    runs = {}
    with DeterministicTraining() as det:
        for kind in ("plain", "nccl"):
            env = rank_env(0, 1, free_port()) if kind == "nccl" else {}
            os.environ.update(env)
            try:
                t0 = time.perf_counter()
                trainer = new_trainer(cfg, os.path.join(out_root, f"T22_{kind}"))
                if kind == "nccl" and not (dist.is_initialized()
                                           and dist.get_backend() == "nccl"
                                           and trainer.world == 1 and trainer.train_step.distributed):
                    raise AssertionError("phase 22 (a): the trainer did not join an NCCL group")
                trainer.start()
                runs[kind] = {"state": cpu_state(trainer.model), "wall_s": time.perf_counter() - t0,
                              "records": read_metrics(trainer.model_dir, DIST_KEYS),
                              "intervals_s": steady_intervals(trainer, 0)}
            finally:
                for k in env:
                    os.environ.pop(k)
                if dist.is_initialized():
                    dist.destroy_process_group()
            del trainer
            torch.cuda.empty_cache()
    plain, nccl = runs["plain"], runs["nccl"]
    losses_equal = plain["records"] == nccl["records"]
    for kind, run in runs.items():
        log(f"  (a) {kind}: 2 steps in {run['wall_s']:.3f} s (build included), step interval "
            f"{['%.4f' % s for s in run['intervals_s']]} s; " + "; ".join(
                f"step {r['step']} total {r['total']:.6f} grad_norm {r['grad_norm']:.6f}"
                for r in run["records"]))
    log(f"  (a) logged loss terms and grad_norm of both steps bitwise equal: {losses_equal}")
    out = hold_bitwise("(a) weights after 2 steps, NCCL world 1 against plain", nccl["state"],
                       plain["state"], det)
    if not losses_equal and out["bitwise"]:
        raise AssertionError(f"(a) equal weights but other logged terms: {plain['records']} / "
                             f"{nccl['records']}")
    out.update(losses_bitwise=losses_equal,
               step_s={k: r["intervals_s"] for k, r in runs.items()})
    return out


def two_rank_worker(spec_path):
    """One rank of phase 22 (b), started by ``two_rank_phase``: path T's
    trainer at ``max_samples_per_chip`` 1 in a gloo group of 2 ranks that
    share cuda:0. The first micro-step's gradient and loss terms (summed
    over the ranks); then 3 optimizer steps, the last 2 timed, and the
    gradient all-reduce alone, timed. Rank 0 saves them."""
    import torch

    from stemseg_tpu_torch.parallel import all_reduce_sum_
    from stemseg_tpu_torch.training.loader import to_device
    from stemseg_tpu_torch.training.step import TrainStep
    from stemseg_tpu_torch.utils.distributed import synchronize

    with open(spec_path) as fh:
        spec = json.load(fh)
    trainer = new_trainer(training_cfg("davis_1", 4), spec["model_dir"], "--dist_backend", "gloo")
    if trainer.world != 2 or torch.distributed.get_backend() != "gloo":
        raise AssertionError(f"rank {trainer.rank}: world {trainer.world}")
    batches = iter(trainer.make_loader(0))
    probe = TrainStep(trainer.model, trainer.cfg, trainer.optimizer, trainer.scheduler,
                      accumulate_steps=2)
    metrics = {k: float(v) for k, v in probe(to_device(next(batches), trainer.device)).items()}
    grads = {n: p.grad.detach().cpu().clone() for n, p in trainer.model.named_parameters()
             if p.requires_grad}
    trainer.optimizer.zero_grad(set_to_none=True)
    params = [p for p in trainer.model.parameters() if p.requires_grad]
    reduce_ms = []
    for _ in range(3):
        bucket = [torch.ones_like(p) for p in params]
        synchronize()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        all_reduce_sum_(bucket)
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
        if not all(bool((b == 2).all()) for b in bucket):
            raise AssertionError("the all-reduce did not sum the two ranks")
    del bucket
    step_s = []
    for _ in range(3):
        batch = to_device(next(batches), trainer.device)
        synchronize()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    if trainer.rank == 0:
        torch.save({"metrics": metrics, "grads": grads, "step_s": step_s[1:],
                    "reduce_ms": reduce_ms[1:],
                    "peak_gib": torch.cuda.max_memory_allocated() / 2**30}, spec["out"])
    torch.distributed.destroy_process_group()


def per_clip_reference(model, cfg, batch, world):
    """Phases 22 and 23 (b)(ii): a global batch of ``world`` clips (device
    tensors) one clip at a time in one process, each clip's loss over the
    whole batch's normalisers (its instance count and ``world`` sequences;
    the CE and fg BCE divided by ``world``), as a rank that holds the clip
    computes it; the gradients and the loss terms summed over the clips.
    Returns ({trainable parameter name: gradient on the CPU}, {loss term:
    float})."""
    import torch

    from stemseg_tpu_torch.training.loader import DEVICE_KEYS
    from stemseg_tpu_torch.training.step import make_output_loss_fn, prepare_targets

    masks = batch["masks"].float()
    if not cfg.training.loss_at_full_res:
        masks = prepare_targets(masks, batch["ignore_masks"].float(), batch["category_ids"])[0]
    n_instances = int((masks.flatten(2).amax(2) > 0).sum())
    loss_fn = make_output_loss_fn(cfg, world_counts=lambda n, s: (n_instances, world),
                                  world_size=world)
    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads, terms = {n: 0.0 for n, _ in params}, {}
    for i in range(world):
        clip = {k: batch[k][i:i + 1] for k in DEVICE_KEYS}
        loss, metrics = loss_fn(model(clip["images"].permute(0, 1, 4, 2, 3)), clip)
        for (n, _), g in zip(params, torch.autograd.grad(
                loss, [p for _, p in params], allow_unused=True, materialize_grads=True)):
            grads[n] = grads[n] + g.detach().cpu()
        for k, v in metrics.items():
            terms[k] = terms.get(k, 0.0) + float(v.detach())
    return grads, terms


def two_rank_phase(out_root):
    """Phase 22 (b): two gloo ranks sharing the card at ``per_chip`` 1
    against one process on the same global batch: (i) at ``per_chip`` 2,
    loss terms within 1e-4 relative and the first micro-step's gradient
    within a per-leaf relative L2 of 1e-3 (phase 13's bounds), printed,
    and the whole gradient within 1e-3, held (cuDNN picks its algorithms
    by batch size, and a leaf whose gradient cancels can miss 1e-3); (ii) the
    same two clips one at a time in one process, each loss over the global
    normalisers, the two gradients summed (the ranks' convolution shapes):
    loss terms within 1e-6, per-leaf gradients within 1e-4. Each one's step
    time and the all-reduce's."""
    import torch

    from stemseg_tpu_torch.config import merge
    from stemseg_tpu_torch.training.loader import to_device
    from stemseg_tpu_torch.training.step import TrainStep

    model_dir = os.path.join(out_root, "T22_ranks")
    spec = {"model_dir": model_dir, "out": os.path.join(out_root, "T22_ranks.pt")}
    spec_path = os.path.join(out_root, "T22_ranks.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    os.makedirs(model_dir + "_logs")
    t0 = time.perf_counter()
    run_ranks([sys.executable, os.path.abspath(__file__), "--rank-worker", spec_path], 2,
              model_dir + "_logs", env_of=rank_env, timeout=300)
    ranks_wall = time.perf_counter() - t0
    got = torch.load(spec["out"], weights_only=True)

    cfg = merge(training_cfg("davis_1", 4), {"training": {"max_samples_per_chip": 2}})
    trainer = new_trainer(cfg, os.path.join(out_root, "T22_one"))
    batches = iter(trainer.make_loader(0))
    probe = TrainStep(trainer.model, cfg, trainer.optimizer, trainer.scheduler,
                      accumulate_steps=2)
    first = to_device(next(batches), trainer.device)
    if first["images"].shape[0] != 2:
        raise AssertionError(f"phase 22 (b): a batch of {first['images'].shape[0]}")
    metrics = {k: float(v) for k, v in probe(first).items()}
    params = [(n, p) for n, p in trainer.model.named_parameters() if p.requires_grad]
    grads = {n: p.grad.detach().cpu() for n, p in params}
    trainer.optimizer.zero_grad(set_to_none=True)

    # (ii): the ranks' shapes in one process
    split_grads, split_metrics = per_clip_reference(trainer.model, cfg, first, 2)

    step_s = []
    for _ in range(3):
        batch = to_device(next(batches), trainer.device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del trainer, probe, first
    torch.cuda.empty_cache()

    for k, v in metrics.items():
        if abs(got["metrics"][k] - v) > 1e-4 * max(abs(v), 1e-6):
            raise AssertionError(f"phase 22 (b): {k} {got['metrics'][k]} on 2 ranks, {v} on one")
    for k, v in split_metrics.items():
        if abs(got["metrics"][k] - v) > 1e-6 * max(abs(v), 1e-6):
            raise AssertionError(f"phase 22 (b) (ii): {k} {got['metrics'][k]} on 2 ranks, {v} "
                                 "one clip at a time")
    _, worst = compare_states(got["grads"], grads)
    _, worst_split = compare_states(got["grads"], split_grads)
    flat = [torch.cat([d[n].reshape(-1).double() for n, _ in params])
            for d in (got["grads"], grads)]
    whole = float(torch.linalg.vector_norm(flat[0] - flat[1]) / torch.linalg.vector_norm(flat[1]))
    over = sorted(n for n, _ in params if compare_states({n: got["grads"][n]}, {n: grads[n]})[1][0]
                  > 1e-3)
    if worst_split[0] > 1e-4 or whole > 1e-3:
        raise AssertionError(f"phase 22 (b): gradient against per_chip 2 worst {worst}, whole "
                             f"{whole:.3e}; against the clips one at a time worst {worst_split}")
    log(f"  (b) 2 gloo ranks on cuda:0 at per_chip 1 against 1 process at per_chip 2: loss "
        f"terms {', '.join(f'{k} {got['metrics'][k]:.6f}/{v:.6f}' for k, v in metrics.items())}; "
        f"gradient: worst leaf relative L2 {worst[0]:.3e} ({worst[1]}), {len(over)} leaves above "
        f"1e-3 {over[:4]}, the whole gradient {whole:.3e}")
    log(f"  (b) against the same clips one at a time in one process (the ranks' shapes): worst "
        f"leaf relative L2 {worst_split[0]:.3e} ({worst_split[1]})")
    log(f"  (b) optimizer step (one micro-step of 2 clips): 2 ranks sharing the card "
        f"{['%.4f' % s for s in got['step_s']]} s, 1 process {['%.4f' % s for s in step_s[1:]]} "
        f"s; the gradient all-reduce alone (gloo, CUDA tensors, "
        f"{sum(g.numel() for g in grads.values()) * 4 / 1e6:.1f} MB) "
        f"{['%.3f' % m for m in got['reduce_ms']]} ms; peak memory rank 0 "
        f"{got['peak_gib']:.2f} GiB, 1 process {peak:.2f} GiB; ranks' wall {ranks_wall:.1f} s")
    return {"worst_grad_rel_l2": worst[0], "whole_grad_rel_l2": whole,
            "worst_grad_rel_l2_split": worst_split[0], "step_s_two_ranks": got["step_s"],
            "step_s_one_process": step_s[1:], "all_reduce_ms": got["reduce_ms"]}


def data_parallel_phase(out_root, smi):
    """Phase 22 (c): the inference CLI's ``--data_parallel`` on path A's
    preset in bf16 (random weights as a ``.pth`` beside its config) over
    phase 20's generated DAVIS sequences, byte-equal to the serial CLI, its
    clustering and lsap launches counted by the profiler; and
    ``run_batch`` over ``["cuda:0", "cuda:0"]`` (two pipelines, two host
    threads on one card) equal to ``run`` on two sequences, profiled.
    Returns the launches of the two runs."""
    import numpy as np
    import torch

    from stemseg_tpu_torch.config import load_preset, merge, save_config
    from stemseg_tpu_torch.inference import main as cli
    from stemseg_tpu_torch.inference.windows import get_subsequence_frames
    from stemseg_tpu_torch.ops import launch_counts, lsap, reset_launch_counts
    from stemseg_tpu_torch.utils.timer import Timer

    root = os.path.join(out_root, "DP")
    env, sets = write_eval_datasets(os.path.join(root, "data"), shapes={})
    cfg = merge(load_preset("davis_2"), {"clustering": {"min_seediness_prob": 0.05}})
    model = build_random_model(cfg, synthetic_frames(2, 480, 854, MAIN_SEED), MAIN_SEED)
    pth = os.path.join(root, "model", "davis.pth")
    os.makedirs(os.path.dirname(pth))
    torch.save({"model": model.state_dict()}, pth)
    save_config(cfg, os.path.join(root, "model", "config.yaml"))
    del model
    torch.cuda.empty_cache()
    n_windows = sum(len(get_subsequence_frames(
        len(s["image_paths"]), cfg.input.num_frames, cfg.data.davis.inference_frame_overlap))
        for s in sets["davis"])

    prev_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    outs, launches, walls = {}, {}, {}
    try:
        for name, extra in (("serial", []), ("data_parallel", ["--data_parallel"])):
            outs[name] = os.path.join(root, name)

            def run(extra=extra, out=outs[name]):
                Timer.reset()
                reset_launch_counts()
                lsap.reset_launch_counts()
                cli.main([pth, "-o", out, "--dataset", "davis", "--bf16", *extra])

            t0 = time.perf_counter()
            if name == "data_parallel":
                launches[name] = profiled_launches(
                    run, lambda: {"cluster_kernel": n_windows, "lsa_kernel": n_windows},
                    "(c) --data_parallel")
                host = dict(launch_counts, **lsap.launch_counts)
                if host["cluster_points_reference"] or host["lsa_masked_reference"] \
                        or not host["cluster_points_tiled"] or not host["lsa_masked"]:
                    raise AssertionError(f"(c) --data_parallel host launches {host}")
            else:
                run()
            walls[name] = time.perf_counter() - t0
    finally:
        for k, v in prev_env.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    n_files = 0
    for dirpath, _, files in os.walk(os.path.join(outs["serial"], "results")):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), outs["serial"])
            with open(os.path.join(outs["serial"], rel), "rb") as a, \
                    open(os.path.join(outs["data_parallel"], rel), "rb") as b:
                if a.read() != b.read():
                    raise AssertionError(f"(c) {rel} differs between the serial and the "
                                         "--data_parallel CLI")
            n_files += 1
    if n_files != sum(len(s["image_paths"]) for s in sets["davis"]):
        raise AssertionError(f"(c) {n_files} PNGs")
    log(f"  (c) --data_parallel --bf16 over {torch.cuda.device_count()} card(s): {n_files} "
        f"PNGs byte-equal to the serial CLI's; {n_windows} windows, device launches "
        f"{launches['data_parallel']}; wall serial {walls['serial']:.3f} s, data parallel "
        f"(profiled) {walls['data_parallel']:.3f} s")

    # run_batch: two pipelines on one card, driven from two host threads
    model = cli.load_model(cfg, pth, dtype=torch.bfloat16)
    tg = make_track_generator(cfg, "davis", model, os.path.join(root, "rb"), use_fused=True)
    seqs = [synthetic_frames(26, 480, 854, seed=MAIN_SEED),
            synthetic_frames(30, 480, 854, seed=MAIN_SEED + 1)]
    schedules = [tg._schedule(len(f), f.shape[1:3]) for f in seqs]
    kw = dict(seediness_fg_threshold=tg.seediness_thresh, resize_hw=schedules[0][1])
    want = [tg.fused.run(f, w, **kw) for f, (w, _) in zip(seqs, schedules)]
    windows = [w for w, _ in schedules]
    expect = sum(len(w) for w in windows)
    got = {}

    def batch():
        got["out"] = tg.fused.run_batch(seqs, windows, ["cuda:0", "cuda:0"], **kw)

    for attempt in ("first (slot 1 warms and captures)", "second (replays)"):
        t0 = time.perf_counter()
        launches[f"run_batch {attempt}"] = profiled_launches(
            batch, lambda: {"cluster_kernel": expect, "lsa_kernel": expect},
            f"(c) run_batch {attempt}")
        for (wl, wc, wt, wf, _), (gl, gc, gt, gf, _) in zip(want, got["out"]):
            if not (np.array_equal(wl, gl) and wc == gc and wt == gt
                    and np.array_equal(wf, gf)):
                raise AssertionError(f"(c) run_batch {attempt}: differs from run")
        log(f"  (c) run_batch over cuda:0 x 2, {attempt}: labels, counts, lifetimes and fg "
            f"masks equal to run on {[len(f) for f in seqs]} frames; device launches "
            f"{launches[f'run_batch {attempt}']} ({time.perf_counter() - t0:.3f} s profiled)")
    del tg, model
    torch.cuda.empty_cache()
    return {"cluster_points_single": 0,
            "cluster_points_tiled": sum(v["cluster_kernel"] for v in launches.values()),
            "lsa_masked": sum(v["lsa_kernel"] for v in launches.values())}


def jax_session_phase(out_root):
    """Phase 22 (d): phase 11's path T checkpoint at step 6 written as a
    whole JAX SGD session (``write_jax_session`` with the config: momentum
    as optax's trace, the schedule's count, ``MultiSteps``), restored by
    ``--restore_session``: weights, momentum buffers and LR schedule bitwise
    equal to resuming the ``.pth``; then 2 steps each, held bitwise."""
    import shutil

    import torch

    from stemseg_tpu_torch.training.checkpoint import find_latest_checkpoint

    pth = find_latest_checkpoint(os.path.join(out_root, "T"))
    step = int(os.path.basename(pth)[:6])
    cfg = training_cfg("davis_1", step + 2)
    ckpt = os.path.join(out_root, "T22_jax", f"{step:06d}.ckpt")
    os.makedirs(os.path.dirname(ckpt))
    t0 = time.perf_counter()
    n_bytes = write_jax_session(pth, step, ckpt, cfg=training_cfg("davis_1", step))
    log(f"  (d) {os.path.basename(pth)} as a whole JAX session: {n_bytes / 1e6:.1f} MB in "
        f"{time.perf_counter() - t0:.3f} s")
    os.makedirs(os.path.join(out_root, "T22_resume"))
    shutil.copy(pth, os.path.join(out_root, "T22_resume"))
    finals = {}
    with DeterministicTraining() as det:
        for kind, extra in (("pth", []), ("ckpt", ["--restore_session", ckpt])):
            trainer = new_trainer(cfg, os.path.join(out_root, f"T22_{kind}_resume"
                                                    if kind == "ckpt" else "T22_resume"), *extra)
            opt = trainer.optimizer.state_dict()
            finals[f"{kind}_restored"] = (cpu_state(trainer.model), {
                i: s["momentum_buffer"].cpu() for i, s in opt["state"].items()},
                trainer.scheduler.state_dict(), trainer.elapsed_iterations,
                [g["lr"] for g in trainer.optimizer.param_groups])
            trainer.start()
            finals[kind] = cpu_state(trainer.model)
            if trainer.elapsed_iterations != step + 2:
                raise AssertionError(f"(d) {kind}: ended at {trainer.elapsed_iterations}")
            del trainer
            torch.cuda.empty_cache()
    a, b = finals["pth_restored"], finals["ckpt_restored"]
    if not (compare_states(a[0], b[0])[0] and a[1].keys() == b[1].keys()
            and all(torch.equal(a[1][i], b[1][i]) for i in a[1]) and a[2] == b[2]
            and a[3] == b[3] == step and a[4] == b[4]):
        raise AssertionError(f"(d) the restored JAX session differs from the .pth: steps "
                             f"{a[3]}/{b[3]}, lr {a[4]}/{b[4]}")
    log(f"  (d) restored from the .ckpt: weights, {len(a[1])} momentum buffers, LR schedule "
        f"(last_epoch {a[2]['last_epoch']}, lr {a[4][0]}) and step {step} bitwise equal to "
        "the .pth's")
    return hold_bitwise(f"(d) weights after steps {step + 1}-{step + 2}, .ckpt against .pth",
                        finals["ckpt"], finals["pth"], det)


def start_sustained(out_root):
    """Phase 22 (e), started: ``tools.train_sustained`` on path T in bf16,
    12 steps, SIGINT after step 6, the relaunch resuming (a subprocess,
    beside (a) and (d), whose checks are numerical)."""
    cmd = [sys.executable, "-m", "stemseg_tpu_torch.tools.train_sustained", "--model_dir",
           os.path.join(out_root, "S22"), "--bf16", "--steps", "12", "--interrupt_at", "6",
           "--k", "3", "--num_cpu_workers", str(TRAIN_WORKERS), "--timeout", "300"]
    return subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=dict(os.environ, PYTHONPATH=HERE)), time.perf_counter()


def finish_sustained(out_root, started):
    """Phase 22 (e), checked: exit 0, the steps stitched, the loss of the
    last 3 steps below the first 3; its summary."""
    proc, t0 = started
    try:
        out = proc.communicate(timeout=700)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"(e) train_sustained exited {proc.returncode}:\n{out[-5000:]}")
    with open(os.path.join(out_root, "S22", "sustained_summary.json")) as fh:
        s = json.load(fh)
    if not s["stitched"] or s["failures"]:
        raise AssertionError(f"(e) summary {s}")
    log(f"  (e) train_sustained --bf16 12 steps, SIGINT at 6 (beside (a) and (d)): checkpoint "
        f"{os.path.basename(s['interrupted_checkpoint'])}, stitched; loss first {s['k']} "
        f"{s['loss_first_k']:.5f}, last {s['k']} {s['loss_last_k']:.5f}; sessions " + "; ".join(
            f"{x['steps']} steps, {x.get('steps_per_s', float('nan')):.3f} steps/s steady, "
            f"loader wait first {x['first_step_wait_s']:.3f} s then mean "
            f"{x.get('loader_wait_mean_s', float('nan')) * 1e3:.3f} ms, wall {x['wall_s']:.1f} s"
            for x in s["sessions"]) + f"; tool wall {wall:.1f} s")
    return {k: s[k] for k in ("loss_first_k", "loss_last_k", "sessions")}


def dist_phase(out_root, smi):
    """Phase 22: (b) and (c), timed, alone; then (e) in a subprocess beside
    (a) and (d). Returns the launches of (c)."""
    import torch

    torch.cuda.empty_cache()  # the ranks of (b) need the card's memory
    log("  (b) two gloo ranks sharing the card against one process")
    two_rank_phase(out_root)
    log("  (c) --data_parallel on path A in bf16; run_batch over cuda:0 x 2")
    launches = data_parallel_phase(out_root, smi)
    log("  (e) train_sustained, 12 bf16 steps, SIGINT at 6: started")
    sustained = start_sustained(out_root)
    try:
        log("  (a) path T, 2 steps: the trainer at world 1 on NCCL against the plain trainer")
        world_one_phase(out_root)
        log("  (d) a whole JAX session restored by --restore_session")
        jax_session_phase(out_root)
    except BaseException:
        # let the tool end (it stops its own trainer), then report what failed
        proc = sustained[0]
        with contextlib.suppress(subprocess.TimeoutExpired):
            proc.communicate(timeout=700)
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        raise
    finish_sustained(out_root, sustained)
    return launches


# -- phase 23: data parallelism on four cards (``--four-cards``) --------------

FOUR_CARDS = 4  # the cards of one host that phase 23 needs
CLI_WORKERS = 8  # the trainer CLI's --num_cpu_workers default, kept on every rank
WORLD_STEPS = 24  # a world-4 timing run: the workers' first queue (16 batches), then 8
ONE_CARD_STEPS = 14  # one process at the preset (2 micro-steps a step): 8 in the queue, 6
PHASE23_TIMEOUT = 360  # seconds a subprocess of phase 23 may take


def card_env(rank, world, port):
    """The variables torchrun gives rank ``rank`` of ``world`` on one host:
    each rank on its own card, ``cuda:rank``."""
    return {"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
            "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}


def card_worker_argv(spec_path):
    """The command of one rank of phase 23 (b), (c) and (e)."""
    return [sys.executable, os.path.abspath(__file__), "--card-worker", spec_path]


def stop_group(proc):
    """Kills what is left of ``proc``'s process group (its loader workers
    included)."""
    import signal

    with contextlib.suppress(ProcessLookupError, PermissionError):
        os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()


def run_ranks(argv, world, log_dir, env_of=card_env, timeout=PHASE23_TIMEOUT):
    """Runs ``world`` processes of ``argv`` as one process group (rank
    ``r``'s variables ``env_of(r, world, port)``), each in a session of its
    own with its output in ``log_dir/rank<r>.log``. When one exits non-zero,
    or the time is up, every one is killed. Returns their outputs; raises
    unless every rank exited 0."""
    port = free_port()
    logs = [open(os.path.join(log_dir, f"rank{r}.log"), "w") for r in range(world)]
    procs = [subprocess.Popen(argv, env=dict(os.environ, **env_of(r, world, port)), cwd=HERE,
                              stdout=logs[r], stderr=subprocess.STDOUT, start_new_session=True)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            stop_group(p)
        for f in logs:
            f.close()
    outs = []
    for r in range(world):
        with open(os.path.join(log_dir, f"rank{r}.log")) as fh:
            outs.append(fh.read())
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("ranks failed or ran past their time:\n" + "\n".join(
            f"rank {r} exit {p.returncode}:\n{out[-3000:]}"
            for r, (p, out) in enumerate(zip(procs, outs))))
    return outs


def differ_from_rank0(model):
    """Names of ``model``'s parameters and buffers on this rank that are not
    bitwise equal to rank 0's (broadcast one tensor at a time)."""
    import torch
    import torch.distributed as dist

    differ = []
    for name, t in (*model.named_parameters(), *model.named_buffers()):
        theirs = t.detach().clone()
        dist.broadcast(theirs, src=0)
        if not torch.equal(theirs, t.detach()):
            differ.append(name)
    return differ


def timed_trainer_run(cfg, model_dir, workers, device):
    """A trainer run of ``cfg`` on ``device`` (under a process group, each
    rank's own card) with ``workers`` loader workers. Returns the trainer
    and its seconds a step after the workers' first queue (``2 * workers``
    micro-batches), the loader's wait per micro-batch after it, and peak
    device memory."""
    import math

    import torch

    trainer = new_trainer(cfg, model_dir, "--num_cpu_workers", str(workers), "--device", device)
    dev = trainer.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    trainer.start()
    queue = 2 * workers
    intervals = steady_intervals(trainer, math.ceil(queue / trainer.accumulate_steps))
    out = {"steps": trainer.elapsed_iterations, "accumulate_steps": trainer.accumulate_steps,
           "s_per_step": intervals, "first_wait_s": trainer.loader_waits[0],
           "waits_ms": [w * 1e3 for w in trainer.loader_waits[queue:]],
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30
           if dev.type == "cuda" else 0.0}
    return trainer, out


def card_rank_worker(spec_path):
    """One rank of phase 23 (b), (c) and (e), started by ``card_ranks_phase``
    on its own card (NCCL, ``cuda:RANK``), path T at ``max_samples_per_chip``
    1: its device and its model's on that card; the gradient bucket's
    all-reduce alone (as the step makes it, and one flat ``dist.all_reduce``)
    and the small int all-reduce, timed; the first micro-step's loss terms
    and gradient (summed over the ranks); 2 optimizer steps, after which
    every tensor equals rank 0's bit for bit; then a timed fp32 run and a
    timed bf16 run (``training.mixed_precision``) of ``WORLD_STEPS`` steps
    each with the CLI's loader workers, every loss finite and every tensor
    equal to rank 0's after each. Each rank saves its numbers as
    ``out.RANK``; rank 0 adds the gradient and its weights."""
    import torch
    import torch.distributed as dist

    from stemseg_tpu_torch.config import merge
    from stemseg_tpu_torch.parallel import all_reduce_sum_
    from stemseg_tpu_torch.training.loader import to_device
    from stemseg_tpu_torch.training.step import TrainStep
    from stemseg_tpu_torch.utils.distributed import all_reduce_ints, synchronize

    with open(spec_path) as fh:
        spec = json.load(fh)
    world, root, device = spec["world"], spec["root"], spec["device"]
    trainer = new_trainer(training_cfg("davis_1", 3), os.path.join(root, "T23_probe"),
                          "--device", device)
    rank, dev = trainer.rank, trainer.device
    cuda = dev.type == "cuda"
    want = ((world, "nccl", torch.device("cuda", rank)) if cuda
            else (world, "gloo", torch.device("cpu")))
    placed = [n for n, t in (*trainer.model.named_parameters(), *trainer.model.named_buffers())
              if t.device != dev]
    if (trainer.world, dist.get_backend(), dev) != want or placed \
            or (cuda and torch.cuda.current_device() != rank):
        raise AssertionError(f"rank {rank}: world {trainer.world}, backend "
                             f"{dist.get_backend()}, device {dev}, {len(placed)} tensors "
                             f"elsewhere {placed[:3]}")

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def timed(fn):
        synchronize()
        sync()
        t0 = time.perf_counter()
        result = fn()
        sync()
        return (time.perf_counter() - t0) * 1e3, result

    out = {"rank": rank, "device": str(dev)}
    params = [p for p in trainer.model.parameters() if p.requires_grad]
    bucket_ms, flat_ms, ints_ms = [], [], []
    for _ in range(6):
        bucket = [torch.ones_like(p) for p in params]
        bucket_ms.append(timed(lambda: all_reduce_sum_(bucket))[0])
        if not all(bool((b == world).all()) for b in bucket):
            raise AssertionError(f"rank {rank}: the bucket's all-reduce did not sum {world} "
                                 "ranks")
    del bucket
    flat = torch.empty(sum(p.numel() for p in params), device=dev)
    for _ in range(6):
        flat.fill_(1.0)
        flat_ms.append(timed(lambda: dist.all_reduce(flat))[0])
        if not bool((flat == world).all()):
            raise AssertionError(f"rank {rank}: the flat all-reduce did not sum {world} ranks")
    del flat
    for _ in range(21):
        ms, got = timed(lambda: all_reduce_ints([rank, 1], dev))
        ints_ms.append(ms)
        if got != (world * (world - 1) // 2, world):
            raise AssertionError(f"rank {rank}: all_reduce_ints gave {got}")
    out.update(bucket_mb=sum(p.numel() * p.element_size() for p in params) / 1e6,
               all_reduce_bucket_ms=bucket_ms[1:], all_reduce_flat_ms=flat_ms[1:],
               all_reduce_ints_ms=ints_ms[1:])

    # (b): the first micro-step (a probe that does not update), then 2 steps
    batches = iter(trainer.make_loader(0))
    probe = TrainStep(trainer.model, trainer.cfg, trainer.optimizer, trainer.scheduler,
                      accumulate_steps=2)
    out["metrics"] = {k: float(v) for k, v in probe(to_device(next(batches), dev)).items()}
    if rank == 0:
        out["grads"] = {n: p.grad.detach().cpu().clone()
                        for n, p in trainer.model.named_parameters() if p.requires_grad}
    trainer.optimizer.zero_grad(set_to_none=True)
    out["step_s"] = []
    for _ in range(2):
        ms, _ = timed(lambda: [trainer.train_step(to_device(next(batches), dev))
                               for _ in range(trainer.accumulate_steps)])
        out["step_s"].append(ms / 1e3)
    out["differ"] = {"2 steps": differ_from_rank0(trainer.model)}
    if rank == 0:
        out["state"] = cpu_state(trainer.model)
    out["peak_gib_probe"] = torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0
    del trainer, probe, batches
    if cuda:
        torch.cuda.empty_cache()

    # (c) and (e): timed runs with the CLI's loader workers, fp32 then bf16
    for kind, over in (("fp32", {}), ("bf16", {"mixed_precision": True})):
        cfg = merge(training_cfg("davis_1", WORLD_STEPS), {"training": over})
        trainer, out[kind] = timed_trainer_run(cfg, os.path.join(root, f"T23_{kind}"),
                                               spec["workers"], device)
        out["differ"][kind] = differ_from_rank0(trainer.model)
        if rank == 0:
            out[kind]["losses"] = [r["total"] for r in read_metrics(trainer.model_dir,
                                                                     DIST_KEYS)]
        del trainer
        if cuda:
            torch.cuda.empty_cache()
    torch.save(out, f"{spec['out']}.{rank}")
    dist.destroy_process_group()


# the first convolution of each trunk block of the heads: its weight
# gradient sums over a whole FPN map (a GroupNorm after it), and cuDNN's float32
# algorithm for it differs by batch size (phase 23 (b))
TRUNK_FIRST_CONVS = tuple(f"{head}.block_{s}.0" for head in ("embedding_head", "seediness_head")
                          for s in ("32x", "16x", "8x", "4x"))


def exact_weight_grads(model, names, run):
    """Runs ``run()`` (one forward and backward of ``model``) with the input
    and output gradient of each 3D convolution of ``names`` recorded, and
    returns ({name + ".weight": its weight gradient recomputed from them in
    float64, on the CPU}, what ``run`` returned)."""
    import torch

    modules = dict(model.named_modules())
    names = [n for n in names if n in modules]
    saved, hooks = {}, []
    for n in names:
        hooks.append(modules[n].register_forward_hook(
            lambda mod, inp, out, n=n: saved.__setitem__((n, "x"), inp[0].detach())))
        hooks.append(modules[n].register_full_backward_hook(
            lambda mod, gin, gout, n=n: saved.__setitem__((n, "dy"), gout[0].detach())))
    try:
        result = run()
    finally:
        for h in hooks:
            h.remove()
    exact = {}
    for n in names:
        m, x, dy = modules[n], saved.pop((n, "x")), saved.pop((n, "dy"))
        exact[n + ".weight"] = torch.nn.grad.conv3d_weight(
            x.double(), m.weight.shape, dy.double(), stride=m.stride, padding=m.padding,
            dilation=m.dilation, groups=m.groups).cpu()
        del x, dy
    return exact, result


def card_ranks_phase(root, world, device="cuda"):
    """Phase 23 (b), (c) and (e) of training: ``world`` ranks of
    ``card_rank_worker``, then in this process on the first card path T at
    ``max_samples_per_chip`` ``world`` over the same clips (the same global
    stream): (i) its first micro-step's loss terms within 1e-4 relative of
    the ranks'; its whole gradient within a relative L2 of 1e-3 of the
    ranks', with the weight gradients of ``TRUNK_FIRST_CONVS`` recomputed
    in float64 from this run's own inputs and output gradients (cuDNN's
    float32 algorithm for them at a batch of 4 clips is off float64 by more
    than the ranks' at 1 clip), the raw float32 difference, the worst leaf
    and each of those leaves against float64 printed; (ii) the same clips
    one at a time (``per_clip_reference``, the ranks' shapes): loss terms
    within 1e-6, every leaf within 1e-4; after 2 optimizer steps the
    weights within a per-leaf relative L2 of 1e-3 of rank 0's, every rank's
    bitwise equal to rank 0's after every run; (c) the bf16 losses finite;
    and one process at the preset (2 micro-steps of 1 clip) timed as the
    ranks are. Every number is printed before a check raises. Returns the
    numbers."""
    import math

    import torch

    from stemseg_tpu_torch.config import merge
    from stemseg_tpu_torch.training.loader import to_device
    from stemseg_tpu_torch.training.step import TrainStep

    log_dir = os.path.join(root, "T23_ranks")
    os.makedirs(log_dir)
    spec = {"world": world, "root": root, "out": os.path.join(log_dir, "out.pt"),
            "workers": CLI_WORKERS, "device": device}
    spec_path = os.path.join(log_dir, "spec.json")
    with open(spec_path, "w") as fh:
        json.dump(spec, fh)
    t0 = time.perf_counter()
    run_ranks(card_worker_argv(spec_path), world, log_dir)
    ranks_wall = time.perf_counter() - t0
    got = [torch.load(f"{spec['out']}.{r}", weights_only=True) for r in range(world)]
    rank0 = got[0]

    cfg = merge(training_cfg("davis_1", 3), {"training": {"max_samples_per_chip": world}})
    trainer = new_trainer(cfg, os.path.join(root, "T23_one"), "--device", device)
    batches = iter(trainer.make_loader(0))
    first = to_device(next(batches), trainer.device)
    if first["images"].shape[0] != world:
        raise AssertionError(f"(b) a batch of {first['images'].shape[0]}")
    probe = TrainStep(trainer.model, cfg, trainer.optimizer, trainer.scheduler,
                      accumulate_steps=2)
    exact, out = exact_weight_grads(trainer.model, TRUNK_FIRST_CONVS, lambda: probe(first))
    metrics = {k: float(v) for k, v in out.items()}
    params = [n for n, p in trainer.model.named_parameters() if p.requires_grad]
    grads = {n: p.grad.detach().cpu() for n, p in trainer.model.named_parameters()
             if p.requires_grad}
    trainer.optimizer.zero_grad(set_to_none=True)
    split_grads, split_metrics = per_clip_reference(trainer.model, cfg, first, world)
    for _ in range(2):
        for _ in range(trainer.accumulate_steps):
            trainer.train_step(to_device(next(batches), trainer.device))
    state = cpu_state(trainer.model)
    del trainer, probe, first, batches
    torch.cuda.empty_cache()
    trainer, single = timed_trainer_run(training_cfg("davis_1", ONE_CARD_STEPS),
                                        os.path.join(root, "T23_w1"), CLI_WORKERS, device)
    del trainer
    torch.cuda.empty_cache()

    def whole(a, b):
        fa, fb = (torch.cat([d[n].reshape(-1).double() for n in params]) for d in (a, b))
        return float(torch.linalg.vector_norm(fa - fb) / torch.linalg.vector_norm(fb))

    def leaf(a, b):
        return compare_states({"leaf": a}, {"leaf": b})[1][0]

    raw = whole(rank0["grads"], grads)
    _, worst = compare_states(rank0["grads"], grads)
    refined = dict(grads, **exact)
    whole_refined = whole(rank0["grads"], refined)
    _, worst_refined = compare_states(rank0["grads"], refined)
    over = sorted(n for n in params if leaf(rank0["grads"][n], grads[n]) > 1e-3)
    _, worst_split = compare_states(rank0["grads"], split_grads)
    _, worst_state = compare_states(rank0["state"], state)
    terms_equal = all(g["metrics"] == rank0["metrics"] for g in got)
    log(f"  (b) {world} ranks at per_chip 1 against one process at per_chip {world}: loss terms "
        f"{', '.join(f'{k} {rank0['metrics'][k]:.6f}/{v:.6f}' for k, v in metrics.items())}; "
        f"the whole gradient {raw:.3e} in float32, worst leaf {worst[0]:.3e} ({worst[1]}), "
        f"{len(over)} leaves above 1e-3 {over}; with the one process's "
        f"{len(exact)} trunk-block first convolutions' weight gradients in float64: whole "
        f"{whole_refined:.3e}, worst leaf {worst_refined[0]:.3e} ({worst_refined[1]})")
    for n, w64 in exact.items():
        log(f"  (b) {n} against its float64 weight gradient: {world} ranks "
            f"{leaf(rank0['grads'][n], w64):.3e}, one process at per_chip {world} "
            f"{leaf(grads[n], w64):.3e}, one clip at a time {leaf(split_grads[n], w64):.3e}")
    log(f"  (b) against the same clips one at a time in one process (the ranks' shapes): worst "
        f"leaf {worst_split[0]:.3e} ({worst_split[1]}); weights after 2 steps against one "
        f"process: worst leaf {worst_state[0]:.3e} ({worst_state[1]}); the summed loss terms "
        f"and grad_norm equal on every rank: {terms_equal}")
    res = {"ranks_wall_s": ranks_wall, "whole_grad_rel_l2": raw,
           "whole_grad_rel_l2_float64_convs": whole_refined, "worst_grad": worst,
           "worst_grad_split": worst_split, "worst_state": worst_state, "world_1": single,
           **{k: [g[k] for g in got] for k in ("all_reduce_bucket_ms", "all_reduce_flat_ms",
                                                "all_reduce_ints_ms", "step_s",
                                                "peak_gib_probe", "fp32", "bf16")},
           "bucket_mb": rank0["bucket_mb"]}
    report_training_numbers(res, world)

    failures = []
    differ = {kind: {r: g["differ"][kind] for r, g in enumerate(got) if g["differ"][kind]}
              for kind in rank0["differ"]}
    if any(differ.values()):
        failures.append(f"ranks whose tensors differ from rank 0's: {differ}")
    if [g["device"] for g in got] != [f"cuda:{r}" if device == "cuda" else device
                                      for r in range(world)]:
        failures.append(f"rank devices {[g['device'] for g in got]}")
    failures += [f"(i) {k} {rank0['metrics'][k]} on {world} ranks, {v} in one process"
                 for k, v in metrics.items()
                 if abs(rank0["metrics"][k] - v) > 1e-4 * max(abs(v), 1e-6)]
    failures += [f"(ii) {k} {rank0['metrics'][k]} on {world} ranks, {v} one clip at a time"
                 for k, v in split_metrics.items()
                 if abs(rank0["metrics"][k] - v) > 1e-6 * max(abs(v), 1e-6)]
    if whole_refined > 1e-3:
        failures.append(f"(i) the whole gradient {whole_refined:.3e} against one process")
    if worst_split[0] > 1e-4:
        failures.append(f"(ii) worst leaf {worst_split}")
    if worst_state[0] > 1e-3:
        failures.append(f"weights after 2 steps: worst leaf {worst_state}")
    failures += [f"(c) {kind}: losses {rank0[kind]['losses']}" for kind in ("fp32", "bf16")
                 if not all(math.isfinite(v) for v in rank0[kind]["losses"])]
    if failures:
        raise AssertionError("(b)/(c): " + "; ".join(failures))
    log(f"  (b), (c): every rank bitwise equal to rank 0 after the 2 steps, the fp32 and the "
        f"bf16 runs; every loss finite")
    return res


def report_training_numbers(res, world):
    """Phase 23 (e), training: the collectives, s a step and clips/s at
    world 1 and ``world``, the scaling, loader waits and peak memory."""
    from statistics import median

    def waits(run):
        w = run["waits_ms"]
        return (f"{sum(w) / len(w):.3f}", f"{max(w):.3f}") if w else ("n/a", "n/a")

    mb = res["bucket_mb"]
    flat = [median(ms) for ms in res["all_reduce_flat_ms"]]
    bus = 2 * (world - 1) / world * mb / 1e3 / (max(flat) / 1e3) if world > 1 else 0.0
    log(f"  (e) all-reduce of the fp32 gradient ({mb:.1f} MB), median ms a rank: one flat "
        f"dist.all_reduce {['%.3f' % m for m in flat]} (bus bandwidth {bus:.1f} GB/s at the "
        f"slowest rank), as the step makes it (cat, all_reduce, copy back) "
        f"{['%.3f' % median(ms) for ms in res['all_reduce_bucket_ms']]}; the small int "
        f"all-reduce (to the host) {['%.3f' % median(ms) for ms in res['all_reduce_ints_ms']]}")
    w1 = res["world_1"]
    s1 = median(w1["s_per_step"])
    clips1 = 2 / s1
    log(f"  (e) world 1 (one process, 2 micro-steps of 1 clip, {CLI_WORKERS} loader workers): "
        f"{['%.4f' % s for s in w1['s_per_step']]} s a step, median {s1:.4f} s, "
        f"{clips1:.3f} clips/s; loader wait after the first queue mean / max ms {waits(w1)}; "
        f"peak {w1['peak_gib']:.2f} GiB")
    for kind in ("fp32", "bf16"):
        runs = res[kind]
        s = max(median(r["s_per_step"]) for r in runs)
        clips = world / s
        log(f"  (e) world {world} {kind} ({runs[0]['accumulate_steps']} micro-step of 1 clip a "
            f"card, {CLI_WORKERS} loader workers a rank): s a step by rank "
            f"{[['%.4f' % x for x in r['s_per_step']] for r in runs]}; median {s:.4f} s, "
            f"{clips:.3f} clips/s" + (f", {clips / clips1:.2f}x world 1's fp32"
                                      if kind == "fp32" else "") +
            f"; loader wait after the first queue, mean / max ms by rank "
            f"{[waits(r) for r in runs]}; first wait s "
            f"{['%.3f' % r['first_wait_s'] for r in runs]}; peak GiB a rank "
            f"{['%.2f' % r['peak_gib'] for r in runs]}")
    log(f"  (b) the 2 timed optimizer steps by rank {res['step_s']} s; peak GiB a rank "
        f"{['%.2f' % g for g in res['peak_gib_probe']]}; ranks' wall "
        f"{res['ranks_wall_s']:.1f} s")


def rank_pid(parent, rank):
    """The pid of the child of ``parent`` whose environment holds
    ``RANK=rank`` (a rank that torch.distributed.run started), or None."""
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as fh:
                if int(fh.read().rsplit(")", 1)[1].split()[1]) != parent:
                    continue
            with open(f"/proc/{d}/environ", "rb") as fh:
                env = fh.read().split(b"\0")
        except OSError:
            continue
        if f"RANK={rank}".encode() in env:
            return int(d)
    return None


def torchrun_session(cmd, log_path, interrupt_rank=None):
    """One ``torch.distributed.run`` session, its ranks' output teed with
    ``[default<r>]:`` prefixes; with ``interrupt_rank``, a SIGINT to that
    rank's process alone once rank 0 logs step 2. Killed, with its process
    group, after ``PHASE23_TIMEOUT``. Returns (exit code, {rank: lines},
    wall seconds)."""
    import signal
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            cwd=HERE, start_new_session=True,
                            env=dict(os.environ, PYTHONPATH=HERE, PYTHONUNBUFFERED="1"))
    watchdog = threading.Timer(PHASE23_TIMEOUT, stop_group, (proc,))
    watchdog.daemon = True
    watchdog.start()
    lines, sent = [], False
    try:
        with open(log_path, "a") as fh:
            for line in proc.stdout:
                lines.append(line.rstrip("\n"))
                fh.write(line)
                if (interrupt_rank is not None and not sent
                        and line.startswith("[default0]:it 2/")):
                    pid = None
                    for _ in range(50):
                        pid = rank_pid(proc.pid, interrupt_rank)
                        if pid is not None:
                            break
                        time.sleep(0.1)
                    if pid is None:
                        raise AssertionError(f"(a) no process of rank {interrupt_rank}")
                    os.kill(pid, signal.SIGINT)
                    sent = True
                    log(f"  (a) SIGINT to rank {interrupt_rank} (pid {pid}) after rank 0 logged "
                        "step 2")
        rc = proc.wait()
    finally:
        watchdog.cancel()
        stop_group(proc)
    by_rank = {}
    for line in lines:
        if line.startswith("[default") and "]:" in line:
            r, text = line[len("[default"):].split("]:", 1)
            by_rank.setdefault(int(r), []).append(text)
    if rc != 0 or (interrupt_rank is not None and not sent):
        raise AssertionError(f"(a) torch.distributed.run exited {rc}" + (
            "" if sent or interrupt_rank is None else " before rank 0 logged step 2") +
            ":\n" + "\n".join(lines[-60:]))
    return by_rank, time.perf_counter() - t0


def torchrun_phase(root, world, device="cuda"):
    """Phase 23 (a): path T through the trainer CLI as users launch it,
    ``python -m torch.distributed.run --standalone --nproc_per_node
    <world> -m stemseg_tpu_torch.training.main`` (NCCL, the CLI's loader
    workers), 4 optimizer steps: a SIGINT to one rank (rank 2 of 4) after
    step 2 stops every rank after the same step, below 4, and rank 0 alone
    saves; a relaunch resumes there and reaches step 4; ``steps.jsonl`` and
    ``metrics.jsonl`` hold each step 1..4 once, every loss finite."""
    from stemseg_tpu_torch.config import save_config
    from stemseg_tpu_torch.training.checkpoint import find_latest_checkpoint

    cfg_path = os.path.join(root, "T23a.yaml")
    save_config(training_cfg("davis_1", 4), cfg_path)
    model_dir = os.path.join(root, "T23a")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(world), "--tee", "3", "-m", "stemseg_tpu_torch.training.main", "--model_dir",
           model_dir, "--cfg", cfg_path, "--display_interval", "1", "--summary_interval", "1",
           "--device", device]
    log_path = os.path.join(root, "T23a.log")
    target = min(2, world - 1)
    by_rank, wall1 = torchrun_session(cmd, log_path, interrupt_rank=target)
    if sorted(by_rank) != list(range(world)):
        raise AssertionError(f"(a) output of ranks {sorted(by_rank)}")
    stopped = {}
    for r, lines in by_rank.items():
        marks = [int(t.split("after iteration ", 1)[1].split(":")[0]) for t in lines
                 if t.startswith("Interrupt signal received after iteration ")]
        if len(marks) != 1:
            raise AssertionError(f"(a) rank {r}: interrupt lines {marks}")
        stopped[r] = marks[0]
    saves = {r: [t.split(": ", 1)[1] for t in lines if t.startswith("Checkpoint saved to")]
             for r, lines in by_rank.items()}
    step = stopped[0]
    ckpts = sorted(f for f in os.listdir(model_dir) if f.endswith(".pth"))
    if set(stopped.values()) != {step} or not 2 <= step < 4 or len(saves[0]) != 1 \
            or any(saves[r] for r in range(1, world)) or ckpts != [f"{step:06d}.pth"]:
        raise AssertionError(f"(a) stopped after {stopped}, saves {saves}, checkpoints {ckpts}")
    log(f"  (a) session 1: every rank stopped after step {step}, rank 0 alone saved {ckpts[0]} "
        f"({wall1:.1f} s)")

    by_rank, wall2 = torchrun_session(cmd, log_path)
    for r in range(world):
        text = "\n".join(by_rank.get(r, []))
        if f"Restoring session from {saves[0][0]}" not in text or \
                f"Commencing/resuming training from iteration {step + 1}" not in text:
            raise AssertionError(f"(a) session 2, rank {r}: no resume from step {step}:\n"
                                 f"{text[-2000:]}")
    if not any(t.startswith("Training complete") for t in by_rank[0]) \
            or os.path.basename(find_latest_checkpoint(model_dir)) != "000004.pth":
        raise AssertionError("(a) session 2 did not reach step 4")
    with open(os.path.join(model_dir, "logs", "steps.jsonl")) as fh:
        steps = [json.loads(line)["step"] for line in fh if line.strip()]
    records = read_metrics(model_dir, DIST_KEYS)
    if steps != [1, 2, 3, 4] or [r["step"] for r in records] != [1, 2, 3, 4]:
        raise AssertionError(f"(a) steps.jsonl {steps}, metrics.jsonl "
                             f"{[r['step'] for r in records]}")
    log(f"  (a) session 2: every rank resumed at step {step + 1}, rank 0 reached step 4 "
        f"({wall2:.1f} s); steps.jsonl and metrics.jsonl hold steps 1-4 once; totals "
        f"{['%.5f' % r['total'] for r in records]}")
    return {"stopped_after": step, "session_walls_s": [wall1, wall2],
            "totals": [r["total"] for r in records]}


def kernels_on_each_card(ops, world):
    """Phase 23: on each card, ``cluster_points_single`` at 207,360 points
    and ``cluster_points_tiled`` at 878,592 against the plain version on
    that card (phase 3's rule), ``lsa_masked`` against its plain version on
    40 fuzz cases, exactly; each output on its inputs' card, and each
    clustering workspace on the card it is kept for."""
    import numpy as np
    import torch

    from stemseg_tpu_torch.ops import lsap

    cases = lsa_fuzz_cases(n=40)
    for d in range(world):
        with torch.cuda.device(d):
            for name, p in (("cluster_points_single", 207_360),
                            ("cluster_points_tiled", 878_592)):
                tensors = cuda_inputs(p)
                kwargs = main_kwargs()
                labels, meta = getattr(ops, name)(*tensors, **kwargs)
                if {t.device.index for t in (*tensors, labels, meta)} != {d}:
                    raise AssertionError(f"cuda:{d} {name}: output on {labels.device}")
                n_valid, n_mism, _ = compare_with_plain(ops, f"cuda:{d} {name} P={p}", tensors,
                                                        labels, meta, kwargs)
                log(f"  cuda:{d} {name} P={p}: {n_valid} clusters, {n_mism} knife-edge label "
                    "mismatches, meta equal")
            for cost, rv, cv in cases:
                cpu = [torch.from_numpy(x) for x in (cost, rv, cv)]
                plain = [t.numpy() for t in lsap.lsa_masked_reference(*cpu)]
                out = lsap.lsa_masked(*[x.to(f"cuda:{d}") for x in cpu])
                if any(t.device.index != d for t in out) or not all(
                        np.array_equal(a, b.cpu().numpy()) for a, b in zip(plain, out)):
                    raise AssertionError(f"cuda:{d} lsa_masked differs from the plain version "
                                         f"at {cost.shape}")
            log(f"  cuda:{d} lsa_masked: {len(cases)} fuzz cases equal to the plain version")
    kept = {index for index, _ in ops._workspaces}
    wrong = [(key, str(ws.device)) for key, ws in ops._workspaces.items()
             if ws.device.index != key[0]]
    if wrong or not set(range(world)) <= kept:
        raise AssertionError(f"clustering workspaces: cards {sorted(kept)}, misplaced {wrong}")


class CliSplit:
    """Host seconds of the inference CLI's frame reads and writer calls,
    patched onto ``TrackGenerator`` for one run."""

    def __init__(self):
        self.read_s = self.write_s = 0.0

    @contextlib.contextmanager
    def patched(self):
        from stemseg_tpu_torch.inference.main import TrackGenerator

        read, write = TrackGenerator._read_frames, TrackGenerator._write

        def timed_read(tg, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return read(tg, *args, **kwargs)
            finally:
                self.read_s += time.perf_counter() - t0

        def timed_write(tg, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return write(tg, *args, **kwargs)
            finally:
                self.write_s += time.perf_counter() - t0

        TrackGenerator._read_frames, TrackGenerator._write = timed_read, timed_write
        try:
            yield self
        finally:
            TrackGenerator._read_frames, TrackGenerator._write = read, write


def profiled_by_card(fn, expect, tag, attempts=2):
    """Runs ``fn`` under torch.profiler and counts, by the device index of
    each kernel event, the clustering kernels' and the lsap kernel's
    launches (graph replays included) and every device event's ms.
    ``expect`` is {card: {"cluster_kernel": n, "lsa_kernel": n}}; a
    session that counted otherwise is run again (the profiler has been
    seen to lose a launch), and the last one raises. Returns (fn's result,
    {card: counts and "busy_ms"})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            result = fn()
            for d in range(torch.cuda.device_count()):
                torch.cuda.synchronize(d)
        by_card = {}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                c = by_card.setdefault(evt.device_index,
                                       {"cluster_kernel": 0, "lsa_kernel": 0, "busy_ms": 0.0})
                for name in ("cluster_kernel", "lsa_kernel"):
                    c[name] += name in evt.name
                c["busy_ms"] += evt.time_range.elapsed_us() / 1e3
        counts = {d: {k: c[k] for k in ("cluster_kernel", "lsa_kernel")}
                  for d, c in by_card.items() if c["cluster_kernel"] or c["lsa_kernel"]}
        if counts == expect:
            return result, by_card
        log(f"  {tag}: profiler session {attempt + 1} of {attempts} counted {counts}, "
            f"expected {expect}")
    raise AssertionError(f"{tag}: device launches by card {counts}, expected {expect}")


def left_behind(world):
    """What a finished inference run left: the fused pipelines, device
    states and track generators still alive (before and after a cyclic
    GC), and on each card the bytes allocated and reserved, those of CUDA
    graph pools apart (allocated / held)."""
    import gc

    import torch

    from stemseg_tpu_torch.inference import fused_pipeline
    from stemseg_tpu_torch.inference.main import TrackGenerator

    kinds = (TrackGenerator, fused_pipeline.FusedSequencePipeline, fused_pipeline._State)

    def alive():
        return [sum(isinstance(o, k) for o in gc.get_objects()) for k in kinds]

    before = alive()
    gc.collect()
    cards = {}
    if torch.cuda.is_available():
        pools = {}
        for seg in torch.cuda.memory._snapshot()["segments"]:
            if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0):
                a, t = pools.get(seg["device"], (0, 0))
                pools[seg["device"]] = (a + seg["allocated_size"], t + seg["total_size"])
        for d in range(world):
            a, t = pools.get(d, (0, 0))
            cards[d] = (f"{torch.cuda.memory_allocated(d) / 2**30:.2f} / "
                        f"{torch.cuda.memory_reserved(d) / 2**30:.2f} GiB, graph pools "
                        f"{a / 2**30:.2f} / {t / 2**30:.2f}")
    return (f"(generators, pipelines, states) alive {before}, after gc.collect() {alive()}; "
            f"by card allocated / reserved {cards}")


def kernel_launches(by_card):
    """{card: {"cluster_kernel": n, "lsa_kernel": n}} of ``profiled_by_card``'s
    counts."""
    return {d: {k: c[k] for k in ("cluster_kernel", "lsa_kernel")}
            for d, c in sorted(by_card.items())}


def serving_phase(root, world, device="cuda"):
    """Phase 23 (d): the inference CLI's ``--data_parallel`` with
    ``davis_2`` in bf16 (random weights as a ``.pth`` beside its config)
    over every card, on a generated DAVIS set of ``2 * world`` sequences of
    480x854 with the lengths of DAVIS 2017 val's first ones in its order
    (two chunks of ``world``): the chunks as ``run_batch`` gets them, the
    PNGs byte-equal to the serial CLI's on the first card, the clustering
    and lsap launches counted by the profiler on each card (the windows of
    its own sequences) and each card's device busy ms; its wall against the
    serial CLI's, each split into frame reads, the fused runs (the CLI's
    "inference" timer) and writer calls (host clock), in turns (serial and
    data parallel profiled, then both again), each followed by what it left
    on the cards (``left_behind``); and, first, ``run_batch`` over every
    card equal to ``run`` on each sequence."""
    import numpy as np
    import torch

    from stemseg_tpu_torch.config import load_preset, merge, save_config
    from stemseg_tpu_torch.inference import main as cli
    from stemseg_tpu_torch.inference.fused_pipeline import FusedSequencePipeline
    from stemseg_tpu_torch.inference.windows import get_subsequence_frames
    from stemseg_tpu_torch.utils.timer import Timer

    lengths = list(DAVIS17_VAL_LENGTHS.items())[:2 * world]
    data = os.path.join(root, "DP23")
    ann = os.path.join(data, "annotations")
    os.makedirs(ann)
    t0 = time.perf_counter()
    write_video_set(np.random.RandomState(MAIN_SEED + 23), os.path.join(data, "davis"), ann,
                    "davis_val.json", 480, 854, [(s, n, {1: 1}, {}) for s, n in lengths],
                    separate=True)
    log(f"  (d) {len(lengths)} sequences of 480x854 written, {sum(n for _, n in lengths)} "
        f"frames ({time.perf_counter() - t0:.1f} s)")
    env = {"DAVIS_BASE_DIR": os.path.join(data, "davis"), "STEMSEG_JSON_ANNOTATIONS_DIR": ann}
    cfg = merge(load_preset("davis_2"), {"clustering": {"min_seediness_prob": 0.05}})
    model = build_random_model(cfg, synthetic_frames(2, 480, 854, MAIN_SEED), MAIN_SEED,
                              device=device)
    pth = os.path.join(data, "model", "davis.pth")
    os.makedirs(os.path.dirname(pth))
    torch.save({"model": model.state_dict()}, pth)
    save_config(cfg, os.path.join(data, "model", "config.yaml"))
    del model
    windows = [len(get_subsequence_frames(n, cfg.input.num_frames,
                                          cfg.data.davis.inference_frame_overlap))
               for _, n in lengths]
    expect = {d: {"cluster_kernel": sum(windows[d::world]), "lsa_kernel": sum(windows[d::world])}
              for d in range(world)}
    devices = [f"cuda:{d}" for d in range(world)] if device == "cuda" else [device] * world

    # run_batch over every card against run, on the first `world` sequences
    model = cli.load_model(cfg, pth, device=device, dtype=torch.bfloat16)
    tg = make_track_generator(cfg, "davis", model, os.path.join(data, "rb"), use_fused=True)
    seqs = [synthetic_frames(n, 480, 854, seed=MAIN_SEED + i)
            for i, (_, n) in enumerate(lengths[:world])]
    schedules = [tg._schedule(len(f), f.shape[1:3]) for f in seqs]
    kw = dict(seediness_fg_threshold=tg.seediness_thresh, resize_hw=schedules[0][1])
    want = [tg.fused.run(f, w, **kw) for f, (w, _) in zip(seqs, schedules)]
    rb_expect = {d: {"cluster_kernel": len(w), "lsa_kernel": len(w)}
                 for d, (w, _) in enumerate(schedules)}
    for attempt in ("first (the replicas warm up and capture)", "second (replays)"):
        t1 = time.perf_counter()
        got, rb_by_card = profiled_by_card(
            lambda: tg.fused.run_batch(seqs, [w for w, _ in schedules], devices, **kw),
            rb_expect, f"(d) run_batch {attempt}")
        for i, ((wl, wc, wt, wf, _), (gl, gc, gt, gf, _)) in enumerate(zip(want, got)):
            if not (np.array_equal(wl, gl) and wc == gc and wt == gt and np.array_equal(wf, gf)):
                raise AssertionError(f"(d) run_batch {attempt}: sequence {i} differs from run")
        log(f"  (d) run_batch over {devices}, {attempt}: labels, counts, lifetimes and fg masks "
            f"equal to run on {[len(f) for f in seqs]} frames; device launches by card "
            f"{kernel_launches(rb_by_card)} "
            f"({time.perf_counter() - t1:.3f} s profiled)")
    del tg, model
    torch.cuda.empty_cache()

    chunks = []
    run_batch = FusedSequencePipeline.run_batch

    def spy(self, frames_batch, windows_batch, devs, **kwargs):
        chunks.append(([len(f) for f in frames_batch], list(devs)))
        return run_batch(self, frames_batch, windows_batch, devs, **kwargs)

    def cli_run(name, extra):
        out = os.path.join(data, name)
        split = CliSplit()
        Timer.reset()
        with split.patched():
            t1 = time.perf_counter()
            cli.main([pth, "-o", out, "--dataset", "davis", "--bf16", "--device", device,
                      *extra])
            wall = time.perf_counter() - t1
        log(f"  (d) after {name}: {left_behind(world)}")
        return out, {"wall_s": wall, "read_s": split.read_s, "write_s": split.write_s,
                     "inference_s": Timer.get_duration("inference")}

    FusedSequencePipeline.run_batch = spy
    runs = {}
    try:
        with environment(env):
            runs["serial 1"], serial_by_card = profiled_by_card(
                lambda: cli_run("serial_1", []),
                {0: {"cluster_kernel": sum(windows), "lsa_kernel": sum(windows)}}, "(d) serial")
            runs["data parallel 1"], by_card = profiled_by_card(
                lambda: cli_run("data_parallel_1", ["--data_parallel"]), expect,
                "(d) --data_parallel")
            runs["serial 2"] = cli_run("serial_2", [])
            runs["data parallel 2"] = cli_run("data_parallel_2", ["--data_parallel"])
    finally:
        FusedSequencePipeline.run_batch = run_batch
    want_chunks = [([n for _, n in lengths[i:i + world]], devices)
                   for i in range(0, len(lengths), world)]
    if chunks != want_chunks * 2:  # the two data-parallel runs
        raise AssertionError(f"(d) run_batch chunks {chunks}, expected {want_chunks} a run")
    serial = runs["serial 1"][0]
    n_files = 0
    for dirpath, _, files in os.walk(os.path.join(serial, "results")):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), serial)
            with open(os.path.join(serial, rel), "rb") as fh:
                ref = fh.read()
            for name, (out, _) in runs.items():
                with open(os.path.join(out, rel), "rb") as fh:
                    if fh.read() != ref:
                        raise AssertionError(f"(d) {rel} of {name} differs from serial 1's")
            n_files += 1
    if n_files != sum(n for _, n in lengths):
        raise AssertionError(f"(d) {n_files} PNGs")
    log(f"  (d) --data_parallel --bf16 over {world} cards: chunks {want_chunks}; {n_files} PNGs "
        f"of every run byte-equal to the serial CLI's; device launches by card "
        f"{kernel_launches(by_card)} "
        f"(expected {expect}); device busy ms by card "
        f"{ {d: round(c['busy_ms'], 3) for d, c in sorted(by_card.items())} }, the serial "
        f"CLI's {round(serial_by_card[0]['busy_ms'], 3)}")
    for name, (_, t) in runs.items():
        log(f"  (e) {name}: wall {t['wall_s']:.3f} s; frame reads {t['read_s']:.3f} s, fused "
            f"runs (inference timer) {t['inference_s']:.3f} s, writer calls "
            f"{t['write_s']:.3f} s"
            + (" (profiled)" if name == "data parallel 1" else ""))
    ratio = runs["serial 2"][1]["wall_s"] / runs["data parallel 2"][1]["wall_s"]
    log(f"  (e) serial / data parallel wall (runs 2): {ratio:.3f}")

    return {"walls": {name: t for name, (_, t) in runs.items()}, "by_card": by_card,
            "serial_over_data_parallel": ratio}


def four_card_phase(ops, world):
    """Phase 23 on ``world`` cards: the kernels on each card, the ranks of
    (b), (c) and (e), the trainer CLI under torch.distributed.run (a), and
    serving (d). Every part runs, and the phase raises after them if any
    failed (no part stands in for another). Returns their numbers."""
    import traceback

    import torch

    results, failures = {}, []
    with tempfile.TemporaryDirectory() as root:
        for name, fn in (("kernels on each card", lambda: kernels_on_each_card(ops, world)),
                         ("(b), (c), (e): ranks on their cards against one card",
                          lambda: card_ranks_phase(root, world)),
                         ("(a): the trainer CLI under torch.distributed.run",
                          lambda: torchrun_phase(root, world)),
                         ("(d): serving on every card", lambda: serving_phase(root, world)),
                         ("(d): serving mixed frame sizes on every card",
                          lambda: mixed_serving_phase(root, world))):
            log(f"== phase 23 {name}")
            t0 = time.perf_counter()
            try:
                results[name] = fn()
            except Exception:
                failures.append(name)
                log(f"  FAILED: {name}\n{traceback.format_exc()}")
            log(f"  {name}: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"phase 23 failed: {failures}")
    return results


def four_cards_main():
    """``python3 chip_smoke.py --four-cards``: phase 23 alone, on a host
    with ``FOUR_CARDS`` cards; it exits non-zero before it builds anything
    where there are fewer."""
    if not os.path.isdir(os.path.join(HERE, "stemseg_tpu_torch")):
        sys.stderr.write("chip_smoke: run it from the root of a checkout\n")
        sys.exit(1)
    import statistics

    import torch

    count = torch.cuda.device_count()
    if count < FOUR_CARDS:
        sys.stderr.write(f"chip_smoke --four-cards: needs {FOUR_CARDS} CUDA devices on one "
                         f"host, found {count}\n")
        sys.exit(1)
    sys.path.insert(0, HERE)
    from stemseg_tpu_torch.ops import build, cluster as ops
    from stemseg_tpu_torch.utils.device import resolve_device

    t_start = time.perf_counter()
    log("== phase 1: devices")
    resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                          timeout=60).stdout
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}, {count} devices: "
        f"{[torch.cuda.get_device_name(d) for d in range(count)]}; host cores {os.cpu_count()}")
    for line in smi:
        log(f"  nvidia-smi: {line}")
    log("  nvidia-smi topo -m:\n" + topo)
    nvlink = subprocess.run(["nvidia-smi", "nvlink", "--status", "-i", "0"],
                            capture_output=True, text=True, timeout=60).stdout
    links = [line.split(":", 1)[1].strip() for line in nvlink.splitlines()
             if line.strip().startswith("Link ")]
    log(f"  NVLink links of GPU0 (nvidia-smi nvlink --status -i 0): {len(links)}, "
        f"{sorted(set(links))}; peer access from cuda:0: "
        f"{[torch.cuda.can_device_access_peer(0, d) for d in range(1, count)]}")
    log("== phase 2: build")
    for res in build.build().values():
        log(f"  {res.name}: built in {res.seconds:.1f} s")
    results = four_card_phase(ops, FOUR_CARDS)
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    ranks = results["(b), (c), (e): ranks on their cards against one card"]
    serving = results["(d): serving on every card"]
    med = statistics.median
    print(json.dumps({"phase23": {
        "cards": smi, "nvlinks_of_gpu0": links, "host_cores": os.cpu_count(),
        "bucket_mb": ranks["bucket_mb"],
        "whole_grad_rel_l2": {"float32": ranks["whole_grad_rel_l2"],
                              "float64_convs": ranks["whole_grad_rel_l2_float64_convs"]},
        "all_reduce_flat_ms": [med(m) for m in ranks["all_reduce_flat_ms"]],
        "all_reduce_bucket_ms": [med(m) for m in ranks["all_reduce_bucket_ms"]],
        "all_reduce_ints_ms": [med(m) for m in ranks["all_reduce_ints_ms"]],
        "s_per_step_world_1": med(ranks["world_1"]["s_per_step"]),
        "s_per_step_world_4": {k: max(med(r["s_per_step"]) for r in ranks[k])
                               for k in ("fp32", "bf16")},
        "launches_by_card": kernel_launches(serving["by_card"]),
        "serial_over_data_parallel_wall": serving["serial_over_data_parallel"],
        "mixed_sizes_reserved_gib_by_card": results[
            "(d): serving mixed frame sizes on every card"]}}))
    for line in smi:
        print(line)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))


# -- phase 24: the fused path across frame sizes ------------------------------

# Four raw frame sizes of a YouTube-VIS val pass, (height, width), and what
# the youtube_vis preset (min_dim 640, max_dim 1196) makes of them
MIXED_SIZES = {
    "S1": (720, 1280),   # 640x1138 (640x1152 padded), 368,640 points a window: tiled
    "S2": (1080, 1920),  # the same network input as S1, under another raw key
    "S3": (480, 854),    # 640x1139 (640x1152), 368,640 points: tiled
    "S4": (375, 1242),   # 361x1196 (384x1216), 233,472 points: cluster_points_single
}
MIXED_KERNELS = {"S1": "cluster_points_tiled", "S2": "cluster_points_tiled",
                 "S3": "cluster_points_tiled", "S4": "cluster_points_single"}
MIXED_FRAMES = 20
MIXED_ROUNDS = 3
MIXED_GROWTH_FRAMES = 36
RESERVED_SLACK = 2 ** 30  # bytes memory_reserved() may grow by after the first round


def mixed_size_sequences(seed=MAIN_SEED):
    """The alternating order of phase 24, S1 S2 S3 S4 for ``MIXED_ROUNDS``
    rounds, as (seq id, size, frames), and the growth sequence (S1,
    ``MIXED_GROWTH_FRAMES`` frames). One synthetic sequence of S1's size,
    resized to each other size (cv2) and shifted 40 px a round, so that no
    two sequences are the same; the growth sequence runs S1's frames
    forward and back."""
    import cv2
    import numpy as np

    base = synthetic_frames(MIXED_FRAMES, *MIXED_SIZES["S1"], seed=seed)
    by_size = {name: base if (h, w) == base.shape[1:3] else np.stack(
        [cv2.resize(f, (w, h), interpolation=cv2.INTER_LINEAR) for f in base])
        for name, (h, w) in MIXED_SIZES.items()}
    seqs = [(f"{name}_r{r}", name, np.ascontiguousarray(np.roll(by_size[name], 40 * r, axis=2)))
            for r in range(MIXED_ROUNDS) for name in MIXED_SIZES]
    growth = np.concatenate([base, base[::-1][:MIXED_GROWTH_FRAMES - MIXED_FRAMES]])
    return seqs, ("S1_growth", "S1", growth)


def grouped_order(seqs):
    """``seqs`` in runs of one size, each size in the order it first
    appears, its sequences in their own order."""
    sizes = list(dict.fromkeys(size for _, size, _ in seqs))
    return [s for size in sizes for s in seqs if s[1] == size]


def mixed_pass(tg, seqs, want=None):
    """Each (seq id, size, frames) of ``seqs`` through
    ``tg._process_loaded`` (its writer a ``NullWriter``). Per sequence: the
    CLI timers' seconds, and after it ``memory_reserved()``,
    ``max_memory_reserved()`` and the fused pipeline's states made and
    graphs captured. Without ``want`` it returns, besides, each sequence's
    labels and fg masks (host) and multiclass masks (device); with it every
    sequence's must equal ``want``'s, or it raises. Returns (rows,
    outputs)."""
    import numpy as np
    import torch

    from stemseg_tpu_torch.utils.timer import Timer

    seen = {}
    inner_inf, inner_fused = tg.do_inference, tg.do_fused

    def do_inference(frames, image_hw):
        out = inner_inf(frames, image_hw)
        seen.update(fg=out["fg_masks"], mc=out["multiclass_masks"])
        return out

    def do_fused(frames, image_hw):
        out = inner_fused(frames, image_hw)
        seen.update(fg=out[3], mc=out[4])
        return out

    tg.do_inference, tg.do_fused = do_inference, do_fused
    rows, outputs = [], {}
    try:
        for seq_id, size, frames in seqs:
            hw = frames.shape[1:3]
            Timer.reset()
            labels = tg._process_loaded(Sequence(seq_id, len(frames), hw), frames, hw,
                                        tg.max_tracks)[0]
            seconds = Timer.get_durations_sum()
            torch.cuda.synchronize()
            pipe = tg.fused
            rows.append({"id": seq_id, "size": size, "frames": len(frames), "s": seconds,
                         "reserved": torch.cuda.memory_reserved(),
                         "max_reserved": torch.cuda.max_memory_reserved(),
                         "states": pipe.states_made if pipe is not None else 0,
                         "captures": pipe.captures if pipe is not None else 0})
            fg = seen["fg"].cpu().numpy() if torch.is_tensor(seen["fg"]) else seen["fg"]
            out = {"labels": np.asarray(labels.cpu() if torch.is_tensor(labels) else labels,
                                        np.int32), "fg": fg, "mc": seen.pop("mc")}
            if want is None:
                outputs[seq_id] = out
                continue
            ref = want[seq_id]
            same = {"labels": np.array_equal(out["labels"], ref["labels"]),
                    "fg": out["fg"].dtype == ref["fg"].dtype
                    and np.array_equal(out["fg"], ref["fg"]),
                    "mc": torch.equal(out["mc"], ref["mc"])}
            if not all(same.values()):
                raise AssertionError(f"{seq_id}: against the streaming path {same}")
    finally:
        del tg.do_inference, tg.do_fused
    return rows, outputs


def cluster_kernel_kind(name):
    """``cluster_points_single`` or ``cluster_points_tiled`` for a device
    event of ``cluster_kernel<E, mode>`` (mode 0: the single kernel's
    resident window), demangled or not; None for other events."""
    import re

    if "cluster_kernel" not in name:
        return None
    m = re.search(r"cluster_kernel(?:<\s*\d+\s*,\s*|ILi\d+ELi)(\d)", name)
    if m is None:
        raise AssertionError(f"a clustering kernel's mode is not in its name: {name}")
    return "cluster_points_single" if m.group(1) == "0" else "cluster_points_tiled"


def profile_mixed(tg, seqs, expect, attempts=2):
    """``seqs`` through the fused path of ``tg`` (the CLI's timed phase,
    ``do_fused``) under torch.profiler: (device busy share of the wall,
    {kernel: launches}, wall ms). ``expect`` is the launches the session
    must count of each clustering kernel and of the lsap kernel; a session
    that counts others is profiled again, and the last one raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _, _, frames in seqs:
                tg.do_fused(frames, frames.shape[1:3])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        busy, counts = 0.0, dict.fromkeys(expect, 0)
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                busy += evt.time_range.elapsed_us()
                kind = cluster_kernel_kind(evt.name)
                if kind is not None:
                    counts[kind] += 1
                counts["lsa_masked"] += "lsa_kernel" in evt.name
        if counts == expect:
            return busy / wall_us, counts, wall_us / 1e3
        log(f"  profiled alternating pass: session {attempt + 1} of {attempts} counted "
            f"{counts}, expected {expect}")
    raise AssertionError(f"phase 24: device launches {counts}, expected {expect}")


def reserved_gib(dev=None):
    import torch

    return torch.cuda.memory_reserved(dev) / 2 ** 30


def mixed_track_generator(cfg, model, fused):
    from stemseg_tpu_torch.inference.main import TrackGenerator

    return TrackGenerator(cfg, "ytvis", model, NullWriter(), max_tracks_of(cfg, "ytvis"),
                          use_fused=fused)


def mixed_size_passes(model, cfg, seqs, growth, smi):
    """Phase 24 (i)-(iv): the youtube_vis model over ``MIXED_SIZES``
    (``mixed_size_sequences``), each order through one pipeline: (iii) the
    streaming path in the alternating order and on the growth sequence
    (its outputs the reference), (i) the fused path in the alternating
    order, then (iv) the growth sequence on the same pipeline, (ii) the
    fused path grouped by size on a fresh one (each path's first-use costs
    taken first by a throwaway pass over one sequence a size); then the
    alternating order profiled on a fresh pipeline, and the clustering
    kernels on S4's and S1's first real window against the plain version.
    Returns the numbers."""
    import torch

    from stemseg_tpu_torch.ops import cluster as ops

    def new_tg(fused):
        return mixed_track_generator(cfg, model, fused)

    first_round = seqs[:len(MIXED_SIZES)]
    # the process's first-use costs at each size (cuDNN's plans, the first
    # captures) on throwaway passes of both paths
    mixed_pass(new_tg(False), first_round)
    mixed_pass(new_tg(True), first_round)
    gib = 2 ** 30
    streaming, want = mixed_pass(new_tg(False), seqs + [growth])
    streaming = streaming[:-1]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    tg = new_tg(True)
    alternating, _ = mixed_pass(tg, seqs, want)
    grown, _ = mixed_pass(tg, [growth], want)
    pipe = tg.fused
    alt_counts = (pipe.states_made, pipe.captures)
    del tg, pipe
    torch.cuda.empty_cache()
    grouped, _ = mixed_pass(new_tg(True), grouped_order(seqs), want)
    del want
    torch.cuda.empty_cache()

    def fps(rows):
        return sum(r["frames"] for r in rows) / sum(r["s"] for r in rows)

    steady = {}
    for r in grouped:  # the last run of each size: every body replayed
        steady[r["size"]] = r["s"]
    per_size = {size: [r["s"] - steady[size] for r in alternating if r["size"] == size]
                for size in MIXED_SIZES}
    replacement_s = [x for xs in per_size.values() for x in xs]
    log(f"  (iii) streaming, alternating ({smi}): " + ", ".join(
        f"{r['id']} {r['s']:.4f} s" for r in streaming))
    for name, rows in (("(i) fused, alternating", alternating), ("(iv) growth", grown),
                       ("(ii) fused, grouped", grouped)):
        prev = 0
        for r in rows:
            made = r["states"] > prev or name == "(iv) growth"
            prev = r["states"]
            log(f"  {name}: {r['id']} ({r['frames']} frames) {r['s']:.4f} s; states "
                f"{r['states']}, graphs captured {r['captures']}; memory_reserved "
                f"{r['reserved'] / gib:.3f} GiB, max_memory_reserved "
                f"{r['max_reserved'] / gib:.3f} GiB" + (" (a new state)" if made else ""))
    log(f"  states made / graphs captured: (i) {alternating[-1]['states']} / "
        f"{alternating[-1]['captures']}, with (iv) {alt_counts[0]} / {alt_counts[1]}; (ii) "
        f"{grouped[-1]['states']} / {grouped[-1]['captures']}")
    log(f"  seconds a replacement ((i)'s run minus (ii)'s last run of its size, {smi}): "
        + "; ".join(f"{size} " + ", ".join(f"{x:.4f}" for x in xs)
                    for size, xs in per_size.items())
        + f"; mean {sum(replacement_s) / len(replacement_s):.4f} s")
    f_alt, f_grp, f_str = fps(alternating), fps(grouped), fps(streaming)
    share = 1.0 - f_alt / f_grp
    log(f"  overall fps ({smi}): (i) alternating {f_alt:.3f}, (ii) grouped {f_grp:.3f}, "
        f"(iii) streaming {f_str:.3f}; replacements cost {share * 100:.2f} % of the grouped "
        f"fps ({'at least' if share >= 0.05 else 'under'} the 5 % that would keep a state a "
        "key)")
    labels_note = (f"labels bit-identical, fg and multiclass masks equal to the streaming path "
                   f"on all {len(seqs) + 1} sequences of (i) and (iv) and the {len(seqs)} of "
                   "(ii)")
    log(f"  {labels_note}")

    bound = alternating[len(MIXED_SIZES) - 1]["reserved"] + RESERVED_SLACK
    ends = {"(i) after sequence 12": alternating[-1]["reserved"],
            "(iv)": grown[-1]["reserved"]}
    log(f"  memory_reserved after sequence {len(MIXED_SIZES)} of (i) "
        f"{alternating[len(MIXED_SIZES) - 1]['reserved'] / gib:.3f} GiB; "
        + ", ".join(f"{k} {v / gib:.3f} GiB" for k, v in ends.items())
        + f" (bound {bound / gib:.3f})")
    over = {k: v for k, v in ends.items() if v > bound}
    if over:
        raise AssertionError(f"phase 24: memory_reserved grew past the first round + 1 GiB: "
                             f"{over}")

    tg = new_tg(True)
    expect = {"cluster_points_single": 0, "cluster_points_tiled": 0, "lsa_masked": 0}
    for _, size, frames in seqs:
        n = len(tg._schedule(len(frames), frames.shape[1:3])[0])
        expect[MIXED_KERNELS[size]] += n
        expect["lsa_masked"] += n
    busy, launches, wall_ms = profile_mixed(tg, seqs, expect)
    log(f"  (i) profiled on a fresh pipeline, the CLI's timed phases: wall {wall_ms:.3f} ms, "
        f"device busy {busy:.3f} of the wall ({smi}); device launches {launches}")
    del tg
    torch.cuda.empty_cache()

    windows = {}
    stg = new_tg(False)
    for _, size, frames in first_round:
        if size not in ("S1", "S4"):
            continue
        ops.reset_launch_counts()
        _, kernel_ms, shape = window_cluster_ms(stg, frames)
        ran = {k: v for k, v in ops.launch_counts.items() if v and k != "cluster_points_reference"}
        if list(ran) != [MIXED_KERNELS[size]]:
            raise AssertionError(f"phase 24 {size}: the first window ran {ran}, expected "
                                 f"{MIXED_KERNELS[size]}")
        windows[size] = {"kernel": MIXED_KERNELS[size], "points": int(shape[0]),
                         "kernel_ms": kernel_ms}
        log(f"  {size} first real window: {MIXED_KERNELS[size]} at {int(shape[0])} points, "
            f"{kernel_ms:.4f} ms ({smi})")
    del stg
    torch.cuda.empty_cache()
    return {"fps": {"alternating": f_alt, "grouped": f_grp, "streaming": f_str},
            "replacement_cost_share": share, "replacement_s": per_size,
            "states_captures": {"alternating": alt_counts,
                                "grouped": (grouped[-1]["states"], grouped[-1]["captures"])},
            "reserved": {"after_4": alternating[len(MIXED_SIZES) - 1]["reserved"], **ends},
            "busy": busy, "launches": launches, "windows": windows}


def write_mixed_ytvis_set(root, per_size=2, sizes=None, n_frames=MIXED_FRAMES,
                          seed=MAIN_SEED):
    """A YouTube-VIS val set (``valid/`` frames, ``youtube_vis_val.json``
    with RLE masks) of ``per_size`` sequences of each of ``sizes`` (default
    ``MIXED_SIZES``), ``n_frames`` frames each, the sizes interleaved in the
    JSON's order (S1 S2 S3 S4 S1 ...), 2 or 3 objects a sequence of
    categories among the 40. Returns the environment variables and the
    sequence ids."""
    import numpy as np

    sizes = sizes or MIXED_SIZES
    rng = np.random.RandomState(seed + 24)
    base = os.path.join(root, "youtube_vis")
    ann = os.path.join(root, "annotations")
    scratch = os.path.join(root, "per_sequence")
    os.makedirs(ann)
    os.makedirs(scratch)
    sequences = []
    for i in range(per_size):
        for name, (h, w) in sizes.items():
            cats = {iid: int(rng.randint(1, 41)) for iid in range(1, 2 + i % 2 + 1)}
            sequences += write_video_set(rng, base, scratch, f"{name}_{i}.json", h, w,
                                         [(f"{name.lower()}_{i}", n_frames, cats, {})],
                                         sub="valid", separate=True)
    labels = {str(c): str(c) for s in sequences for c in s["categories"].values()}
    with open(os.path.join(ann, "youtube_vis_val.json"), "w") as fh:
        json.dump({"meta": {"category_labels": labels}, "sequences": sequences}, fh)
    env = {"STEMSEG_JSON_ANNOTATIONS_DIR": ann, "YOUTUBE_VIS_BASE_DIR": base}
    return env, [s["id"] for s in sequences]


@contextlib.contextmanager
def environment(env):
    prev = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def reserved_at_end_of_start(readings, devices):
    """Records ``memory_reserved`` of each of ``devices`` when
    ``TrackGenerator.start`` returns (before ``main`` frees the run's
    device state) in ``readings``."""
    from stemseg_tpu_torch.inference.main import TrackGenerator

    start = TrackGenerator.start

    def spy(self, *args, **kwargs):
        out = start(self, *args, **kwargs)
        readings.append({d: reserved_gib(d) for d in devices})
        return out

    TrackGenerator.start = spy
    try:
        yield readings
    finally:
        TrackGenerator.start = start


def mixed_size_cli(root, cfg, model, smi, device="cuda"):
    """Phase 24, the CLI: ``model`` as a ``.pth`` beside its config through
    ``python -m stemseg_tpu_torch.inference.main --dataset ytvis`` on a
    YT-VIS set of 8 sequences of the four sizes interleaved, serial (the
    fused path), ``--profile_clustering`` (the streaming path) and
    ``--data_parallel`` (one card): ``results.json`` byte-equal across the
    three; ``memory_reserved()`` when each run's sequences are done and
    after ``main`` returns."""
    import torch

    from stemseg_tpu_torch.config import save_config
    from stemseg_tpu_torch.inference import main as cli
    from stemseg_tpu_torch.utils.timer import Timer

    data = os.path.join(root, "MX")
    t0 = time.perf_counter()
    env, ids = write_mixed_ytvis_set(data)
    log(f"  CLI: {len(ids)} YT-VIS sequences of {MIXED_FRAMES} frames written, sizes "
        f"interleaved ({time.perf_counter() - t0:.1f} s)")
    pth = os.path.join(data, "model", "youtube_vis.pth")
    os.makedirs(os.path.dirname(pth))
    torch.save({"model": model.state_dict()}, pth)
    save_config(cfg, os.path.join(data, "model", "config.yaml"))
    results, readings = {}, []
    with environment(env), reserved_at_end_of_start(readings, [0] if device == "cuda" else []):
        for name, extra in (("serial", []), ("streaming", ["--profile_clustering"]),
                            ("data_parallel", ["--data_parallel"])):
            out = os.path.join(data, name)
            Timer.reset()
            t1 = time.perf_counter()
            cli.main([pth, "-o", out, "--dataset", "ytvis", "--device", device, *extra])
            wall = time.perf_counter() - t1
            with open(os.path.join(out, "results.json"), "rb") as fh:
                results[name] = fh.read()
            after = reserved_gib(0) if device == "cuda" else 0.0
            log(f"  CLI {name}: wall {wall:.3f} s; memory_reserved at the end of its sequences "
                f"{readings[-1].get(0, 0.0):.3f} GiB, after main returned {after:.3f} GiB "
                f"({smi})")
    n = len(json.loads(results["serial"]))
    same = {name: r == results["serial"] for name, r in results.items()}
    log(f"  CLI: results.json ({len(results['serial'])} bytes, {n} instances) byte-equal to "
        f"the serial run's: {same}")
    if not all(same.values()) or n == 0:
        raise AssertionError(f"phase 24 CLI: results.json differ ({same}) or are empty ({n})")
    return {"results_bytes": len(results["serial"]), "instances": n}


def mixed_size_model(device="cuda"):
    """Phase 24's config (``youtube_vis``, ``min_seediness_prob`` 0.05) and
    random model (seed 0, the fg logit centred on the first window of S1's
    frames, as ``mixed_size_sequences`` makes them)."""
    from stemseg_tpu_torch.config import load_preset, merge

    cfg = merge(load_preset("youtube_vis"), {"clustering": {"min_seediness_prob": 0.05}})
    frames = synthetic_frames(cfg.input.num_frames, *MIXED_SIZES["S1"], seed=MAIN_SEED)
    return cfg, build_random_model(cfg, frames, MAIN_SEED, device=device)


def mixed_size_phase(out_root, smi):
    """Phase 24: the fused path across frame sizes (``mixed_size_passes``)
    and the YT-VIS CLI on a mixed-size set (``mixed_size_cli``)."""
    import torch

    cfg, model = mixed_size_model()
    numbers = mixed_size_passes(model, cfg, *mixed_size_sequences(), smi)
    numbers["cli"] = mixed_size_cli(out_root, cfg, model, smi)
    del model
    torch.cuda.empty_cache()
    return numbers


def alternating_reserved(smi="n/a"):
    """Phase 24's alternating order alone, through one fresh pipeline, with
    ``memory_reserved()`` after each sequence: it also runs on an older tree
    of the port (unpack it, copy this file in), where a replaced state's
    graph pool stays cached. An out-of-memory error ends the pass, and is
    reported. Returns the readings in GiB."""
    import torch

    cfg, model = mixed_size_model()
    seqs, _ = mixed_size_sequences()
    tg = mixed_track_generator(cfg, model, True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    readings = [reserved_gib()]
    for seq in seqs:
        try:
            rows, _ = mixed_pass(tg, [seq])
        except torch.OutOfMemoryError as e:
            log(f"  alternating pass: out of memory at {seq[0]}: {str(e)[:300]}")
            break
        readings.append(rows[0]["reserved"] / 2 ** 30)
        log(f"  alternating pass: {seq[0]} {rows[0]['s']:.4f} s; states {rows[0]['states']}, "
            f"graphs captured {rows[0]['captures']}; memory_reserved {readings[-1]:.3f} GiB, "
            f"max_memory_reserved {rows[0]['max_reserved'] / 2 ** 30:.3f} GiB ({smi})")
    log(f"  alternating pass: memory_reserved from {readings[0]:.3f} GiB to {readings[-1]:.3f} "
        f"GiB over {len(readings) - 1} sequences")
    return readings


def mixed_serving_phase(root, world, device="cuda"):
    """Phase 23 (d), mixed frame sizes: phase 24's model (``youtube_vis`` in
    float32, random, fg centred) as a ``.pth`` through the YT-VIS CLI on a
    set of ``world`` sequences of each of the four sizes, interleaved:
    ``--data_parallel`` in one chunk of ``world`` a size, its
    ``results.json`` byte-equal to the serial CLI's; ``memory_reserved()``
    of each card after each chunk, bounded by its value after the first
    chunk plus ``RESERVED_SLACK``."""
    import torch

    from stemseg_tpu_torch.config import save_config
    from stemseg_tpu_torch.inference import main as cli
    from stemseg_tpu_torch.inference.fused_pipeline import FusedSequencePipeline
    from stemseg_tpu_torch.utils.timer import Timer

    data = os.path.join(root, "MX4")
    t0 = time.perf_counter()
    env, ids = write_mixed_ytvis_set(data, per_size=world)
    log(f"  (d) mixed sizes: {len(ids)} YT-VIS sequences of {MIXED_FRAMES} frames written, "
        f"{world} of each size, interleaved ({time.perf_counter() - t0:.1f} s)")
    cfg, model = mixed_size_model(device)
    pth = os.path.join(data, "model", "youtube_vis.pth")
    os.makedirs(os.path.dirname(pth))
    torch.save({"model": model.state_dict()}, pth)
    save_config(cfg, os.path.join(data, "model", "config.yaml"))
    del model
    cards = list(range(world)) if device == "cuda" else []
    chunks, by_chunk = [], []
    run_batch = FusedSequencePipeline.run_batch

    def spy(self, frames_batch, windows_batch, devs, **kwargs):
        out = run_batch(self, frames_batch, windows_batch, devs, **kwargs)
        chunks.append((tuple(f.shape[1:3] for f in frames_batch), len(devs)))
        by_chunk.append({d: reserved_gib(d) for d in cards})
        return out

    results = {}
    FusedSequencePipeline.run_batch = spy
    try:
        with environment(env):
            for name, extra in (("serial", []), ("data_parallel", ["--data_parallel"])):
                out = os.path.join(data, name)
                Timer.reset()
                t1 = time.perf_counter()
                cli.main([pth, "-o", out, "--dataset", "ytvis", "--device", device, *extra])
                log(f"  (d) mixed sizes, {name} CLI: wall {time.perf_counter() - t1:.3f} s")
                with open(os.path.join(out, "results.json"), "rb") as fh:
                    results[name] = fh.read()
    finally:
        FusedSequencePipeline.run_batch = run_batch
    want_chunks = [((h, w),) * world for h, w in MIXED_SIZES.values()]
    if [c for c, _ in chunks] != want_chunks or {n for _, n in chunks} != {world}:
        raise AssertionError(f"(d) mixed sizes: chunks {chunks}, expected one of {world} a size")
    if results["data_parallel"] != results["serial"] or not json.loads(results["serial"]):
        raise AssertionError("(d) mixed sizes: results.json of --data_parallel differs from the "
                             "serial CLI's, or is empty")
    log(f"  (d) mixed sizes: --data_parallel over {world} cards, one chunk of {world} a size "
        f"({list(MIXED_SIZES)}); results.json ({len(results['serial'])} bytes) byte-equal to "
        "the serial CLI's")
    over = {}
    for d in cards:
        seen = [c[d] for c in by_chunk]
        log(f"  (d) mixed sizes: cuda:{d} memory_reserved after each chunk "
            f"{[round(x, 3) for x in seen]} GiB")
        if max(seen) > seen[0] + RESERVED_SLACK / 2 ** 30:
            over[d] = seen
    if over:
        raise AssertionError(f"(d) mixed sizes: memory_reserved grew past the first chunk's + "
                             f"1 GiB on {over}")
    return {d: [c[d] for c in by_chunk] for d in cards}


def main():
    if not os.path.isdir(os.path.join(HERE, "stemseg_tpu_torch")):
        sys.stderr.write("chip_smoke: run it from the root of a checkout\n")
        sys.exit(1)
    sys.path.insert(0, HERE)
    import importlib.util
    import shutil

    import torch

    from stemseg_tpu_torch.ops import build, cluster as ops
    from stemseg_tpu_torch.utils.device import resolve_device

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        sys.exit(1)

    t_start = time.perf_counter()
    log("== phase 1: device")
    resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}, device {kind}, "
        f"count {torch.cuda.device_count()}")
    log(f"  nvidia-smi: {smi}")
    log(f"  cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    # imported lazily: cv2 by the CLI's frame reader, yaml for a config.yaml,
    # PIL by the DAVIS writer (the only one of them the main paths below run)
    present = {m: importlib.util.find_spec(m) is not None for m in ("yaml", "cv2", "PIL")}
    log(f"  optional modules: {present}, ninja: {shutil.which('ninja') or 'absent'}")

    log("== phase 2: build")
    for res in build.build().values():
        regs = [int(w) for line in res.log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:]) if nxt == "registers,"]
        spills = sum(int(line.split("bytes spill stores")[0].split()[-1])
                     for line in res.log.splitlines() if "bytes spill stores" in line)
        log(f"  {res.name}: {res.path} built in {res.seconds:.1f} s; "
            f"{len(regs)} kernels, at most {max(regs, default=0)} registers a thread, "
            f"{spills} bytes of spill stores")

    log("== phase 3: kernels against the plain version")
    t_phase = time.perf_counter()
    kernels = check_kernels(ops)
    log(f"  phase 3: {time.perf_counter() - t_phase:.1f} s")

    with tempfile.TemporaryDirectory() as out_root:
        log("== phase 4: main path A (davis_2, 704x1248, 16-frame windows)")
        frames_a = synthetic_frames(26, 480, 854, seed=MAIN_SEED)
        cfg_a, model_a, launches_a = check_main_path(
            "A", "davis_2", {"clustering": {"min_seediness_prob": 0.05}}, "davis", frames_a,
            "A", "cluster_points_tiled", 2, (26, 176, 312), out_root)
        log("== phase 5: main path B (davis_1, 480x854, 8-frame windows)")
        _, _, launches_b = check_main_path(
            "B", "davis_1", {"input": {"min_dim": 480, "max_dim": 854},
                             "clustering": {"min_seediness_prob": 0.05}}, "davis",
            synthetic_frames(16, 480, 854, seed=MAIN_SEED), "B", "cluster_points_single", 5,
            (16, 120, 216), out_root)
        log("== phase 6: small input, GPU against CPU")
        check_small_input(out_root)
        log("== phase 7: steady state, main path A again (timing only)")
        t0 = time.perf_counter()
        tg = make_track_generator(cfg_a, "davis", model_a, os.path.join(out_root, "A2"))
        run_main_path(tg, frames_a, "A2")
        log(f"  path A steady: wall {time.perf_counter() - t0:.3f} s")
        for line in tg.fps_report():
            log(f"  path A steady: {line}")
        layer_split("A", tg, frames_a, 2, kernels["cluster_points_tiled"]["ms"])
        device_profile(tg, frames_a)
        del tg, model_a
        torch.cuda.empty_cache()

        log("== phase 8: main path C (youtube_vis, 640x1152, 8-frame windows, semseg)")
        t_phase = time.perf_counter()
        frames_c = synthetic_frames(20, 720, 1280, seed=MAIN_SEED)
        launches_c, real_c = semseg_path("C", "youtube_vis", "ytvis", frames_c, "C", 4,
                                         (20, 160, 288), out_root, compare_heads=davis_heads())
        log(f"  phase 8: {time.perf_counter() - t_phase:.1f} s")
        log("== phase 9: main path D (kitti_mots_2, 544x1792, xyt E=3, semseg argmax)")
        t_phase = time.perf_counter()
        launches_d, real_d = semseg_path("D", "kitti_mots_2", "kittimots",
                                         synthetic_frames(16, 375, 1242, seed=MAIN_SEED),
                                         "0002", 3, (16, 136, 448), out_root)
        log(f"  phase 9: {time.perf_counter() - t_phase:.1f} s")
        log("== phase 10: main path C' (youtube_vis, --resize_embeddings, full-scale clustering)")
        t_phase = time.perf_counter()
        launches_c2, real_c2 = semseg_path("C'", "youtube_vis", "ytvis", frames_c[:8], "C2", 1,
                                           (8, 640, 1152), out_root, resize_embeddings=True)
        log(f"  phase 10: {time.perf_counter() - t_phase:.1f} s")
        del frames_c
        torch.cuda.empty_cache()

        log("== phase 11: training path T (davis_1 synthetic, R-101-FPN, 8x736x1248 clips)")
        t_phase = time.perf_counter()
        trainer_t, _ = train_path_t(out_root)
        training_timings("path T", trainer_t, smi)
        launches_t, real_t = train_then_infer(
            trainer_t, synthetic_frames(16, 480, 854, seed=MAIN_SEED), out_root)
        del trainer_t
        torch.cuda.empty_cache()
        log(f"  phase 11: {time.perf_counter() - t_phase:.1f} s")
        log("== phase 12: training path T' (youtube_vis synthetic, semseg 41 + 1, 640x1216)")
        t_phase = time.perf_counter()
        train_path_t2(out_root, smi)
        torch.cuda.empty_cache()
        log(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")
        log("== phase 13: one micro-step, GPU against CPU (small size, TF32 off)")
        check_train_step_gpu_vs_cpu()
        launches_r, real_r = real_data_phases(out_root, smi)

        log("== phase 16: bf16 inference at full width, paths A and C against fp32 "
            "(A also fp32 with TF32)")
        t_phase = time.perf_counter()
        launches_a16, bf16_a = bf16_path("A", "davis_2", "davis", frames_a, "A", 2,
                                         (26, 176, 312), out_root, smi, tf32_reading=True)
        launches_c16, bf16_c = bf16_path("C", "youtube_vis", "ytvis",
                                         synthetic_frames(20, 720, 1280, seed=MAIN_SEED), "C", 4,
                                         (20, 160, 288), out_root, smi)
        log(f"  phase 16: {time.perf_counter() - t_phase:.1f} s")
        log("== phase 17: training path T in bf16 (davis_1 synthetic, mixed_precision)")
        t_phase = time.perf_counter()
        launches_t16, real_t16 = train_path_t_bf16(
            out_root, smi, synthetic_frames(16, 480, 854, seed=MAIN_SEED))
        log(f"  phase 17: {time.perf_counter() - t_phase:.1f} s")
        log("== phase 18: the inference CLI on path T's weights as a JAX .ckpt "
            "(--profile_clustering --save_vis --profile) against its .pth")
        t_phase = time.perf_counter()
        launches_cli, launches_cli_pth = cli_rest_phase(out_root, smi)
        log(f"  phase 18: {time.perf_counter() - t_phase:.1f} s")
        log("== phase 19: the fused path (FusedSequencePipeline) against the streaming path, "
            "the lsap kernel, the clustering kernels replayed from a CUDA graph")
        t_phase = time.perf_counter()
        lsap_row, fused = fused_phase(out_root, smi)
        log(f"  phase 19: {time.perf_counter() - t_phase:.1f} s")
        log("== phase 20: convert -> infer -> score at full width (tools.eval_all on the card, "
            "scoring on the host)")
        t_phase = time.perf_counter()
        launches_eval = eval_phase(out_root, smi)
        log(f"  phase 20: {time.perf_counter() - t_phase:.1f} s")
        log("== phase 21: the dilated decoder trunk (davis_2 widths, path A's window; "
            "GPU against CPU at the tests' size)")
        t_phase = time.perf_counter()
        dilated_phase(smi)
        log(f"  phase 21: {time.perf_counter() - t_phase:.1f} s")
        log("== phase 22: data parallelism (NCCL at world 1, two gloo ranks on one card, "
            "--data_parallel, run_batch), a JAX session restored, a sustained bf16 run")
        t_phase = time.perf_counter()
        launches_dp = dist_phase(out_root, smi)
        log(f"  phase 22: {time.perf_counter() - t_phase:.1f} s")
        log("== phase 24: the fused path across frame sizes (youtube_vis, four raw sizes "
            "alternating, grouped, streaming, growth; the YT-VIS CLI on a mixed-size set)")
        t_phase = time.perf_counter()
        mixed = mixed_size_phase(out_root, smi)
        log(f"  phase 24: {time.perf_counter() - t_phase:.1f} s")

    replaces = {"cluster_points_single": "stemseg_tpu/ops/cluster_pallas.py:103",
                "cluster_points_tiled": "stemseg_tpu/ops/cluster_pallas.py:300"}
    # the fused runs (R's and the .pth's CLI runs, phase 19's paths, phase
    # 20's eval_all runs) replay their kernels from CUDA graphs: the profiler
    # counts their launches
    launches_by_path = {"A": launches_a, "B": launches_b, "C": launches_c, "D": launches_d,
                        "C'": launches_c2, "T": launches_t, "R (profiled)": launches_r,
                        "A bf16": launches_a16, "C bf16": launches_c16, "T bf16": launches_t16,
                        "CLI .ckpt": launches_cli, "CLI .pth (profiled)": launches_cli_pth,
                        **launches_eval,
                        "--data_parallel A bf16 + run_batch (profiled)": launches_dp,
                        "mixed sizes fused (profiled)": mixed["launches"]}
    for path, numbers in fused.items():  # every window of these goes to the tiled kernel
        launches_by_path[f"{path} fused (profiled)"] = {
            "cluster_points_single": 0,
            "cluster_points_tiled": numbers["profile"]["fused"]["launches"]["cluster_kernel"],
            "lsa_masked": numbers["profile"]["fused"]["launches"]["lsa_kernel"]}
    launches = {name: sum(run.get(name, 0) for run in launches_by_path.values())
                for name in (*replaces, "lsa_masked")}
    kernels["cluster_points_tiled"]["real_windows"] = {"C": real_c["kernel_ms_real_window"],
                                                       "D": real_d["kernel_ms_real_window"],
                                                       "C'": real_c2["kernel_ms_real_window"]}
    kernels[real_t[0]].setdefault("real_windows", {})["T"] = real_t[1]
    kernels[real_r[0]].setdefault("real_windows", {})["R"] = real_r[1]
    kernels["cluster_points_tiled"]["real_windows"].update(
        {"A bf16": bf16_a["kernel_ms_real_window"], "C bf16": bf16_c["kernel_ms_real_window"]})
    kernels[real_t16[0]].setdefault("real_windows", {})["T bf16"] = real_t16[1]
    for size, w in mixed["windows"].items():
        kernels[w["kernel"]].setdefault("real_windows", {})[f"{size} mixed"] = w["kernel_ms"]
    keys = ("max_abs_err", "label_mismatches", "ms", "plain_ms", "bound_ms", "bound_by",
            "device_ms", "host_ms_per_call", "cold_l2_ms", "sync_floor_ms", "iterations",
            "points", "e_dims", "at_878592", f"at_{PATH_D_POINTS}_e3", f"at_{PATH_C2_POINTS}_e4",
            "real_windows")
    table = {"kernels": [
        {"name": name, "route": "cuda", "source": "stemseg_tpu_torch/ops/csrc/cluster.cu",
         "replaces": replaces[name], "launches": launches[name], "library_ms": None,
         "launches_by_path": {path: run[name] for path, run in launches_by_path.items()},
         **{k: row[k] for k in keys if k in row}}
        for name, row in kernels.items()]}
    table["kernels"].append({
        "name": "lsa_masked", "route": "cuda", "source": "stemseg_tpu_torch/ops/csrc/lsap.cu",
        "replaces": "stemseg_tpu/inference/lsap.py:121", "launches": launches["lsa_masked"],
        "launches_by_path": {path: run["lsa_masked"] for path, run in launches_by_path.items()
                             if "lsa_masked" in run},
        **lsap_row})
    log("== phase 23 (data parallelism on four cards) runs alone, on a host with four cards: "
        "python3 chip_smoke.py --four-cards")
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:  # a rank of phase 22 (b)
        sys.path.insert(0, HERE)
        two_rank_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--card-worker"]:  # a rank of phase 23 (b), (c), (e)
        sys.path.insert(0, HERE)
        card_rank_worker(sys.argv[2])
    elif sys.argv[1:] == ["--four-cards"]:
        four_cards_main()
    else:
        main()
