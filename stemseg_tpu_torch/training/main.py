"""Training CLI: ``python -m stemseg_tpu_torch.training.main --model_dir D
--cfg davis_1 [--device cuda]``.

The port's counterpart of the JAX package's ``training/main.py``: the
``Trainer`` builds the model (random init from ``INIT_SEED``, frozen stem
and stages marked), the optimizer and the train step; writes
``config.yaml`` into the model dir; resumes from the newest checkpoint
there (or ``--restore_session``), or warm-starts weights only from
``--initial_ckpt``; then runs the loop: ``DataLoader`` workers ->
``non_blocking`` copy of the pinned batch -> micro-steps with one
optimizer update every ``accumulate_steps = round(batch_size /
max_samples_per_chip)`` -> console line, JSONL / tensorboardX scalars,
checkpoints. SIGINT / SIGTERM and
exceptions checkpoint before the trainer exits. ``--profile DIR`` writes a
``torch.profiler`` trace of ``--profile_steps`` optimizer steps after the
first.

Every ``training.mode`` trains: ``davis``, ``youtube_vis`` and
``kitti_mots`` read their datasets from the environment variables of
``data/paths.py``; ``synthetic`` needs none. The real modes' datasets are
built from ``INIT_SEED``, so a batch depends neither on
``--num_cpu_workers`` nor on a resume. It runs on the GPU unless
``--device cpu`` is given. ``training.mixed_precision`` trains in bfloat16
with float32 parameters, gradients, optimizer state and checkpoints.
``--initial_ckpt`` takes a JAX package ``.ckpt`` as well as a ``.pth``
(weights only); ``--restore_session`` takes a JAX trainer's ``.ckpt`` as
well as one of this trainer's, its optimizer state and LR schedule
included (``training/optax_state.py``).

Data parallel: ``torchrun --nproc_per_node N -m
stemseg_tpu_torch.training.main ...`` runs one rank per GPU
(``utils/distributed.py:init_from_env``; ``--dist_backend gloo`` on CUDA
tensors lets two ranks share a GPU). A plain ``python -m`` run is one
process on one device. Every rank draws the same global index stream, in
batches of ``world * max_samples_per_chip``, and keeps its slice
(``parallel.shard_batch``), so the global batch is the one the JAX trainer
takes on ``world`` local devices; ``accumulate_steps = round(batch_size /
(world * max_samples_per_chip))``. The model is replicated from rank 0
after its weights are set; the train step sums each micro-step's gradient
over the ranks. Only rank 0 writes ``config.yaml``, checkpoints, logs and
the console lines; every rank waits at a barrier after a save. An
interrupt on any rank stops all of them at the same step.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Iterator, List, Optional

import torch

from stemseg_tpu_torch.parallel import shard_batch

INIT_SEED = 42


class RankBatches:
    """This rank's slice (``parallel.shard_batch``) of each global batch of
    ``batches``."""

    def __init__(self, batches, rank: int, world: int):
        self.batches, self.rank, self.world = batches, rank, world

    def __iter__(self) -> Iterator[List[int]]:
        return (shard_batch(b, self.rank, self.world) for b in self.batches)

    def __len__(self) -> int:
        return len(self.batches)


class Trainer:
    def __init__(self, cfg, model_dir: str, args):
        from stemseg_tpu_torch.config import save_config
        from stemseg_tpu_torch.models import build_model, init_random_weights
        from stemseg_tpu_torch.parallel import replicate
        from stemseg_tpu_torch.training.checkpoint import (
            find_latest_checkpoint,
            restore_checkpoint,
        )
        from stemseg_tpu_torch.training.interrupt import InterruptDetector
        from stemseg_tpu_torch.training.logger import TrainingLogger
        from stemseg_tpu_torch.training.optim import make_optimizer, trainable_parameters
        from stemseg_tpu_torch.training.step import TrainStep
        from stemseg_tpu_torch.utils.distributed import get_rank, get_world_size, init_from_env

        if args.restore_session and args.initial_ckpt:
            raise ValueError("--restore_session and --initial_ckpt exclude each other")
        self.cfg = cfg
        self.args = args
        self.model_dir = model_dir
        self.device = init_from_env(args.device, args.dist_backend)
        self.rank, self.world = get_rank(), get_world_size()
        self.is_main = self.rank == 0
        if self.is_main:
            os.makedirs(model_dir, exist_ok=True)
            save_config(cfg, os.path.join(model_dir, "config.yaml"))

        self.model = build_model(cfg, device=self.device, for_training=True,
                                 remat=args.remat)
        init_random_weights(self.model, INIT_SEED)
        self.samples_per_step = cfg.training.max_samples_per_chip
        self.accumulate_steps = max(1, int(round(
            cfg.training.batch_size / (self.world * self.samples_per_step))))
        self.optimizer, self.scheduler = make_optimizer(
            cfg.training, trainable_parameters(self.model))
        self.train_step = TrainStep(self.model, cfg, self.optimizer, self.scheduler,
                                    self.accumulate_steps)

        self.logger = TrainingLogger(os.path.join(model_dir, "logs")) if self.is_main else None
        self.interrupt = InterruptDetector()
        self.elapsed_iterations = 0
        self.total_iterations = cfg.training.max_iterations
        # host clock at the end of each optimizer step, and the loader's
        # wait (seconds) per micro-batch, for throughput reports
        self.iteration_end_times = []
        self.loader_waits = []

        restore_path = args.restore_session
        if restore_path is None and not args.no_resume:
            restore_path = find_latest_checkpoint(model_dir)
        if restore_path:
            print(f"Restoring session from {restore_path}")
            extra, self.elapsed_iterations = restore_checkpoint(
                restore_path, self.model, self.optimizer, self.scheduler)
            if self.logger is not None and "logger" in extra:
                self.logger.load_state_dict(extra["logger"])
        elif args.initial_ckpt:
            print(f"Loading model weights from checkpoint at: {args.initial_ckpt}")
            self._load_initial_weights(args.initial_ckpt)
        replicate(self.model)

    def _load_initial_weights(self, path: str):
        """Weights only, from a JAX package ``.ckpt``, a reference ``.pth`` or
        one of this trainer's."""
        from stemseg_tpu_torch.models import load_state_dict_file

        missing, unexpected = self.model.load_state_dict(load_state_dict_file(path),
                                                         strict=False)
        if unexpected:
            raise ValueError(f"{path}: keys this model does not have: {unexpected[:5]}")
        if missing:
            print(f"{len(missing)} tensors not in {path} keep their initial values")

    def backup_session(self, barrier: bool = True) -> Optional[str]:
        """Rank 0 saves the session; then, unless ``barrier`` is False (a
        failing rank's exception path, which the others do not reach), every
        rank waits for the save. :return: the file written on rank 0, else
        None"""
        from stemseg_tpu_torch.training.checkpoint import (
            cleanup_old_checkpoints,
            save_checkpoint,
        )
        from stemseg_tpu_torch.utils.distributed import synchronize

        path = None
        if self.is_main:
            path = save_checkpoint(self.model_dir, self.elapsed_iterations, self.model,
                                   self.optimizer, self.scheduler,
                                   extra={"logger": self.logger.state_dict()})
            cleanup_old_checkpoints(self.model_dir, self.args.ckpts_to_keep)
            print(f"Checkpoint saved to: {path}")
        if barrier:
            synchronize()
        return path

    def make_loader(self, num_workers: int):
        from stemseg_tpu_torch.config import resolve_max_instances
        from stemseg_tpu_torch.data.samplers import (
            BatchSampler,
            IterationBasedBatchSampler,
            ShardedSampler,
        )
        from stemseg_tpu_torch.training.datasets import create_training_dataset
        from stemseg_tpu_torch.training.loader import make_data_loader

        # micro-steps = optimizer steps * accumulate steps; every rank draws
        # the global stream and keeps its slice of each global batch
        total_subiters = self.total_iterations * self.accumulate_steps
        global_batch = self.world * self.samples_per_step
        dataset = create_training_dataset(self.cfg, total_subiters * global_batch,
                                          seed=INIT_SEED)
        batch_sampler = IterationBasedBatchSampler(
            BatchSampler(ShardedSampler(len(dataset)), global_batch),
            num_iterations=total_subiters,
            start_iter=self.elapsed_iterations * self.accumulate_steps)
        if self.world > 1:
            batch_sampler = RankBatches(batch_sampler, self.rank, self.world)
        return make_data_loader(dataset, batch_sampler,
                                max_instances=resolve_max_instances(self.cfg),
                                overflow=self.cfg.training.instance_overflow,
                                num_workers=num_workers,
                                pin_memory=self.device.type == "cuda")

    def _mean_scalars(self, metrics_accum, last=None):
        return {k: float(torch.stack(vs[-last:] if last else vs).mean())
                for k, vs in metrics_accum.items()}

    def start(self):
        from stemseg_tpu_torch.training.interrupt import InterruptException
        from stemseg_tpu_torch.training.loader import to_device
        from stemseg_tpu_torch.utils.profiling import span, start_trace, write_trace

        self.interrupt.start()
        host_batches = iter(self.make_loader(self.args.num_cpu_workers))

        print(f"Commencing/resuming training from iteration {self.elapsed_iterations + 1}")
        last_time = time.time()
        sub_iter = 0
        metrics_accum = {}
        profiler = None
        profile_until = None

        try:
            while self.elapsed_iterations < self.total_iterations:
                t_wait = time.perf_counter()
                with span("train.loader"):
                    host_batch = next(host_batches, None)
                self.loader_waits.append(time.perf_counter() - t_wait)
                if host_batch is None:
                    break
                if (self.args.profile and self.is_main and profiler is None
                        and sub_iter >= self.accumulate_steps):
                    profiler = start_trace(self.device)
                    profile_until = self.elapsed_iterations + self.args.profile_steps

                metrics = self.train_step(to_device(host_batch, self.device))
                sub_iter += 1
                for k, v in metrics.items():
                    metrics_accum.setdefault(k, []).append(v)
                if sub_iter % self.accumulate_steps != 0:
                    continue

                self.elapsed_iterations += 1
                self.iteration_end_times.append(time.perf_counter())
                if profiler is not None and self.elapsed_iterations == profile_until:
                    write_trace(profiler, self.args.profile, self.device)
                if self.is_main:
                    self.logger.add_step(self.elapsed_iterations,
                                         sum(self.loader_waits[-self.accumulate_steps:]))
                if self.is_main and self.elapsed_iterations % self.args.display_interval == 0:
                    scalars = self._mean_scalars(metrics_accum, last=self.accumulate_steps)
                    now = time.time()
                    sec_per_iter = (now - last_time) / self.args.display_interval
                    last_time = now
                    eta = self.logger.compute_eta(self.elapsed_iterations,
                                                  self.total_iterations)
                    print(self.logger.format_console_line(
                        self.elapsed_iterations, self.total_iterations, scalars,
                        sec_per_iter, eta))

                if self.elapsed_iterations % self.args.summary_interval == 0:
                    if self.is_main:
                        self.logger.add_scalars(self._mean_scalars(metrics_accum),
                                                self.elapsed_iterations)
                    metrics_accum = {}

                # after the step's logs, so an interrupted step is logged too
                self.interrupt.raise_if_interrupted(
                    self.device if self.world > 1 else None)
                if self.elapsed_iterations % self.args.save_interval == 0:
                    self.backup_session()

        except InterruptException:
            print(f"Interrupt signal received after iteration {self.elapsed_iterations}: "
                  "checkpointing before exit")
            self.backup_session()
            return
        except Exception:
            print("Exception during training: checkpointing before re-raise")
            self.backup_session(barrier=False)
            raise
        finally:
            if profiler is not None and profile_until is not None \
                    and self.elapsed_iterations < profile_until:
                write_trace(profiler, self.args.profile, self.device)
            del host_batches  # shuts the loader's workers down
            self.interrupt.stop()
            if self.logger is not None:
                self.logger.close()

        print("Training complete")
        self.backup_session()


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train STEm-Seg (PyTorch / CUDA)")
    parser.add_argument("--model_dir", type=str, required=True)
    parser.add_argument("--cfg", type=str, required=True,
                        help="preset name (e.g. davis_1) or a YAML / JSON path")
    parser.add_argument("--restore_session", type=str,
                        help="a session to restore: one of this trainer's .pth files or "
                             "a JAX trainer's .ckpt")
    parser.add_argument("--initial_ckpt", type=str,
                        help="weights only: a JAX package .ckpt, a reference .pth or one "
                             "of this trainer's")
    parser.add_argument("--no_resume", action="store_true")
    parser.add_argument("--display_interval", type=int, default=5)
    parser.add_argument("--summary_interval", type=int, default=10)
    parser.add_argument("--save_interval", type=int, default=10000)
    parser.add_argument("--num_cpu_workers", type=int, default=8)
    parser.add_argument("--ckpts_to_keep", type=int, default=2)
    parser.add_argument("--profile", metavar="DIR", required=False,
                        help="write a torch.profiler chrome trace of --profile_steps "
                             "optimizer steps (after the first) to DIR/trace.json")
    parser.add_argument("--profile_steps", type=int, default=5)
    parser.add_argument("--remat", action="store_true",
                        help="recompute the backbone body's activations in the "
                             "backward instead of keeping them")
    parser.add_argument("--device", default="cuda",
                        help="torch device; 'cpu' for a CPU run (under torchrun, "
                             "'cuda' is each rank's cuda:LOCAL_RANK)")
    parser.add_argument("--dist_backend", choices=["nccl", "gloo"],
                        help="process-group backend under torchrun (default: nccl on "
                             "CUDA, gloo on the CPU; gloo lets ranks share a GPU)")
    return parser


def main(argv=None):
    args = make_parser().parse_args(argv)

    from stemseg_tpu_torch.config import load_config, load_preset

    cfg = load_config(args.cfg) if os.path.exists(args.cfg) else load_preset(args.cfg)
    try:
        Trainer(cfg, args.model_dir, args).start()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
