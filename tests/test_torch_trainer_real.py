"""The real-dataset training modes of the port's trainer on the CPU, on the
datasets ``chip_smoke.write_training_datasets`` writes at 40x56 frames:

* ``create_training_dataset`` for the ``davis_1``, ``youtube_vis``,
  ``kitti_mots_1`` and ``kitti_mots_2`` presets (inputs cut to 32/48):
  the composition equal to the JAX factory's after ``random.seed(seed)``,
  every sample byte-equal to JAX's after seeding the globals with
  ``sample_seed(seed, i)``, and the collated batches equal to JAX's
  ``collate_fn``'s;
* the ``Trainer`` in ``davis`` mode at narrow width (R-50, 2 frames of
  64x96): 2 optimizer steps of 4 clips; 1 step + SIGINT + resume + 1 step
  bitwise equal to 2 straight; the same batches from 0 and 2 loader
  workers.
"""

import copy
import json
import os
import random
import signal

import numpy as np
import pytest
import torch

from stemseg_tpu.config import load_preset as jax_load_preset
from stemseg_tpu.config import merge as jax_merge
from stemseg_tpu.config import resolve_max_instances as jax_resolve_max_instances
from stemseg_tpu.data.collate import collate_fn as jax_collate_fn
from stemseg_tpu.training.datasets import create_training_dataset as jax_create_training_dataset
from stemseg_tpu_torch.config import load_config, load_preset, merge, resolve_max_instances
from stemseg_tpu_torch.data import ConcatDataset, SparseDataset, sample_seed
from stemseg_tpu_torch.data.collate import collate_fn
from stemseg_tpu_torch.training.datasets import create_training_dataset
from stemseg_tpu_torch.training.main import Trainer
from test_torch_data import TINY_SHAPES, assert_same_sample, chip_smoke
from test_torch_trainer import TRAIN_SMALL, run_trainer, trainer_args, write_cfg

torch.set_num_threads(2)

SEED = 11


@pytest.fixture(scope="module")
def dataset_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_data")
    return chip_smoke.write_training_datasets(str(root), seed=1, shapes=TINY_SHAPES)


@pytest.fixture()
def env(dataset_env, monkeypatch):
    for k, v in dataset_env.items():
        monkeypatch.setenv(k, v)
    return dataset_env


def _composition(ds):
    """What a mixed dataset is made of: per dataset its class, its length,
    its SparseDataset permutation and what each of its samples holds."""
    parts = []
    for d in ds.datasets:
        inner = d.dataset if type(d).__name__ == "SparseDataset" else d
        parts.append((type(d).__name__, type(inner).__name__, len(d),
                      getattr(d, "idxes", None),
                      [(s.id, s.image_paths, s.instance_categories, s.segmentations)
                       if hasattr(s, "image_paths") else (s.path, s.categories, s.segmentations)
                       for s in inner.samples]))
    return parts, ds.id_mapping, ds.samples_per_dataset


@pytest.mark.parametrize("preset,total", [("davis_1", 20), ("youtube_vis", 20),
                                          ("kitti_mots_1", 12), ("kitti_mots_2", 12)])
def test_factory_matches_jax(env, preset, total):
    over = {"input": {"min_dim": 32, "max_dim": 48}, "training": {"max_iterations": 10}}
    cfg, jcfg = merge(load_preset(preset), over), jax_merge(jax_load_preset(preset), over)
    ours = create_training_dataset(cfg, total, seed=SEED, print_fn=lambda *a: None)
    random.seed(SEED)
    theirs = jax_create_training_dataset(jcfg, total, print_fn=lambda *a: None)
    assert isinstance(ours, ConcatDataset) and len(ours) == len(theirs) == total
    assert _composition(ours) == _composition(theirs)
    if preset == "davis_1":  # COCO is cut to its quota
        assert isinstance(ours.datasets[0], SparseDataset)
    if preset == "kitti_mots_1":  # Mapillary's 3 images are repeated
        assert ours.samples_per_dataset == [12] and len(ours.datasets[0]) == 3

    samples = []
    for i in range(total):
        s = sample_seed(SEED, i)
        random.seed(s)
        np.random.seed(s)
        samples.append((ours[i], theirs[i]))
        assert_same_sample(*samples[-1], (preset, i))
    cap = resolve_max_instances(cfg)
    assert cap == jax_resolve_max_instances(jcfg)
    for i in range(0, total, 2):
        pair = [s for s, _ in samples[i:i + 2]]
        a = collate_fn(pair, cap, overflow=cfg.training.instance_overflow)
        b = jax_collate_fn(pair, cap, overflow=jcfg.training.instance_overflow)
        for k in ("images", "masks", "ignore_masks", "category_ids"):
            assert a[k].tobytes() == b[k].tobytes() and a[k].shape == b[k].shape, (preset, i, k)
        assert a["image_sizes"] == b["image_sizes"] and a["orig_dims"] == b["orig_dims"]


REAL_SMALL = copy.deepcopy(TRAIN_SMALL)
REAL_SMALL["training"].update(mode="davis", max_iterations=2, batch_size=4, lr_decay_steps=[1])
REAL_SMALL["data"] = {}


def test_trainer_runs_davis_mode(env, tmp_path):
    trainer = run_trainer(tmp_path / "run", write_cfg(tmp_path, REAL_SMALL))
    assert trainer.elapsed_iterations == 2 and trainer.accumulate_steps == 4
    assert sorted(os.listdir(tmp_path / "run")) == ["000002.pth", "config.yaml", "logs"]
    # COCO and VOC clips pad to 64x96 like DAVIS and YT-VIS at this size
    loader = trainer.make_loader(0)
    loader.batch_sampler.start_iter = 0  # the run's whole stream
    assert [tuple(b["images"].shape) for b in loader] == [(1, 2, 64, 96, 3)] * 8
    with open(tmp_path / "run" / "logs" / "metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    assert [r["step"] for r in records] == [2]
    assert all(np.isfinite(v) for r in records for v in r.values())


def test_one_step_resume_one_step_equals_two_bitwise(env, tmp_path, monkeypatch):
    cfg_path = write_cfg(tmp_path, REAL_SMALL)
    straight = run_trainer(tmp_path / "straight", cfg_path)

    from stemseg_tpu_torch.training.step import TrainStep

    calls = [0]
    call = TrainStep.__call__

    def interrupt_after_one_update(self, batch):
        out = call(self, batch)
        calls[0] += 1
        if calls[0] == 4:
            os.kill(os.getpid(), signal.SIGINT)
        return out

    monkeypatch.setattr(TrainStep, "__call__", interrupt_after_one_update)
    first = run_trainer(tmp_path / "resumed", cfg_path)
    monkeypatch.setattr(TrainStep, "__call__", call)
    assert first.elapsed_iterations == 1
    resumed = run_trainer(tmp_path / "resumed", cfg_path)
    assert resumed.elapsed_iterations == 2
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    oa, ob = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert all(torch.equal(oa["state"][i]["momentum_buffer"], ob["state"][i]["momentum_buffer"])
               for i in oa["state"])


def test_batches_do_not_depend_on_the_worker_count(env, tmp_path):
    trainer = Trainer(load_config(REAL_SMALL), str(tmp_path / "run"),
                      trainer_args(tmp_path / "run", write_cfg(tmp_path, REAL_SMALL)))
    batches = {n: list(trainer.make_loader(n)) for n in (0, 2)}
    assert len(batches[0]) == len(batches[2]) == 8
    for a, b in zip(batches[0], batches[2]):
        for k in ("images", "masks", "ignore_masks", "category_ids"):
            assert torch.equal(a[k], b[k]), k
