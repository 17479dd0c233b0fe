"""The port's trainer runtime on the CPU, against the JAX package where the
two share a contract:

* synthetic samples byte-equal to the JAX dataset's; ``collate_fn`` (every
  overflow policy) and the sampler streams equal; a resumed sampler
  continues the uninterrupted stream (the JAX sampler does not: ROADMAP
  §C);
* a 4-iteration ``Trainer`` run (narrow R-50, 2 frames of 64x96,
  ``batch_size`` 2 so two micro-steps an update): checkpoints,
  ``metrics.jsonl``, ``config.yaml``; 4 steps straight equal 2 + SIGINT +
  resume + 2 bitwise, optimizer and scheduler state included;
* ``ckpts_to_keep``, ``--initial_ckpt`` warm start at iteration 0;
* the saved ``config.yaml`` loads in the JAX ``load_config`` to the same
  tree; the trained ``.pth`` runs through the port's inference CLI;
* ``--profile`` writes a trace; ``mixed_precision`` trains in bf16 with
  float32 weights; ``--initial_ckpt`` and the inference CLI's loader read a
  JAX ``.ckpt`` to the weights of the ``.pth``; ``--restore_session`` of a
  truncated JAX ``.ckpt`` raises, and so do the real-data modes without
  their datasets; the loader re-raises a worker's error and shuts its workers
  down.
"""

import copy
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from stemseg_tpu.config import load_config as jax_load_config
from stemseg_tpu.config import to_dict as jax_to_dict
from stemseg_tpu.data.collate import collate_fn as jax_collate_fn
from stemseg_tpu.data.samplers import BatchSampler as JaxBatchSampler
from stemseg_tpu.data.samplers import IterationBasedBatchSampler as JaxIterSampler
from stemseg_tpu.data.samplers import ShardedSampler as JaxShardedSampler
from stemseg_tpu.data.synthetic import SyntheticBlobDataset as JaxSynthetic
from stemseg_tpu_torch.config import load_config, save_config, to_dict
from stemseg_tpu_torch.data.collate import collate_fn
from stemseg_tpu_torch.data.samplers import (
    BatchSampler,
    IterationBasedBatchSampler,
    ShardedSampler,
)
from stemseg_tpu_torch.data.synthetic import SyntheticBlobDataset
from stemseg_tpu_torch.training.main import Trainer, make_parser
from test_torch_model import SMALL

torch.set_num_threads(2)

TRAIN_SMALL = copy.deepcopy(SMALL)
TRAIN_SMALL["input"].update(num_frames=2, min_dim=64, max_dim=96)
TRAIN_SMALL["training"].update(mode="synthetic", max_iterations=4, batch_size=2,
                               initial_lr=0.01, lr_decay_type="step", lr_decay_steps=[3])
TRAIN_SMALL["data"] = {"synthetic": {"max_instances": 3, "seed": 5}}


def write_cfg(tmp_path, over=None):
    path = str(tmp_path / "cfg.yaml")
    save_config(load_config(TRAIN_SMALL if over is None else over), path)
    return path


def trainer_args(model_dir, cfg_path, *extra):
    return make_parser().parse_args(
        ["--model_dir", str(model_dir), "--cfg", cfg_path, "--device", "cpu",
         "--display_interval", "1", "--summary_interval", "2", "--save_interval", "2",
         "--num_cpu_workers", "2", *extra])


def run_trainer(model_dir, cfg_path, *extra):
    args = trainer_args(model_dir, cfg_path, *extra)
    trainer = Trainer(load_config(cfg_path), str(model_dir), args)
    trainer.start()
    return trainer


@pytest.mark.parametrize("hw", [None, (40, 72)])
def test_synthetic_samples_byte_equal_to_jax(hw):
    over = copy.deepcopy(TRAIN_SMALL)
    if hw:
        over["data"]["synthetic"].update(height=hw[0], width=hw[1])
    cfg, jcfg = load_config(over), jax_load_config(over)
    kw = dict(height=cfg.data.synthetic.height or None, width=cfg.data.synthetic.width or None,
              max_instances=3, seed=5)
    ours, theirs = SyntheticBlobDataset(cfg.input, 6, **kw), JaxSynthetic(jcfg.input, 6, **kw)
    assert len(ours) == len(theirs) == 6
    for i in range(6):
        a, b = ours[i], theirs[i]
        assert a.keys() == b.keys()
        for k in ("images", "masks", "ignore_masks", "category_ids"):
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), (i, k)
        assert a["orig_dims"] == b["orig_dims"]


@pytest.mark.parametrize("overflow", ["ignore", "drop", "error"])
def test_collate_matches_jax(overflow):
    cfg = load_config(TRAIN_SMALL)
    samples = [SyntheticBlobDataset(cfg.input, 4, height=h, width=w, max_instances=5,
                                    seed=1)[i] for i, (h, w) in enumerate(
                                        [(64, 96), (50, 70), (64, 96)])]
    assert max(s["masks"].shape[0] for s in samples) > 2
    kwargs = dict(max_instances=2, overflow=overflow)
    if overflow == "error":
        for fn in (collate_fn, jax_collate_fn):
            with pytest.raises(ValueError, match="max_instances"):
                fn(samples, **kwargs)
        return
    ours, theirs = collate_fn(samples, **kwargs), jax_collate_fn(samples, **kwargs)
    assert ours["images"].shape == (3, 2, 64, 96, 3)
    for k in ("images", "masks", "ignore_masks", "category_ids"):
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert ours["image_sizes"] == theirs["image_sizes"]


def sampler_stream(mod, n, batch, iters, start, replicas=1, rank=0):
    sharded, batcher, iterate = mod
    return list(iterate(batcher(sharded(n, num_replicas=replicas, rank=rank), batch),
                        num_iterations=iters, start_iter=start))


PORT = (ShardedSampler, BatchSampler, IterationBasedBatchSampler)
JAX = (JaxShardedSampler, JaxBatchSampler, JaxIterSampler)


@pytest.mark.parametrize("replicas,rank", [(1, 0), (2, 1)])
def test_sampler_streams_match_jax(replicas, rank):
    # 11 samples in batches of 2: a pass holds 5 (or 3) batches, 12 iterations
    # run over several epochs
    for n in (11, 7):
        want = sampler_stream(JAX, n, 2, 12, 0, replicas, rank)
        assert sampler_stream(PORT, n, 2, 12, 0, replicas, rank) == want
        assert len(want) == 12
        for start in (1, 5, 7, 12):
            # resumed: the tail of the uninterrupted stream
            assert sampler_stream(PORT, n, 2, 12, start, replicas, rank) == want[start:]
    # the JAX sampler instead reseeds a new pass with start_iter
    assert sampler_stream(JAX, 11, 2, 12, 2) != sampler_stream(JAX, 11, 2, 12, 0)[2:]


def test_trainer_run_writes_checkpoints_metrics_and_config(tmp_path):
    cfg_path = write_cfg(tmp_path)
    trainer = run_trainer(tmp_path / "run", cfg_path)
    assert trainer.elapsed_iterations == 4 and trainer.accumulate_steps == 2
    files = sorted(os.listdir(tmp_path / "run"))
    assert files == ["000002.pth", "000004.pth", "config.yaml", "logs"]
    with open(tmp_path / "run" / "logs" / "metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    assert [r["step"] for r in records] == [2, 4]
    assert {"total", "lovasz", "var_smoothness", "seediness", "total_embedding",
            "grad_norm"} <= set(records[0])
    assert all(np.isfinite(v) for r in records for v in r.values())
    assert len(trainer.iteration_end_times) == 4 and len(trainer.loader_waits) == 8
    ckpt = torch.load(tmp_path / "run" / "000004.pth", weights_only=True)
    assert ckpt["step"] == 4 and ckpt["scheduler"]["last_epoch"] == 4
    assert ckpt["extra"]["logger"]["elapsed"] > 0


def test_four_steps_equal_two_plus_resume_plus_two_bitwise(tmp_path, monkeypatch):
    cfg_path = write_cfg(tmp_path)
    straight = run_trainer(tmp_path / "straight", cfg_path)

    from stemseg_tpu_torch.training.step import TrainStep

    calls = [0]
    call = TrainStep.__call__

    def interrupt_after_two_updates(self, batch):
        out = call(self, batch)
        calls[0] += 1
        if calls[0] == 4:
            os.kill(os.getpid(), signal.SIGINT)
        return out

    monkeypatch.setattr(TrainStep, "__call__", interrupt_after_two_updates)
    first = run_trainer(tmp_path / "resumed", cfg_path)
    monkeypatch.setattr(TrainStep, "__call__", call)
    assert first.elapsed_iterations == 2
    assert sorted(os.listdir(tmp_path / "resumed"))[:1] == ["000002.pth"]
    assert signal.getsignal(signal.SIGINT) is signal.default_int_handler

    resumed = run_trainer(tmp_path / "resumed", cfg_path)
    assert resumed.elapsed_iterations == 4
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    oa, ob = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert all(torch.equal(oa["state"][i]["momentum_buffer"], ob["state"][i]["momentum_buffer"])
               for i in oa["state"])
    assert straight.scheduler.state_dict() == resumed.scheduler.state_dict()


def test_ckpts_to_keep_and_initial_ckpt_warm_start(tmp_path):
    cfg_path = write_cfg(tmp_path)
    donor = run_trainer(tmp_path / "donor", cfg_path, "--save_interval", "1",
                        "--ckpts_to_keep", "1")
    assert sorted(f for f in os.listdir(tmp_path / "donor") if f.endswith(".pth")) == \
        ["000004.pth"]

    args = trainer_args(tmp_path / "warm", cfg_path, "--initial_ckpt",
                        str(tmp_path / "donor" / "000004.pth"), "--no_resume")
    warm = Trainer(load_config(cfg_path), str(tmp_path / "warm"), args)
    assert warm.elapsed_iterations == 0 and warm.scheduler.last_epoch == 0
    a, b = donor.model.state_dict(), warm.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not warm.optimizer.state  # weights only


def test_saved_config_loads_in_jax(tmp_path):
    over = copy.deepcopy(TRAIN_SMALL)
    over["model"]["resnets"]["width_per_group"] = 16
    trainer = Trainer(load_config(over), str(tmp_path / "run"),
                      trainer_args(tmp_path / "run", write_cfg(tmp_path, over)))
    saved = str(tmp_path / "run" / "config.yaml")
    assert jax_to_dict(jax_load_config(saved)) == to_dict(trainer.cfg)
    assert to_dict(load_config(saved)) == to_dict(trainer.cfg)


def test_trained_checkpoint_runs_through_the_inference_cli(tmp_path, monkeypatch):
    """The trainer's model dir as it is (``{iter:06d}.pth`` beside its
    ``config.yaml``) goes through ``stemseg_tpu_torch.inference.main``."""
    import cv2

    from stemseg_tpu_torch.inference import main as cli
    from test_torch_inference import synthetic_frames

    cfg_path = write_cfg(tmp_path)
    trainer = run_trainer(tmp_path / "run", cfg_path)
    ckpt = str(tmp_path / "run" / "000004.pth")

    cfg = cli.load_inference_cfg(ckpt, "davis", None, None, None)
    assert to_dict(cfg) == to_dict(trainer.cfg)
    model = cli.load_model(cfg, ckpt, device="cpu")
    a, b = trainer.model.state_dict(), model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)

    frames = synthetic_frames()[:6]
    base = tmp_path / "davis"
    (base / "seqA").mkdir(parents=True)
    paths = []
    for t, frame in enumerate(frames):
        paths.append(f"seqA/{t:05d}.png")
        cv2.imwrite(str(base / paths[-1]), frame)
    ann = tmp_path / "ann"
    ann.mkdir()
    (ann / "davis_val.json").write_text(json.dumps({
        "meta": {"category_labels": {"1": "object"}},
        "sequences": [{"id": "seqA", "height": frames.shape[1], "width": frames.shape[2],
                       "image_paths": paths}]}))
    monkeypatch.setenv("DAVIS_BASE_DIR", str(base))
    monkeypatch.setenv("STEMSEG_JSON_ANNOTATIONS_DIR", str(ann))
    cli.main([ckpt, "-o", "inference", "--dataset", "davis", "-fo", "1", "--device", "cpu"])
    out = tmp_path / "run" / "inference" / "results" / "seqA"
    assert sorted(os.listdir(out)) == [f"{t:05d}.png" for t in range(6)]


def test_profile_writes_a_trace(tmp_path):
    cfg_path = write_cfg(tmp_path)
    run_trainer(tmp_path / "run", cfg_path, "--profile", str(tmp_path / "trace"),
                "--profile_steps", "2")
    with open(tmp_path / "trace" / "trace.json") as fh:
        trace = json.load(fh)
    assert any("conv" in e.get("name", "") for e in trace["traceEvents"])


@pytest.mark.parametrize("case", ["davis", "youtube_vis", "kitti_mots",
                                  "restore_session_jax_ckpt"])
def test_what_is_not_ported_raises(tmp_path, case, monkeypatch):
    """What cannot be read raises: a truncated JAX session (``.ckpt``) given
    to ``--restore_session`` raises a ``ValueError`` naming the file; the
    real-data modes raise only without their datasets, naming the first
    environment variable they read."""
    over = copy.deepcopy(TRAIN_SMALL)
    extra = []
    if case == "restore_session_jax_ckpt":
        (tmp_path / "w.ckpt").write_bytes(b"\x83\xa5state\x80")  # a map of 3, cut after one
        extra = ["--restore_session", str(tmp_path / "w.ckpt")]
        error, match = ValueError, "w.ckpt: msgpack data ends inside an object"
    else:
        over["training"]["mode"] = case
        over["input"]["num_classes"] = {"davis": 2, "youtube_vis": 41, "kitti_mots": 3}[case]
        over["data"] = {}
        for var in ("COCO_TRAIN_IMAGES_DIR", "KITTIMOTS_BASE_DIR"):
            monkeypatch.delenv(var, raising=False)
        error, match = KeyError, ("KITTIMOTS_BASE_DIR" if case == "kitti_mots"
                                  else "COCO_TRAIN_IMAGES_DIR")
    cfg_path = write_cfg(tmp_path, over)
    with pytest.raises(error, match=match):
        run_trainer(tmp_path / "run", cfg_path, *extra)


def test_mixed_precision_trains_in_bf16_with_float32_weights(tmp_path):
    over = copy.deepcopy(TRAIN_SMALL)
    over["training"]["mixed_precision"] = True
    trainer = run_trainer(tmp_path / "run", write_cfg(tmp_path, over))
    assert trainer.elapsed_iterations == 4
    assert trainer.model.compute_dtype == torch.bfloat16
    assert {p.dtype for p in trainer.model.parameters()} == {torch.float32}
    with open(tmp_path / "run" / "logs" / "metrics.jsonl") as fh:
        records = [json.loads(line) for line in fh]
    assert [r["step"] for r in records] == [2, 4]
    assert all(np.isfinite(v) for r in records for v in r.values())
    # the same run in float32 starts from the same weights and batches
    fp32 = Trainer(load_config(TRAIN_SMALL), str(tmp_path / "fp32"),
                   trainer_args(tmp_path / "fp32", write_cfg(tmp_path)))
    assert fp32.model.compute_dtype is None


@pytest.fixture(scope="module")
def jax_session(tmp_path_factory):
    """A JAX trainer's ``.ckpt`` of random weights (``save_checkpoint`` of its
    ``TrainState``) and the port's ``.pth`` of the same weights."""
    import jax

    from stemseg_tpu.models import build_model as jax_build_model
    from stemseg_tpu.training.checkpoint import save_checkpoint
    from stemseg_tpu.training.step import create_train_state
    from stemseg_tpu_torch.models import state_dict_from_jax
    from test_torch_model import random_variables

    jcfg = jax_load_config(TRAIN_SMALL)
    jmodel = jax_build_model(jcfg, for_training=True)
    variables = random_variables(jmodel, (1, 2, 64, 96, 3), 9)
    state, _ = create_train_state(jmodel, jcfg, jax.random.PRNGKey(0),
                                  np.zeros((1, 2, 64, 96, 3), np.float32))
    root = tmp_path_factory.mktemp("jax_session")
    ckpt = save_checkpoint(str(root), 6, state.replace(params=variables["params"],
                                                       constants=variables["constants"]))
    pth = str(root / "weights.pth")
    torch.save(state_dict_from_jax(variables), pth)
    return ckpt, pth


def test_initial_ckpt_reads_a_jax_ckpt(tmp_path, jax_session):
    ckpt, pth = jax_session
    cfg_path = write_cfg(tmp_path)
    warm = {}
    for kind, path in (("ckpt", ckpt), ("pth", pth)):
        args = trainer_args(tmp_path / kind, cfg_path, "--initial_ckpt", path)
        warm[kind] = Trainer(load_config(cfg_path), str(tmp_path / kind), args)
        assert warm[kind].elapsed_iterations == 0 and not warm[kind].optimizer.state
    a, b = warm["ckpt"].model.state_dict(), warm["pth"].model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["backbone.fpn.fpn_inner1.weight"],
                           Trainer(load_config(cfg_path), str(tmp_path / "cold"),
                                   trainer_args(tmp_path / "cold", cfg_path)).model.state_dict()[
                               "backbone.fpn.fpn_inner1.weight"])


def test_inference_cli_reads_a_jax_ckpt(jax_session):
    from stemseg_tpu_torch.inference.main import load_model

    ckpt, pth = jax_session
    cfg = load_config(TRAIN_SMALL)
    a = load_model(cfg, ckpt, device="cpu").state_dict()
    b = load_model(cfg, pth, device="cpu").state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="expected a .pth or a JAX package .ckpt"):
        load_model(cfg, "model.msgpack", device="cpu")


def test_loader_reraises_a_worker_error_and_joins_its_threads():
    import gc
    import multiprocessing

    from stemseg_tpu_torch.training.loader import make_data_loader

    cfg = load_config(TRAIN_SMALL)
    good = SyntheticBlobDataset(cfg.input, 8, height=32, width=32)

    class Flaky:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("sample 5")
            return good[i]

    threads, children = threading.active_count(), set(multiprocessing.active_children())
    seen = []
    with pytest.raises(KeyError, match="sample 5"):
        for batch in make_data_loader(Flaky(), [[i] for i in range(8)], max_instances=4,
                                      num_workers=3):
            seen.append(batch["images"].shape)
    assert seen == [(1, 2, 32, 32, 3)] * 5  # in sampler order up to the failing batch
    assert torch.is_tensor(batch["masks"]) and batch["masks"].dtype == torch.uint8
    # the raised error holds the iterator in a reference cycle; once it is
    # collected, its workers and queue threads are gone
    gc.collect()
    assert threading.active_count() == threads
    assert set(multiprocessing.active_children()) == children
