"""Data-parallel training of the port over ``torch.distributed`` (gloo, one
CPU process a rank) against the JAX package's mesh step, DAVIS-shaped,
R-50-FPN at narrow widths, 2 frames of 64x96:

* R = 2 and 4 ranks at ``max_samples_per_chip`` 1 and ``batch_size`` 2R (two
  accumulated micro-steps an update), on global batches whose ranks hold
  different instance counts, against ``make_train_step(mesh=create_mesh(R))``
  on the conftest's virtual devices: the global loss terms within 2e-4, the
  first micro-step's gradient within a per-leaf relative L2 of 2e-3 (JAX's
  from ``value_and_grad`` jitted over the same mesh), the deltas of 3
  optimizer steps within 2e-3 per leaf; normalising each rank's loss by its
  own counts (a mean of per-rank means) misses the gradient bound;
* R ranks at ``per_chip`` 1 equal one process at ``per_chip`` R, and at
  R = 4 the global batch's clips one at a time in one process
  (``chip_smoke.per_clip_reference``);
* each rank's index stream is its slice of the JAX trainer's;
* the CLI on 2 ranks: a SIGINT to rank 1 stops both at one step, rank 0
  checkpoints once, both exit 0, and a relaunch on 2 ranks resumes there
  and completes.

Every rank is a subprocess of this file (``python test_torch_distributed.py
WORKER_SPEC RANK``) with its own timeout."""

import copy
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RANK_TIMEOUT = 120  # seconds a rank's process may take

torch.set_num_threads(2)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), PYTHONPATH=REPO,
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    return env


def run_ranks(args_of_rank, world: int, timeout: float = RANK_TIMEOUT):
    """Runs ``world`` processes (``args_of_rank(rank)`` after the
    interpreter) as one process group; returns their outputs, raising on a
    non-zero exit or a timeout."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, *args_of_rank(r)], env=rank_env(r, world, port),
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return outs


# -- the rank worker ------------------------------------------------------------

def worker(spec_path: str, rank: int) -> None:
    """One rank: the first micro-step's gradient with global normalisers
    and with per-rank ones, then 3 optimizer steps; rank 0 saves them."""
    import torch.distributed as dist

    from stemseg_tpu_torch.config import load_config
    from stemseg_tpu_torch.models import build_model
    from stemseg_tpu_torch.parallel import all_reduce_sum_, replicate, shard_batch
    from stemseg_tpu_torch.training.loader import loader_batch, to_device
    from stemseg_tpu_torch.training.optim import make_optimizer, trainable_parameters
    from stemseg_tpu_torch.training.step import TrainStep, make_output_loss_fn
    from stemseg_tpu_torch.utils.distributed import (
        get_rank,
        get_world_size,
        init_from_env,
        is_distributed,
        is_main_process,
        pmean_dict,
    )

    with open(spec_path) as fh:
        spec = json.load(fh)
    init_from_env("cpu")
    world = get_world_size()
    assert get_rank() == rank and is_distributed() and is_main_process() == (rank == 0)
    assert pmean_dict({"rank": rank, "one": 1.0}) == {"rank": (world - 1) / 2, "one": 1.0}
    cfg = load_config(spec["over"])
    weights = torch.load(spec["weights"], weights_only=True)
    data = np.load(spec["batches"])
    rows = shard_batch(list(range(world)), rank, world)

    def micro_batch(k):
        return to_device(loader_batch({key: data[key][k][rows] for key in data.files}, 4),
                         torch.device("cpu"))

    def fresh():
        model = build_model(cfg, device="cpu", for_training=True)
        model.load_state_dict(weights)
        replicate(model)
        return (model, *make_optimizer(cfg.training, trainable_parameters(model)))

    def named_grads(model, grads=None):
        params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        return {n: (p.grad if grads is None else g).clone()
                for (n, p), g in zip(params, grads or [None] * len(params))}

    model, opt, sched = fresh()
    step = TrainStep(model, cfg, opt, sched, accumulate_steps=2)  # no update after one call
    probe_metrics = {k: float(v) for k, v in step(micro_batch(0)).items()}
    probe = named_grads(model)

    # what a port that normalises each rank's loss by its own counts gets: a
    # mean of the ranks' per-sequence-batch gradients
    model, opt, sched = fresh()
    batch = micro_batch(0)
    out = model(batch["images"].permute(0, 1, 4, 2, 3))
    total, _ = make_output_loss_fn(cfg, torch.device("cpu"))(out, batch)
    params = trainable_parameters(model)
    grads = [g / world for g in torch.autograd.grad(total, params)]
    all_reduce_sum_(grads)
    per_rank = named_grads(model, grads)

    model, opt, sched = fresh()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = TrainStep(model, cfg, opt, sched, accumulate_steps=spec["accumulate"])
    metrics = [{k: float(v) for k, v in step(micro_batch(k)).items()}
               for k in range(data["images"].shape[0])]
    after = model.state_dict()
    if rank == 0:
        torch.save({"probe_metrics": probe_metrics, "probe": probe, "per_rank": per_rank,
                    "metrics": metrics, "deltas": {k: after[k] - before[k] for k in after},
                    "last_epoch": sched.last_epoch}, spec["out"])
    dist.destroy_process_group()


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]))
    sys.exit(0)


# -- the tests ------------------------------------------------------------------

import jax  # noqa: E402
import optax  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from stemseg_tpu.config import load_config as jax_load_config  # noqa: E402
from stemseg_tpu.data.samplers import BatchSampler as JaxBatchSampler  # noqa: E402
from stemseg_tpu.data.samplers import IterationBasedBatchSampler as JaxIterSampler  # noqa: E402
from stemseg_tpu.data.samplers import ShardedSampler as JaxShardedSampler  # noqa: E402
from stemseg_tpu.parallel import create_mesh, shard_batch as jax_shard_batch  # noqa: E402
from stemseg_tpu.training.optim import make_optimizer as jax_make_optimizer  # noqa: E402
from stemseg_tpu.training.step import TrainState, make_loss_fn, make_train_step  # noqa: E402
from stemseg_tpu_torch.config import load_config, save_config  # noqa: E402
from stemseg_tpu_torch.models import build_model, state_dict_from_jax  # noqa: E402
from stemseg_tpu_torch.training.optim import make_optimizer, trainable_parameters  # noqa: E402
from stemseg_tpu_torch.training.step import TrainStep  # noqa: E402
from test_torch_train_step import (  # noqa: E402
    DAVIS_SMALL,
    GRAD_REL_L2,
    LOSS_RTOL,
    Setup,
    jax_param_sd,
    make_batch,
    rel_l2,
    torch_batch,
)
from test_torch_trainer import TRAIN_SMALL, trainer_args  # noqa: E402

sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the repo root: phase 23's one-process reference)

N_MICRO = 6  # 3 optimizer steps of 2 micro-steps


def over_for(world: int) -> dict:
    over = copy.deepcopy(DAVIS_SMALL)
    over["training"].update(batch_size=2 * world, max_samples_per_chip=1)
    return over


def global_batches(world: int):
    """``N_MICRO`` global batches of ``world`` sequences (numpy, the host
    contract); sequence r of micro-step k holds 1 + (r + k) % 3 instances,
    so the ranks' counts differ."""
    batches = [[make_batch(100 * k + r, n_inst=1 + (r + k) % 3) for r in range(world)]
               for k in range(N_MICRO)]
    return {key: np.stack([np.concatenate([b[key] for b in micro]) for micro in batches])
            for key in batches[0][0]}


@pytest.fixture(scope="module")
def davis():
    return Setup(DAVIS_SMALL)


def jax_mesh_reference(setup, over, data, world):
    """JAX on a mesh of ``world`` virtual devices: the first micro-step's
    metrics and gradient (``value_and_grad`` of the step's loss with the
    batch sharded over the mesh), then 3 optimizer steps of
    ``make_train_step(mesh=...)``: their metrics and parameter deltas."""
    jcfg = jax_load_config(over)
    mesh = create_mesh(world)
    rep, shard = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    params0, constants = setup.variables["params"], setup.variables["constants"]
    micro = [jax_shard_batch({k: data[k][i] for k in data}, mesh) for i in range(N_MICRO)]

    grad_fn = jax.jit(jax.value_and_grad(make_loss_fn(setup.jmodel, jcfg), has_aux=True),
                      in_shardings=(rep, rep, shard))
    (_, probe_metrics), probe = grad_fn(params0, constants, micro[0])

    tx = optax.MultiSteps(jax_make_optimizer(jcfg.training, params0, freeze_at_stage=2),
                          every_k_schedule=2)
    step = make_train_step(setup.jmodel, jcfg, tx, mesh=mesh, donate=False)
    state = jax.device_put(TrainState(step=np.zeros((), np.int32), params=params0,
                                      constants=constants, opt_state=tx.init(params0)), rep)
    metrics = []
    for b in micro:
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    deltas = jax_param_sd(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                       state.params, params0))
    return ({k: float(v) for k, v in probe_metrics.items()}, jax_param_sd(probe), metrics,
            deltas)


def worst_leaf(got, want, names):
    return max((rel_l2(got[n].numpy(), want[n]), n) for n in names)


_MESH_RUNS = {}


def mesh_ranks(davis, world, tmp_path_factory):
    """(config overrides, global batches, rank 0's output) of ``world``
    gloo ranks of ``worker``; run once per world in this module."""
    if world not in _MESH_RUNS:
        tmp_path = tmp_path_factory.mktemp(f"ranks{world}")
        over = over_for(world)
        data = global_batches(world)
        np.savez(tmp_path / "batches.npz", **data)
        torch.save(state_dict_from_jax(davis.variables), tmp_path / "weights.pt")
        spec = {"over": over, "weights": str(tmp_path / "weights.pt"),
                "batches": str(tmp_path / "batches.npz"), "out": str(tmp_path / "out.pt"),
                "accumulate": 2}
        (tmp_path / "spec.json").write_text(json.dumps(spec))
        run_ranks(lambda r: [os.path.abspath(__file__), str(tmp_path / "spec.json"), str(r)],
                  world)
        _MESH_RUNS[world] = (over, data, torch.load(tmp_path / "out.pt", weights_only=True))
    return _MESH_RUNS[world]


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_match_the_jax_mesh_step(davis, tmp_path_factory, world):
    over, data, got = mesh_ranks(davis, world, tmp_path_factory)
    counts = (data["masks"].reshape(N_MICRO, world, 3, -1).max(-1) > 0).sum(-1)
    assert all(len(set(row)) > 1 for row in counts)  # the ranks' instance counts differ

    probe_metrics, probe, metrics, deltas = jax_mesh_reference(davis, over, data, world)
    trainable = sorted(got["probe"])
    for k, v in probe_metrics.items():
        np.testing.assert_allclose(got["probe_metrics"][k], v, rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=k)
    worst = worst_leaf(got["probe"], probe, trainable)
    assert worst[0] <= GRAD_REL_L2, worst
    # a mean of per-rank means is another loss: it misses the bound
    assert worst_leaf(got["per_rank"], probe, trainable)[0] > GRAD_REL_L2

    assert got["last_epoch"] == 3
    for k in range(N_MICRO):
        for key, v in metrics[k].items():
            np.testing.assert_allclose(got["metrics"][k][key], v, rtol=LOSS_RTOL, atol=1e-6,
                                       err_msg=f"micro-step {k} {key}")
    worst = worst_leaf(got["deltas"], deltas, trainable)
    assert worst[0] <= GRAD_REL_L2, worst

    # R ranks at per_chip 1 against one process at per_chip R
    cfg = load_config(over)
    model = build_model(cfg, device="cpu", for_training=True)
    model.load_state_dict(state_dict_from_jax(davis.variables))
    opt, sched = make_optimizer(cfg.training, trainable_parameters(model))
    one = TrainStep(model, cfg, opt, sched, accumulate_steps=2)
    metrics_one = one(torch_batch({k: v[0] for k, v in data.items()}))
    for k, v in metrics_one.items():
        np.testing.assert_allclose(got["probe_metrics"][k], float(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    one_grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.requires_grad}
    worst = worst_leaf(got["probe"], one_grads, trainable)
    assert worst[0] <= 1e-5, worst


def test_per_clip_reference_equals_four_ranks(davis, tmp_path_factory):
    """``chip_smoke.per_clip_reference``, phase 23's one-process reference
    (b)(ii): a global batch's 4 clips one at a time, each loss over the
    global normalisers, the gradients summed, equals 4 gloo ranks' first
    micro-step: loss terms within 1e-5 relative, every leaf within 1e-5."""
    over, data, got = mesh_ranks(davis, 4, tmp_path_factory)
    cfg = load_config(over)
    model = build_model(cfg, device="cpu", for_training=True)
    model.load_state_dict(state_dict_from_jax(davis.variables))
    batch = torch_batch({k: v[0] for k, v in data.items()})
    grads, terms = chip_smoke.per_clip_reference(model, cfg, batch, 4)
    assert sorted(grads) == sorted(got["probe"])
    for k, v in terms.items():
        np.testing.assert_allclose(got["probe_metrics"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    worst = worst_leaf(got["probe"], {n: g.numpy() for n, g in grads.items()}, sorted(grads))
    assert worst[0] <= 1e-5, worst


@pytest.mark.parametrize("world", [2, 4])
def test_each_rank_draws_its_slice_of_the_jax_stream(tmp_path, world):
    from stemseg_tpu_torch.training.main import Trainer

    over = copy.deepcopy(TRAIN_SMALL)
    over["training"].update(max_iterations=7, batch_size=2 * world)
    cfg_path = str(tmp_path / "cfg.yaml")
    save_config(load_config(over), cfg_path)
    trainer = Trainer(load_config(cfg_path), str(tmp_path / "run"),
                      trainer_args(tmp_path / "run", cfg_path))
    assert trainer.world == 1
    per_chip = trainer.samples_per_step
    for rank in range(world):
        trainer.rank, trainer.world = rank, world
        trainer.accumulate_steps = max(1, round(2 * world / (world * per_chip)))
        sampler = trainer.make_loader(0).batch_sampler
        n = 7 * trainer.accumulate_steps * world * per_chip
        want = list(JaxIterSampler(JaxBatchSampler(JaxShardedSampler(n, 1, 0), world * per_chip),
                                   num_iterations=7 * trainer.accumulate_steps, start_iter=0))
        assert list(sampler) == [b[rank * per_chip:(rank + 1) * per_chip] for b in want]
        assert len(sampler) == len(want) == 14


def launch_cli(model_dir, cfg_path, port):
    cmd = [sys.executable, "-u", "-m", "stemseg_tpu_torch.training.main", "--model_dir",
           str(model_dir), "--cfg", cfg_path, "--device", "cpu", "--display_interval", "1",
           "--summary_interval", "1", "--save_interval", "100", "--num_cpu_workers", "0"]
    return [subprocess.Popen(cmd, env=rank_env(r, 2, port), cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(2)]


def finish(procs):
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_sigint_to_one_rank_stops_both_and_resumes(tmp_path):
    over = copy.deepcopy(TRAIN_SMALL)
    over["training"].update(max_iterations=10, batch_size=2)  # 2 ranks: no accumulation
    cfg_path = str(tmp_path / "cfg.yaml")
    save_config(load_config(over), cfg_path)
    run = tmp_path / "run"

    procs = launch_cli(run, cfg_path, free_port())
    head, deadline = [], time.monotonic() + RANK_TIMEOUT
    for line in procs[0].stdout:
        head.append(line)
        if line.startswith("it 2/10"):
            procs[1].send_signal(signal.SIGINT)
            break
        assert time.monotonic() < deadline, "".join(head)
    out0, out1 = finish(procs)
    out0 = "".join(head) + out0
    assert [p.returncode for p in procs] == [0, 0], out0 + out1
    assert "Interrupt signal received" in out0 and "Interrupt signal received" in out1
    saved = [line.split(": ", 1)[1] for line in out0.splitlines()
             if line.startswith("Checkpoint saved to")]
    assert len(saved) == 1 and "Checkpoint saved" not in out1
    ckpts = sorted(f for f in os.listdir(run) if f.endswith(".pth"))
    assert [os.path.join(run, ckpts[0])] == saved
    stopped = int(ckpts[0][:6])
    assert 2 <= stopped < 10

    procs = launch_cli(run, cfg_path, free_port())
    outs = finish(procs)
    assert [p.returncode for p in procs] == [0, 0], "".join(outs)
    for out in outs:
        assert f"Restoring session from {saved[0]}" in out
        assert f"Commencing/resuming training from iteration {stopped + 1}" in out
    assert "Training complete" in outs[0]
    assert sorted(f for f in os.listdir(run) if f.endswith(".pth"))[-1] == "000010.pth"
    with open(run / "logs" / "metrics.jsonl") as fh:
        steps = [json.loads(line)["step"] for line in fh]
    assert steps == list(range(1, 11))
