"""Mixed-precision training (``training.mixed_precision``: bfloat16 compute,
float32 parameters) against the JAX package's step built from the same
config (``build_model`` maps the key to bf16 there too), DAVIS-shaped,
narrow R-50-FPN, 2 frames of 64x96, the same weights and batches as
``test_torch_train_step.py``:

* one micro-step: each loss term within LOSS_RTOL of JAX's, the whole
  gradient (every trainable tensor, concatenated) within GRAD_REL_L2 and
  each tensor's within LEAF_REL_L2; the model computes in bf16, its
  parameters and their gradients are float32;
* three optimizer steps of two accumulated micro-steps (SGD with a step LR
  decay inside the run): the parameter deltas against JAX's
  ``optax.MultiSteps`` within GRAD_REL_L2 as a whole and LEAF_REL_L2 per
  tensor, the frozen stem and ``layer1`` bit-unchanged, the optimizer
  state float32;
* the ``Trainer`` in bf16: 4 steps straight equal 2 + SIGINT + resume + 2
  bitwise (weights, momentum buffers), the checkpoint float32.

bf16 is not bit-equal across the two backends (XLA rounds once per fused
chain, PyTorch once per op); the bounds stand beside what was measured.
"""

import copy
import os
import signal

import jax
import numpy as np
import optax
import pytest
import torch

from stemseg_tpu.config import load_config as jax_load_config
from stemseg_tpu.training.optim import make_optimizer as jax_make_optimizer
from stemseg_tpu_torch.training.optim import make_optimizer, trainable_parameters
from stemseg_tpu_torch.training.step import TrainStep
from test_torch_train_step import (
    DAVIS_SMALL,
    Setup,
    jax_param_sd,
    make_batch,
    rel_l2,
    torch_batch,
)

torch.set_num_threads(2)

LOSS_RTOL = 1e-2  # measured: at most 1.5e-3 (the variance smoothness term)
GRAD_REL_L2 = 5e-2  # measured: 1.3e-2 (one micro-step's gradient), 1.5e-2 (3 steps' deltas)
LEAF_REL_L2 = 0.3  # per tensor; measured: at most 0.16 and 0.19

MIXED = copy.deepcopy(DAVIS_SMALL)
MIXED["training"]["mixed_precision"] = True


def whole_rel_l2(got, want, names):
    g = np.concatenate([np.ravel(got[n]) for n in names]).astype(np.float64)
    w = np.concatenate([np.ravel(want[n]) for n in names]).astype(np.float64)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


@pytest.fixture(scope="module")
def mixed():
    setup = Setup(MIXED)
    assert setup.jmodel.dtype == jax.numpy.bfloat16
    return setup


def test_one_mixed_precision_micro_step_matches_jax(mixed):
    batch = make_batch(0)
    jmetrics, jgrads = mixed.jax_step(mixed.variables["params"], batch)

    cfg, model = mixed.torch_model()
    assert model.compute_dtype == torch.bfloat16
    out = model(torch_batch(batch)["images"].permute(0, 1, 4, 2, 3))
    assert {v.dtype for v in out.values() if v is not None} == {torch.bfloat16}

    opt, sched = make_optimizer(cfg.training, trainable_parameters(model))
    step = TrainStep(model, cfg, opt, sched, accumulate_steps=2)  # no update yet
    metrics = step(torch_batch(batch))
    assert set(metrics) == set(jmetrics) | {"grad_norm"}
    for k, v in jmetrics.items():
        assert metrics[k].dtype == torch.float32, k
        np.testing.assert_allclose(float(metrics[k]), v, rtol=LOSS_RTOL, atol=1e-4, err_msg=k)

    want = jax_param_sd(jgrads)
    trainable = [n for n, p in model.named_parameters() if p.requires_grad]
    got = {n: p.grad.numpy() for n, p in model.named_parameters() if p.requires_grad}
    assert {p.grad.dtype for p in model.parameters() if p.requires_grad} == {torch.float32}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert whole_rel_l2(got, want, trainable) <= GRAD_REL_L2
    assert max(rel_l2(got[n], want[n]) for n in trainable) <= LEAF_REL_L2
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(jgrads)),
                               rtol=GRAD_REL_L2)


def test_three_accumulated_mixed_precision_steps_match_multisteps(mixed):
    batches = [make_batch(10 + k, n_inst=1 + k % 2) for k in range(6)]
    jcfg = jax_load_config(MIXED)
    params0 = mixed.variables["params"]
    tx = optax.MultiSteps(jax_make_optimizer(jcfg.training, params0, freeze_at_stage=2),
                          every_k_schedule=2)
    opt_state = tx.init(params0)
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))
    params = params0
    for b in batches:
        _, grads = mixed.jax_step(params, b)
        params, opt_state = update(grads, opt_state, params)
    want = jax_param_sd(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                     params, params0))

    cfg, model = mixed.torch_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched = make_optimizer(cfg.training, trainable_parameters(model))
    step = TrainStep(model, cfg, opt, sched, accumulate_steps=2)
    for b in batches:
        step(torch_batch(b))
    assert step.micro_step == 0 and sched.last_epoch == 3
    after = model.state_dict()
    trainable, got = [], {}
    for name, p in model.named_parameters():
        assert after[name].dtype == torch.float32, name
        if not p.requires_grad:
            assert torch.equal(after[name], before[name]), name
            continue
        trainable.append(name)
        got[name] = (after[name] - before[name]).numpy()
        assert got[name].any(), name
    assert whole_rel_l2(got, want, trainable) <= GRAD_REL_L2
    assert max(rel_l2(got[n], want[n]) for n in trainable) <= LEAF_REL_L2
    states = [s for s in opt.state_dict()["state"].values()]
    assert states and {v.dtype for s in states for v in s.values()
                       if torch.is_tensor(v)} == {torch.float32}


def test_mixed_precision_trainer_resume_is_bitwise(tmp_path, monkeypatch):
    from test_torch_trainer import TRAIN_SMALL, run_trainer, write_cfg

    from stemseg_tpu_torch.training.step import TrainStep as Step

    over = copy.deepcopy(TRAIN_SMALL)
    over["training"]["mixed_precision"] = True
    cfg_path = write_cfg(tmp_path, over)
    straight = run_trainer(tmp_path / "straight", cfg_path)
    assert straight.model.compute_dtype == torch.bfloat16

    calls = [0]
    call = Step.__call__

    def interrupt_after_two_updates(self, batch):
        out = call(self, batch)
        calls[0] += 1
        if calls[0] == 4:
            os.kill(os.getpid(), signal.SIGINT)
        return out

    monkeypatch.setattr(Step, "__call__", interrupt_after_two_updates)
    first = run_trainer(tmp_path / "resumed", cfg_path)
    monkeypatch.setattr(Step, "__call__", call)
    assert first.elapsed_iterations == 2
    resumed = run_trainer(tmp_path / "resumed", cfg_path)
    assert resumed.elapsed_iterations == 4
    a, b = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    oa, ob = straight.optimizer.state_dict(), resumed.optimizer.state_dict()
    assert all(torch.equal(oa["state"][i]["momentum_buffer"], ob["state"][i]["momentum_buffer"])
               for i in oa["state"])
    ckpt = torch.load(tmp_path / "resumed" / "000004.pth", weights_only=True)
    assert {v.dtype for v in ckpt["model"].values()} == {torch.float32}
    assert {v.dtype for s in ckpt["optimizer"]["state"].values() for v in s.values()} == \
        {torch.float32}
