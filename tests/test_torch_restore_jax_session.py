"""A session of the JAX package's trainer (its ``.ckpt``: weights, optax
state, step) restored into the port (``training/checkpoint.py`` ->
``training/optax_state.py``), DAVIS-shaped, R-50-FPN at narrow widths, 2
frames of 64x96:

* 2 JAX optimizer steps, the session saved by the JAX package's own
  ``save_checkpoint``, restored in the port, 2 more port steps: equal to 4
  JAX steps (parameter deltas within the suite's 2e-3 per leaf), for
  SGD-nesterov with accumulation 2 (the ``optax.MultiSteps`` layout) and for
  Adam with clipping and no accumulation (the bare ``multi_transform``
  layout), both with a step LR schedule whose boundary falls after the
  restore; the optimizer state and the schedule equal the JAX ones mapped;
* a session saved after 1 micro-step of an accumulation (``mini_step`` 1):
  the port drops the partial accumulation and resumes at the step boundary,
  equal to 4 straight JAX steps; the JAX package's own resume of it (its
  sampler re-feeds the boundary's micro-batches on top of ``acc_grads``)
  is not (ROADMAP §C);
* the trainer's ``--restore_session`` of a JAX session: step count, LR and
  the logger state carried over;
* ``chip_smoke.write_jax_session`` with a config writes the layout the JAX
  trainer writes (keys, shapes, dtypes), and its optimizer state restores
  to the port trainer's.
"""

import os
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from stemseg_tpu.config import load_config as jax_load_config
from stemseg_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from stemseg_tpu.training.optim import make_lr_schedule as jax_make_lr_schedule
from stemseg_tpu.training.optim import make_optimizer as jax_make_optimizer
from stemseg_tpu.training.step import TrainState
from stemseg_tpu_torch.config import load_config, save_config
from stemseg_tpu_torch.models import build_model, state_dict_from_jax
from stemseg_tpu_torch.models.flax_msgpack import read_msgpack_file
from stemseg_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
from stemseg_tpu_torch.training.optim import make_optimizer, trainable_parameters
from stemseg_tpu_torch.training.step import TrainStep
from test_torch_train_step import (
    ADAM_CLIP,
    DAVIS_SMALL,
    GRAD_REL_L2,
    Setup,
    jax_param_sd,
    jax_to_torch_over,
    make_batch,
    rel_l2,
    torch_batch,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULE = {"training": {"lr_decay_type": "step", "lr_decay_steps": [3],
                         "lr_decay_factor": 0.1}}
CASES = {"sgd_accumulate_2": ({}, 2), "adam_clip_accumulate_1": (ADAM_CLIP, 1)}


@pytest.fixture(scope="module")
def davis():
    return Setup(DAVIS_SMALL)


def over_for(extra, accumulate):
    over = jax_to_torch_over(jax_to_torch_over(DAVIS_SMALL, SCHEDULE), extra)
    over["training"].update(batch_size=accumulate, max_samples_per_chip=1)
    return over


class JaxRun:
    """The JAX trainer's optimizer on ``over``: ``optax.MultiSteps`` when it
    accumulates, as ``create_train_state`` builds it."""

    def __init__(self, davis, over, accumulate):
        self.davis = davis
        self.params0 = davis.variables["params"]
        tx = jax_make_optimizer(jax_load_config(over).training, self.params0, freeze_at_stage=2)
        self.tx = optax.MultiSteps(tx, every_k_schedule=accumulate) if accumulate > 1 else tx
        self.update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
            *self.tx.update(g, s, p)))

    def start(self):
        return self.params0, self.tx.init(self.params0)

    def feed(self, params, opt_state, batches):
        for b in batches:
            _, grads = self.davis.jax_step(params, b)
            params, opt_state = self.update(grads, opt_state, params)
        return params, opt_state

    def deltas(self, params):
        return jax_param_sd(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                         params, self.params0))

    def save(self, model_dir, params, opt_state, micro_steps, step):
        state = TrainState(step=np.asarray(micro_steps, np.int32), params=params,
                           constants=self.davis.variables["constants"], opt_state=opt_state)
        return jax_save_checkpoint(str(model_dir), step, state,
                                   extra={"logger": {"elapsed": 12.5}})


def port_restored(davis, over, path):
    cfg = load_config(over)
    model = build_model(cfg, device="cpu", for_training=True)
    opt, sched = make_optimizer(cfg.training, trainable_parameters(model))
    extra, step = restore_checkpoint(path, model, opt, sched)
    return cfg, model, opt, sched, extra, step


def port_deltas(davis, model):
    start = state_dict_from_jax(davis.variables)
    return {n: (p.detach() - start[n]).numpy() for n, p in model.named_parameters()}


def check_deltas(got, want, model):
    worst = (0.0, "")
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert not got[name].any() and not want[name].any(), name
            continue
        worst = max(worst, (rel_l2(got[name], want[name]), name))
    assert worst[0] <= GRAD_REL_L2, worst
    return worst


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_jax_steps_restored_plus_two_equal_four_jax_steps(davis, tmp_path, case):
    extra, accumulate = CASES[case]
    over = over_for(extra, accumulate)
    batches = [make_batch(20 + k, n_inst=1 + k % 3) for k in range(4 * accumulate)]
    run = JaxRun(davis, over, accumulate)
    params, opt_state = run.feed(*run.start(), batches[:2 * accumulate])
    path = run.save(tmp_path, params, opt_state, 2 * accumulate, 2)
    params4, _ = run.feed(params, opt_state, batches[2 * accumulate:])

    layout = read_msgpack_file(path)["state"]["opt_state"]
    assert ("inner_opt_state" in layout) == (accumulate > 1)

    cfg, model, opt, sched, extra_state, step = port_restored(davis, over, path)
    assert step == 2 and extra_state == {"logger": {"elapsed": 12.5}}
    assert sched.last_epoch == 2
    jsched = jax_make_lr_schedule(jax_load_config(over).training)
    np.testing.assert_allclose(opt.param_groups[0]["lr"], float(jsched(2)), rtol=1e-7)
    # the restored moments are the JAX ones, mapped
    chain = (layout["inner_opt_state"] if accumulate > 1 else layout)[
        "inner_states"]["trainable"]["inner_state"]
    names = {p: n for n, p in model.named_parameters()}
    if accumulate > 1:
        want = state_dict_from_jax({"params": chain["1"]["trace"]})
        slot = "momentum_buffer"
    else:
        want = state_dict_from_jax({"params": chain["1"]["1"]["mu"]})
        slot = "exp_avg"
        assert all(float(s["step"]) == 2 for s in opt.state.values())
    assert len(opt.state) == len(trainable_parameters(model))
    for p, s in opt.state.items():
        assert torch.equal(s[slot], want[names[p]]), names[p]

    train = TrainStep(model, cfg, opt, sched, accumulate_steps=accumulate)
    for b in batches[2 * accumulate:]:
        train(torch_batch(b))
    assert sched.last_epoch == 4
    np.testing.assert_allclose(opt.param_groups[0]["lr"], float(jsched(4)), rtol=1e-7)
    check_deltas(port_deltas(davis, model), run.deltas(params4), model)


def test_mid_accumulation_session_resumes_at_the_step_boundary(davis, tmp_path, capsys):
    over = over_for({}, 2)
    batches = [make_batch(40 + k, n_inst=1 + k % 3) for k in range(8)]
    run = JaxRun(davis, over, 2)
    params, opt_state = run.feed(*run.start(), batches[:4])
    straight, _ = run.feed(params, opt_state, batches[4:])
    # the JAX trainer's exception path saves after micro-step 5: step 2, mini_step 1
    params_mid, opt_mid = run.feed(params, opt_state, batches[4:5])
    path = run.save(tmp_path, params_mid, opt_mid, 5, 2)
    assert int(read_msgpack_file(path)["state"]["opt_state"]["mini_step"]) == 1

    cfg, model, opt, sched, _, step = port_restored(davis, over, path)
    assert step == 2 and "accumulation starts afresh" in capsys.readouterr().out
    train = TrainStep(model, cfg, opt, sched, accumulate_steps=2)
    for b in batches[4:]:  # the sampler resumes at micro-step step * 2 = 4
        train(torch_batch(b))
    check_deltas(port_deltas(davis, model), run.deltas(straight), model)

    # the JAX trainer feeds micro-steps 4.. again on top of acc_grads: its
    # accumulation counts micro-step 4 twice, and its 4 steps end elsewhere
    jax_resumed, _ = run.feed(params_mid, opt_mid, batches[4:7])
    got, want = run.deltas(jax_resumed), run.deltas(straight)
    assert max(rel_l2(got[n], want[n]) for n, p in model.named_parameters()
               if p.requires_grad) > GRAD_REL_L2


def test_trainer_restores_a_jax_session(davis, tmp_path):
    from stemseg_tpu_torch.training.main import Trainer
    from test_torch_trainer import trainer_args

    over = over_for({}, 2)
    run = JaxRun(davis, over, 2)
    params, opt_state = run.feed(*run.start(), [make_batch(60 + k) for k in range(4)])
    path = run.save(tmp_path / "jax", params, opt_state, 4, 2)
    cfg_path = str(tmp_path / "cfg.yaml")
    save_config(load_config(over), cfg_path)
    trainer = Trainer(load_config(cfg_path), str(tmp_path / "run"),
                      trainer_args(tmp_path / "run", cfg_path, "--restore_session", path))
    assert trainer.elapsed_iterations == 2 and trainer.scheduler.last_epoch == 2
    assert trainer.logger._elapsed_before_start == 12.5
    want = state_dict_from_jax(davis.variables | {"params": jax.tree.map(np.asarray, params)})
    got = trainer.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def structure(tree):
    """Keys, and (shape, dtype) at the leaves."""
    if isinstance(tree, dict):
        return {k: structure(v) for k, v in tree.items()}
    a = np.asarray(tree)
    return (a.shape, a.dtype.name)


def test_chip_smoke_session_has_the_jax_layout_and_restores(davis, tmp_path):
    sys.path.insert(0, REPO)
    import chip_smoke

    over = over_for({}, 2)
    cfg = load_config(over)
    # a port session after 2 steps
    model = build_model(cfg, device="cpu", for_training=True)
    model.load_state_dict(state_dict_from_jax(davis.variables))
    opt, sched = make_optimizer(cfg.training, trainable_parameters(model))
    train = TrainStep(model, cfg, opt, sched, accumulate_steps=2)
    for k in range(4):
        train(torch_batch(make_batch(80 + k)))
    pth = save_checkpoint(str(tmp_path), 2, model, opt, sched, extra={"logger": {"elapsed": 3.0}})
    ckpt = str(tmp_path / "s.ckpt")
    chip_smoke.write_jax_session(pth, 2, ckpt, cfg=cfg)

    run = JaxRun(davis, over, 2)
    params, opt_state = run.feed(*run.start(), [make_batch(80 + k) for k in range(4)])
    jax_path = run.save(tmp_path / "jax", params, opt_state, 4, 2)
    ours, theirs = read_msgpack_file(ckpt), read_msgpack_file(jax_path)
    assert structure(ours["state"]) == structure(theirs["state"])
    assert ours["step"] == theirs["step"] == 2

    cfg2, model2, opt2, sched2, _, step = port_restored(davis, over, ckpt)
    assert step == 2 and sched2.state_dict() == sched.state_dict()
    a, b = model.state_dict(), model2.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = opt.state_dict(), opt2.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert all(torch.equal(sa["state"][i]["momentum_buffer"], sb["state"][i]["momentum_buffer"])
               for i in sa["state"])


def test_a_weights_only_ckpt_is_no_session(tmp_path):
    import flax.serialization

    cfg = load_config(over_for({}, 1))
    model = build_model(cfg, device="cpu", for_training=True)
    opt, sched = make_optimizer(cfg.training, trainable_parameters(model))
    path = tmp_path / "w.ckpt"
    path.write_bytes(flax.serialization.msgpack_serialize({"params": {}, "constants": {}}))
    with pytest.raises(ValueError, match="w.ckpt: not a JAX trainer's session"):
        restore_checkpoint(str(path), model, opt, sched)
