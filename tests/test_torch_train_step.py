"""The port's train step against the JAX package's, DAVIS-shaped (``xyff``,
separate seediness head, no semseg head), R-50-FPN at narrow widths, 2
frames of 64x96, on the same weights (``state_dict_from_jax``) and
batches:

* ``prepare_targets`` exactly equal;
* one micro-step: loss terms within 2e-4, every trainable parameter's
  gradient within a per-leaf relative L2 of 2e-3 (the JAX suite's
  gradient tolerance against the reference), ``grad_norm`` per micro-step;
* three optimizer steps of two accumulated micro-steps each (``batch_size``
  2): the parameter deltas against JAX's ``optax.MultiSteps`` within 2e-3
  per leaf, for SGD (with a step LR decay inside the run) and for Adam with
  clipping; frozen stem and ``layer1`` bit-unchanged;
* ``freeze_backbone`` and the LR schedules against the JAX package's.

The JAX side compiles one value-and-grad of the step for this file."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from stemseg_tpu.config import load_config as jax_load_config
from stemseg_tpu.models import build_model as jax_build_model
from stemseg_tpu.training.optim import make_lr_schedule as jax_make_lr_schedule
from stemseg_tpu.training.optim import make_optimizer as jax_make_optimizer
from stemseg_tpu.training.optim import param_freeze_labels
from stemseg_tpu.training.step import make_loss_fn
from stemseg_tpu.training.step import prepare_targets as jax_prepare_targets
from stemseg_tpu_torch.config import load_config
from stemseg_tpu_torch.models import build_model, state_dict_from_jax
from stemseg_tpu_torch.training.optim import make_optimizer, trainable_parameters
from stemseg_tpu_torch.training.step import TrainStep, make_output_loss_fn, prepare_targets
from test_torch_model import SMALL, random_variables

torch.set_num_threads(2)

LOSS_RTOL = 2e-4
GRAD_REL_L2 = 2e-3
T, H, W = 2, 64, 96

DAVIS_SMALL = copy.deepcopy(SMALL)
DAVIS_SMALL["input"].update(num_frames=T, min_dim=H, max_dim=W)
DAVIS_SMALL["training"].update(batch_size=2, max_samples_per_chip=1, optimizer="SGD",
                               initial_lr=0.01, lr_decay_type="step",
                               lr_decay_steps=[2], lr_decay_factor=0.1,
                               weight_decay=1e-4)
ADAM_CLIP = {"training": {"optimizer": "Adam", "initial_lr": 1e-3, "clip_gradients": True}}


def rel_l2(got, want):
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


def make_batch(seed, n_inst=2, i_max=3, cats=None):
    """One micro-batch (N = 1) in the host contract: images [1, T, H, W, 3]
    float32, uint8 masks with a padded instance row, an ignore stripe."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W]
    images = rng.randn(1, T, H, W, 3) * 40 + (xx / W * 60 + yy / H * 30)[None, None, :, :, None]
    masks = np.zeros((1, i_max, T, H, W), np.uint8)
    for k in range(n_inst):
        y0, x0 = rng.randint(2, H - 26), rng.randint(2, W - 34)
        for t in range(T):
            masks[0, k, t, y0 + 2 * t:y0 + 2 * t + 22, x0 + 3 * t:x0 + 3 * t + 28] = 1
    ignore = np.zeros((1, T, H, W), np.uint8)
    ignore[..., -8:] = 1
    category_ids = np.zeros((1, i_max), np.int32)
    category_ids[0, :n_inst] = 1 if cats is None else cats
    return {"images": images.astype(np.float32), "masks": masks, "ignore_masks": ignore,
            "category_ids": category_ids}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


class Setup:
    def __init__(self, over, variables_seed=1):
        self.over = over
        self.jcfg = jax_load_config(over)
        self.jmodel = jax_build_model(self.jcfg, for_training=True)
        self.variables = random_variables(self.jmodel, (1, T, H, W, 3), variables_seed)
        self.grad_fn = jax.jit(jax.value_and_grad(make_loss_fn(self.jmodel, self.jcfg),
                                                  has_aux=True))

    def jax_step(self, params, batch):
        (_, metrics), grads = self.grad_fn(params, self.variables["constants"], batch)
        return {k: float(v) for k, v in metrics.items()}, grads

    def torch_model(self, extra=None):
        cfg = load_config(self.over if extra is None else
                          jax_to_torch_over(self.over, extra))
        model = build_model(cfg, device="cpu", for_training=True)
        model.load_state_dict(state_dict_from_jax(self.variables))
        return cfg, model


def jax_to_torch_over(over, extra):
    merged = copy.deepcopy(over)
    for k, v in extra.items():
        merged.setdefault(k, {}).update(v)
    return merged


def jax_param_sd(tree):
    """A JAX params-shaped tree (gradients, updates) in the port's keys."""
    return {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": jax.tree.map(np.asarray, tree)}).items()}


@pytest.fixture(scope="module")
def davis():
    return Setup(DAVIS_SMALL)


def test_prepare_targets_exactly_equal():
    rng = np.random.RandomState(5)
    masks = np.zeros((2, 3, T, H, W), np.float32)
    for n in range(2):
        for k in range(3):
            y0, x0 = rng.randint(0, H - 20), rng.randint(0, W - 20)
            masks[n, k, :, y0:y0 + rng.randint(3, 20), x0:x0 + rng.randint(3, 20)] = 1.0
    masks[0, 2] = (rng.rand(T, H, W) > 0.3).astype(np.float32)  # ragged
    ignore = (rng.rand(2, T, H, W) > 0.2).astype(np.float32)
    cats = np.array([[1, 3, 2], [2, 0, 5]], np.int32)

    want = jax_prepare_targets(jnp.asarray(masks), jnp.asarray(ignore), jnp.asarray(cats))
    got = prepare_targets(torch.from_numpy(masks), torch.from_numpy(ignore),
                          torch.from_numpy(cats))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert 0 < got[0].sum() < masks.sum() / 16  # truncation removed the edges


def check_gradients(model, jgrads, params_named):
    """Every trainable gradient within GRAD_REL_L2 of JAX's; JAX's frozen
    gradients are zero; the port's trainable set is JAX's."""
    want = jax_param_sd(jgrads)
    trainable = {name for name, p in params_named if p.requires_grad}
    frozen = set(want) - trainable
    assert frozen and all(not want[k].any() for k in frozen)
    assert all(k.startswith(("backbone.body.stem.", "backbone.body.layer1.")) for k in frozen)
    worst = max((rel_l2(p.grad.numpy(), want[name]), name) for name, p in params_named
                if p.requires_grad)
    assert worst[0] <= GRAD_REL_L2, worst
    return worst


def test_one_micro_step_matches_jax(davis):
    batch = make_batch(0)
    jmetrics, jgrads = davis.jax_step(davis.variables["params"], batch)

    cfg, model = davis.torch_model()
    opt, sched = make_optimizer(cfg.training, trainable_parameters(model))
    step = TrainStep(model, cfg, opt, sched, accumulate_steps=2)  # no update yet
    metrics = step(torch_batch(batch))

    assert set(metrics) == set(jmetrics) | {"grad_norm"}
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    check_gradients(model, jgrads, list(model.named_parameters()))
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(jgrads)),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("optimizer", ["sgd", "adam_clip"])
def test_three_accumulated_steps_match_multisteps(davis, optimizer):
    extra = ADAM_CLIP if optimizer == "adam_clip" else {}
    batches = [make_batch(10 + k, n_inst=1 + k % 2) for k in range(6)]

    jcfg = jax_load_config(jax_to_torch_over(DAVIS_SMALL, extra))
    params0 = davis.variables["params"]
    tx = optax.MultiSteps(jax_make_optimizer(jcfg.training, params0, freeze_at_stage=2),
                          every_k_schedule=2)
    opt_state = tx.init(params0)
    update = jax.jit(lambda g, s, p: (lambda u, s2: (optax.apply_updates(p, u), s2))(
        *tx.update(g, s, p)))
    params, jnorms = params0, []
    for b in batches:
        _, grads = davis.jax_step(params, b)
        jnorms.append(float(optax.global_norm(grads)))
        params, opt_state = update(grads, opt_state, params)
    want = jax_param_sd(jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                                     params, params0))

    cfg, model = davis.torch_model(extra)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt, sched = make_optimizer(cfg.training, trainable_parameters(model))
    step = TrainStep(model, cfg, opt, sched, accumulate_steps=2)
    norms = [float(step(torch_batch(b))["grad_norm"]) for b in batches]
    assert step.micro_step == 0 and sched.last_epoch == 3

    np.testing.assert_allclose(norms, jnorms, rtol=LOSS_RTOL)
    after = model.state_dict()
    worst = (0.0, "")
    for name, p in model.named_parameters():
        delta = (after[name] - before[name]).numpy()
        if not p.requires_grad:
            assert torch.equal(after[name], before[name]), name
            assert not want[name].any(), name
            continue
        assert delta.any(), name
        worst = max(worst, (rel_l2(delta, want[name]), name))
    assert worst[0] <= GRAD_REL_L2, worst
    # buffers (FrozenBN statistics, time_scale) never move
    for name, buf in model.named_buffers():
        assert torch.equal(after[name], before[name]), name


def test_freeze_backbone_freezes_body_and_fpn(davis):
    over = jax_to_torch_over(DAVIS_SMALL, {"training": {"freeze_backbone": True}})
    model = build_model(load_config(over), device="cpu", for_training=True)
    labels = param_freeze_labels(davis.variables["params"], freeze_at_stage=2,
                                 freeze_backbone=True)
    shapes = jax.tree.map(lambda v: np.zeros(np.shape(v), np.float32),
                          davis.variables["params"])
    frozen_keys = set(state_dict_from_jax({"params": jax.tree.map(
        lambda lab, z: z, labels, shapes, is_leaf=lambda x: isinstance(x, str))}))
    frozen_keys = {k for k, lab in zip(
        jax_param_sd(shapes), jax.tree.leaves(labels)) if lab == "frozen"} or frozen_keys
    port_frozen = {n for n, p in model.named_parameters() if not p.requires_grad}
    assert port_frozen == {n for n, _ in model.named_parameters()
                           if n.startswith("backbone.")}
    assert port_frozen == frozen_keys
    # the forward keeps no graph through the backbone
    out = model(torch.zeros(1, T, 3, H, W))
    assert out["embeddings"].requires_grad
    assert not model.clip_features(torch.zeros(1, T, 3, H, W))[0].requires_grad


@pytest.mark.parametrize("kind,over", [
    ("step", {"lr_decay_steps": [3, 5], "lr_decay_factor": 0.1}),
    ("exponential", {"lr_exp_decay_factor": 0.1, "lr_exp_decay_start": 2,
                     "lr_exp_decay_steps": 3}),
    ("none", {}),
])
def test_lr_schedule_matches_jax_at_the_boundaries(kind, over):
    tover = {"training": {"initial_lr": 0.1, "lr_decay_type": kind, **over}}
    jsched = jax_make_lr_schedule(jax_load_config(tover).training)
    p = torch.nn.Parameter(torch.zeros(1))
    opt, sched = make_optimizer(load_config(tover).training, [p])
    for count in range(8):  # optimizer steps taken before this one
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(jsched(count)),
                                   rtol=1e-6, err_msg=f"{kind} at {count}")
        opt.step()
        sched.step()


def test_loss_at_full_res_and_remat():
    """``loss_at_full_res`` upscales both outputs 4x (targets stay full
    size); ``remat`` recomputes the body in the backward with equal
    gradients."""
    over = jax_to_torch_over(DAVIS_SMALL, {"training": {"loss_at_full_res": True}})
    cfg = load_config(over)
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = build_model(cfg, device="cpu", for_training=True, remat=remat)
        torch.manual_seed(0)
        for p in model.parameters():
            p.data.uniform_(-0.05, 0.05)
        batch = torch_batch(make_batch(3))
        out = model(batch["images"].permute(0, 1, 4, 2, 3))
        assert out["embeddings"].shape == (1, 7, T, H, W)
        total, _ = make_output_loss_fn(cfg)(out, batch)
        assert torch.isfinite(total)
        grads.append(torch.autograd.grad(total, trainable_parameters(model)))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
