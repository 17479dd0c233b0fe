"""One micro-step of the port's train step against the JAX package's,
YouTube-VIS-shaped: a semseg head with 4 + 1 logits (the cross entropy and
the fg BCE), the seediness fused into the embedding head, R-50-FPN at
narrow widths, 2 frames of 64x96, on the same weights and batch. Loss terms
within 2e-4; every trainable parameter's gradient within a per-leaf
relative L2 of 2e-3; ``grad_norm`` within 2e-4. The JAX side compiles one
value-and-grad of the step for this file."""

import copy

import optax
import pytest
import numpy as np
import torch

from stemseg_tpu_torch.training.optim import make_optimizer, trainable_parameters
from stemseg_tpu_torch.training.step import TrainStep
from test_torch_train_step import (
    DAVIS_SMALL,
    LOSS_RTOL,
    Setup,
    check_gradients,
    make_batch,
    torch_batch,
)

torch.set_num_threads(2)

YTVIS_SMALL = copy.deepcopy(DAVIS_SMALL)
YTVIS_SMALL["input"]["num_classes"] = 4
YTVIS_SMALL["model"].update(use_seediness_head=False, use_semseg_head=True,
                            semseg={"inter_channels": [32, 32, 24, 24], "gn_num_groups": 8})


@pytest.fixture(scope="module")
def ytvis():
    return Setup(YTVIS_SMALL, variables_seed=2)


def test_one_semseg_micro_step_matches_jax(ytvis):
    # three instances of classes 3, 1 and 2 over one padded row
    batch = make_batch(4, n_inst=3, i_max=4, cats=(3, 1, 2))
    jmetrics, jgrads = ytvis.jax_step(ytvis.variables["params"], batch)

    cfg, model = ytvis.torch_model()
    assert model.semseg_head is not None and model.seediness_head is None
    opt, sched = make_optimizer(cfg.training, trainable_parameters(model))
    metrics = TrainStep(model, cfg, opt, sched, accumulate_steps=2)(torch_batch(batch))

    assert {"semseg", "fg"} <= set(jmetrics)
    assert set(metrics) == set(jmetrics) | {"grad_norm"}
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    check_gradients(model, jgrads, list(model.named_parameters()))
    assert model.semseg_head.conv_out.weight.grad.abs().sum() > 0
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(jgrads)),
                               rtol=LOSS_RTOL)
