"""A session of the JAX package's trainer (its ``.ckpt``) restored into the
port's model, ``torch.optim`` optimizer and ``LambdaLR`` schedule.

The JAX trainer saves ``{"state": {"step", "params", "constants",
"opt_state"}, "extra", "step"}`` with flax's msgpack serialisation
(``stemseg_tpu/training/checkpoint.py``); the port reads it with its own
``models/flax_msgpack.py``. flax writes optax's named tuples as dicts of
their fields and tuples as dicts keyed ``"0"``, ``"1"``, ... So
``opt_state`` is

* ``optax.MultiSteps`` when the JAX trainer accumulated (``accumulate_steps
  > 1``): ``{"mini_step", "gradient_step", "inner_opt_state", "acc_grads",
  "skip_state"}``, with the ``multi_transform`` state below under
  ``inner_opt_state``; or that state bare;
* ``multi_transform``: ``{"inner_states": {"trainable": {"inner_state":
  chain}, "frozen": {"inner_state": {}}}}``;
* the chain (``stemseg_tpu/training/optim.py``): ``{"0": {}`` (decayed
  weights), ``"1":`` the moments, ``"2": {"count"}`` (the LR schedule's
  count)``}``, or, with ``training.clip_gradients``, ``{"0": {}`` (the
  clipping), ``"1":`` that chain``}``;
* the moments: SGD's ``{"trace": params tree}`` or Adam's ``{"count", "mu",
  "nu"}``, each tree shaped as the params, a frozen leaf an empty dict.

They map onto the port's state as ``trace`` -> ``momentum_buffer``, and
``count`` / ``mu`` / ``nu`` -> ``step`` / ``exp_avg`` / ``exp_avg_sq``,
each leaf through ``state_dict_from_jax`` (conv kernels transposed); the
schedule's count becomes ``last_epoch`` and each group's ``lr`` its
``lr(count)``.

A session saved in the middle of an accumulation (``mini_step > 0``: the
JAX trainer's exception path saves one) holds the micro-steps' gradients so
far in ``acc_grads``. The JAX trainer resumes its sampler at the step
boundary and feeds those micro-batches again on top of them; the port
starts the accumulation afresh at the boundary (ROADMAP §C).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from stemseg_tpu_torch.models.weights import state_dict_from_jax


def _chain(opt_state: Mapping, path: str) -> Tuple[Mapping, int]:
    """(the chain's state, the MultiSteps ``mini_step`` or 0)."""
    mini_step = 0
    if "inner_opt_state" in opt_state:  # optax.MultiSteps
        mini_step = int(opt_state["mini_step"])
        opt_state = opt_state["inner_opt_state"]
    try:
        chain = opt_state["inner_states"]["trainable"]["inner_state"]
    except (KeyError, TypeError) as e:
        raise ValueError(f"{path}: no multi_transform state with a 'trainable' "
                         "branch in opt_state") from e
    if isinstance(chain.get("1"), Mapping) and set(chain["1"]) == {"0", "1", "2"}:
        chain = chain["1"]  # led by clip_by_global_norm's empty state
    if set(chain) != {"0", "1", "2"}:
        raise ValueError(f"{path}: the trainable chain has keys {sorted(chain)}, "
                         "expected decayed weights, moments and schedule")
    return chain, mini_step


def _named_leaves(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A params-shaped tree of the optimizer state -> the port's keys."""
    return state_dict_from_jax({"params": tree})


def set_schedule_step(scheduler, count: int) -> None:
    """``LambdaLR`` after ``count`` steps: ``last_epoch`` and each group's
    ``lr`` at ``lr(count)``, as ``count`` calls of ``step()`` leave it."""
    scheduler.last_epoch = count
    scheduler._step_count = count + 1  # the constructor's call, then count
    for group, base, factor in zip(scheduler.optimizer.param_groups, scheduler.base_lrs,
                                   scheduler.lr_lambdas):
        group["lr"] = base * factor(count)
    scheduler._last_lr = [g["lr"] for g in scheduler.optimizer.param_groups]


def restore_jax_session(payload: Mapping[str, Any], path: str, model, optimizer,
                        scheduler) -> Tuple[Dict[str, Any], int]:
    """Loads a JAX trainer's session (the tree ``read_msgpack_file``
    returns) into ``model``, ``optimizer`` and ``scheduler`` in place.
    Raises ``ValueError`` naming ``path`` for a tree that is no session or
    whose optimizer is not the port's. :return: (extra, step)"""
    state = payload.get("state") if isinstance(payload, Mapping) else None
    if not isinstance(state, Mapping) or "opt_state" not in state or "step" not in payload:
        raise ValueError(f"{path}: not a JAX trainer's session (no state/opt_state); "
                         "pass weights alone as --initial_ckpt")
    chain, mini_step = _chain(state["opt_state"], path)
    moments, count = chain["1"], int(chain["2"]["count"])

    device = next(model.parameters()).device
    model.load_state_dict(state_dict_from_jax({"params": state["params"],
                                               "constants": state.get("constants", {})}))
    names = {p: name for name, p in model.named_parameters()}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    kind = type(optimizer).__name__
    if kind == "SGD" and "trace" in moments:
        slots = {"momentum_buffer": _named_leaves(moments["trace"])}
        extra_state = {}
    elif kind == "Adam" and {"count", "mu", "nu"} <= set(moments):
        slots = {"exp_avg": _named_leaves(moments["mu"]),
                 "exp_avg_sq": _named_leaves(moments["nu"])}
        extra_state = {"step": float(moments["count"])}
    else:
        raise ValueError(f"{path}: optimizer state with keys {sorted(moments)} does not "
                         f"fit the config's {kind}")
    optimizer.state.clear()
    for p in params:
        name = names[p]
        missing = [slot for slot, leaves in slots.items() if name not in leaves]
        if missing:
            raise ValueError(f"{path}: no {missing[0]} for the trainable {name}")
        optimizer.state[p] = {slot: leaves[name].to(device).reshape(p.shape)
                              for slot, leaves in slots.items()}
        for key, value in extra_state.items():
            optimizer.state[p][key] = torch.tensor(value, dtype=torch.float32)
    set_schedule_step(scheduler, count)
    if mini_step:
        print(f"{path}: saved after {mini_step} micro-steps of an accumulation; "
              "their gradients are dropped and the accumulation starts afresh")
    return dict(payload.get("extra") or {}), int(payload["step"])
