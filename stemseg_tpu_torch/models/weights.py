"""Weights for the port's model: from the JAX package's variable tree or its
``.ckpt`` file, from a reference ``.pth`` file, or random from a seed.

``state_dict_from_jax`` is the inverse of the JAX package's checkpoint
converter: conv kernels go from ``[(T,) H, W, I, O]`` to
``[O, I, (T,) H, W]``, GroupNorm ``scale`` becomes ``weight``, and the
``constants`` collection (FrozenBN statistics, the embedding head's
``time_scale``) becomes buffers. It works on numpy leaves and needs no JAX;
a JAX ``.ckpt`` is read by the port's own flax-msgpack reader
(``models/flax_msgpack.py``).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Mapping, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for name, child in tree.items():
        if isinstance(child, Mapping):
            yield from _leaves(child, path + (name,))
        else:
            yield path + (name,), child


def _jax_conv_to_torch(w: np.ndarray) -> np.ndarray:
    if w.ndim == 4:  # [H, W, I, O] -> [O, I, H, W]
        return np.transpose(w, (3, 2, 0, 1))
    if w.ndim == 5:  # [T, H, W, I, O] -> [O, I, T, H, W]
        return np.transpose(w, (4, 3, 0, 1, 2))
    raise ValueError(f"Unexpected conv kernel ndim {w.ndim}")


def _param_key(path: Tuple[str, ...]) -> str:
    """A ``params`` leaf path of the JAX tree -> the port's state-dict key."""
    leaf = "weight" if path[-1] in ("kernel", "scale") else path[-1]
    if path[0] == "body":
        if path[1] == "stem":
            return f"backbone.body.stem.{path[2]}.{leaf}"
        i, j = re.match(r"layer(\d+)_(\d+)$", path[1]).groups()
        mod = {"downsample_conv": "downsample.0"}.get(path[2], path[2])
        return f"backbone.body.layer{i}.{j}.{mod}.{leaf}"
    if path[0] == "fpn":
        return f"backbone.fpn.{path[1]}.{leaf}"
    head = path[0]
    if path[1] == "trunk":
        # a squeeze block's slot is (conv or atrous pyramid, norm, ReLU, pool)
        m = re.match(r"(block_\d+x)_(conv|norm|aspp)(\d)$", path[2])
        if m:
            block, kind, slot = m.group(1), m.group(2), int(m.group(3))
            key = f"{head}.{block}.{4 * slot + (kind == 'norm')}"
            if kind == "aspp":  # atrous_convs_<i> or conv_out (after its ReLU)
                sub = re.match(r"atrous_convs_(\d+)$", path[3])
                key += f".atrous_convs.{sub.group(1)}" if sub else ".conv_out.1"
            return f"{key}.{leaf}"
        return f"{head}.{path[2]}.{leaf}"
    return f"{head}.{path[1]}.{leaf}"


def _constant_key(path: Tuple[str, ...]) -> str:
    """A ``constants`` leaf path of the JAX tree -> the port's buffer key."""
    if path[0] == "body":
        if path[1] == "stem":
            return f"backbone.body.stem.{path[2]}.{path[3]}"
        i, j = re.match(r"layer(\d+)_(\d+)$", path[1]).groups()
        mod = {"downsample_bn": "downsample.1"}.get(path[2], path[2])
        return f"backbone.body.layer{i}.{j}.{mod}.{path[3]}"
    return ".".join(path)  # e.g. embedding_head.time_scale


def state_dict_from_jax(variables: Mapping[str, Mapping]) -> Dict[str, torch.Tensor]:
    """JAX ``{'params', 'constants'}`` tree (numpy leaves) -> the port's
    ``state_dict``. Raises ``ValueError`` if two leaves map to one key."""
    out: Dict[str, torch.Tensor] = {}

    def put(key, path, value):
        if key in out:
            raise ValueError(f"two leaves map to {key}, the second {'/'.join(path)}")
        out[key] = torch.from_numpy(np.array(value, np.float32))

    for path, value in _leaves(variables.get("params", {})):
        value = np.asarray(value, np.float32)
        if path[-1] == "kernel":
            value = _jax_conv_to_torch(value)
        put(_param_key(path), path, value)
    for path, value in _leaves(variables.get("constants", {})):
        put(_constant_key(path), path, value)
    return out


def read_jax_checkpoint(path: str) -> Dict[str, Mapping]:
    """The ``params`` and ``constants`` of a JAX package ``.ckpt``: a
    trainer's session (under ``"state"``, beside its optimizer state, which
    is not read) or a bare variable tree."""
    from stemseg_tpu_torch.models.flax_msgpack import read_msgpack_file

    payload = read_msgpack_file(path)
    state = payload["state"] if "state" in payload else payload
    return {"params": state["params"], "constants": state.get("constants", {})}


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Read weights into the port's key space: a JAX package ``.ckpt``
    (through ``state_dict_from_jax``), or a reference ``.pth`` (a state dict,
    or a training checkpoint with the state dict under ``'model'``), whose
    DDP ``module.`` prefixes are dropped, and so are loss-criterion buffers,
    which the config derives."""
    if path.endswith(".ckpt"):
        return state_dict_from_jax(read_jax_checkpoint(path))
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and isinstance(ckpt.get("model"), dict):
        ckpt = ckpt["model"]
    out = {}
    for key, value in ckpt.items():
        if not torch.is_tensor(value) or "loss_criterion" in key:
            continue
        out[key[len("module."):] if key.startswith("module.") else key] = value
    return out


def init_random_weights(model: nn.Module, seed: int) -> None:
    """Fill ``model`` in place with random weights drawn from a
    ``torch.Generator`` seeded with ``seed``, with the JAX package's init
    distributions: backbone and FPN convs kaiming-uniform with a=1 (bound
    ``sqrt(3 / fan_in)``) and zero FPN biases; head convs PyTorch's default
    (bound ``sqrt(1 / fan_in)``, biases ``U(±1/sqrt(fan_in))``). Norm layers
    keep their identity init."""
    gen = torch.Generator().manual_seed(seed)

    def uniform_(t: torch.Tensor, bound: float):
        t.copy_((torch.rand(t.shape, generator=gen) * 2.0 - 1.0) * bound)

    with torch.no_grad():
        for name, mod in model.named_modules():
            if not isinstance(mod, (nn.Conv2d, nn.Conv3d)):
                continue
            fan_in = mod.weight[0].numel()
            in_backbone = name.startswith("backbone.")
            uniform_(mod.weight, math.sqrt((3.0 if in_backbone else 1.0) / fan_in))
            if mod.bias is not None:
                if in_backbone:
                    mod.bias.zero_()
                else:
                    uniform_(mod.bias, 1.0 / math.sqrt(fan_in))
