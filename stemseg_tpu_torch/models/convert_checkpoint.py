"""CLI: a JAX package ``.ckpt`` to a ``.pth`` that the port reads.

    python -m stemseg_tpu_torch.models.convert_checkpoint in.ckpt out.pth [--cfg davis_2]

The input is a weights-only ``.ckpt`` (what
``python -m stemseg_tpu.models.convert_checkpoint`` writes) or a JAX
trainer's session ``.ckpt`` (its optimizer state is not read), parsed by the
port's own flax-msgpack reader. The output holds ``{"model": state_dict}``
under the reference's key names, which the inference CLI and the trainer's
``--initial_ckpt`` load as they are. ``--cfg`` is a preset name or a YAML
path; without it the ``config.yaml`` beside the checkpoint, else the
defaults. The model of that config is built on the ``meta`` device (no
memory, no compute) to hold the tree against: a key of the model that no
leaf fills, a leaf that maps to no key (or to a key another leaf fills),
or a shape that differs is refused.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Tuple

import torch

from stemseg_tpu_torch.config import Config, load_config, load_preset


def resolve_cfg(cfg_arg, ckpt_path: str) -> Config:
    """A preset name or a YAML path; else ``config.yaml`` beside the
    checkpoint; else the defaults."""
    if cfg_arg and os.path.exists(cfg_arg):
        return load_config(cfg_arg)
    if cfg_arg:
        return load_preset(cfg_arg)
    sidecar = os.path.join(os.path.dirname(os.path.abspath(ckpt_path)), "config.yaml")
    return load_config(sidecar) if os.path.exists(sidecar) else Config()


def convert(ckpt_path: str, cfg: Config) -> Tuple[Dict[str, torch.Tensor], int]:
    """The state dict of a JAX ``.ckpt``, in the key order of ``cfg``'s
    model, and the model's parameter count. Raises ``ValueError`` unless the
    tree fills every key of the model, each with exactly one leaf of its
    shape."""
    from stemseg_tpu_torch.models.builder import STEmSegModel
    from stemseg_tpu_torch.models.weights import read_jax_checkpoint, state_dict_from_jax

    sd = state_dict_from_jax(read_jax_checkpoint(ckpt_path))  # raises if two leaves share a key
    with torch.device("meta"):
        model = STEmSegModel(cfg)
    want = model.state_dict()
    missing = sorted(want.keys() - sd.keys())
    extra = sorted(sd.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"{ckpt_path}: the model's keys left unfilled {missing[:8]} "
                         f"({len(missing)}), leaves left over {extra[:8]} ({len(extra)})")
    wrong = [(k, tuple(sd[k].shape), tuple(v.shape)) for k, v in want.items()
             if sd[k].shape != v.shape]
    if wrong:
        raise ValueError(f"{ckpt_path}: shapes differ from the model's (key, leaf, model): "
                         f"{wrong[:8]} ({len(wrong)})")
    n_params = sum(p.numel() for p in model.parameters())
    return {k: sd[k].to(v.dtype) for k, v in want.items()}, n_params


def main(argv=None):
    parser = argparse.ArgumentParser(description="Convert a JAX .ckpt -> .pth")
    parser.add_argument("jax_ckpt")
    parser.add_argument("output")
    parser.add_argument("--cfg", default=None,
                        help="preset name or YAML path (default: config.yaml "
                             "beside the checkpoint, else the defaults)")
    args = parser.parse_args(argv)

    cfg = resolve_cfg(args.cfg, args.jax_ckpt)
    state_dict, n_params = convert(args.jax_ckpt, cfg)
    torch.save({"model": state_dict}, args.output)
    print(f"Converted {n_params:,}-param checkpoint -> {args.output}")
    return state_dict


if __name__ == "__main__":
    main()
