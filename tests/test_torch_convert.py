"""The port's checkpoint converter (``stemseg_tpu_torch.models.
convert_checkpoint``, a JAX ``.ckpt`` to a ``.pth``) against the JAX
package, on the CPU:

* a random ``.pth`` through the JAX package's converter (``.pth`` ->
  weights-only ``.ckpt``) and then the port's (``.ckpt`` -> ``.pth``)
  gives back every tensor exactly, for a DAVIS- and a YT-VIS-shaped model;
* a JAX trainer's session ``.ckpt`` (``save_checkpoint``) becomes a
  ``.pth`` equal to its params and constants, which the inference CLI's
  ``load_model`` reads;
* ``--cfg`` resolution (a preset, a YAML path, the ``config.yaml`` beside
  the checkpoint) and the refusal of a tree with a leaf too many, too few,
  of another shape, or two leaves for one key.
"""

import copy
import os

import flax.serialization as flax_serialization
import jax
import numpy as np
import pytest
import torch
import yaml

from stemseg_tpu.config import load_config as jax_load_config
from stemseg_tpu.models import build_model as jax_build_model
from stemseg_tpu.models.convert_checkpoint import main as jax_convert_main
from stemseg_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from stemseg_tpu.training.step import create_train_state
from stemseg_tpu_torch.config import load_config, load_preset, to_dict
from stemseg_tpu_torch.models import convert_checkpoint, state_dict_from_jax
from test_torch_cli_rest import OVER
from test_torch_model import random_variables
from test_torch_semseg import small_cfg

torch.set_num_threads(2)

CONFIGS = {"davis": OVER, "ytvis": small_cfg("ytvis", 4)}


def write_cfg(path, over):
    path.write_text(yaml.safe_dump(to_dict(load_config(over))))
    return str(path)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pth_to_jax_ckpt_to_pth_gives_back_every_tensor(name, tmp_path, capsys):
    over = CONFIGS[name]
    variables = random_variables(jax_build_model(jax_load_config(over), for_training=False),
                                 (1, 4, 64, 96, 3), 5)
    original = state_dict_from_jax(variables)
    cfg_path = write_cfg(tmp_path / "cfg.yaml", over)
    torch.save({"model": original}, tmp_path / "ref.pth")
    jax_convert_main([str(tmp_path / "ref.pth"), str(tmp_path / "w.ckpt"), "--cfg", cfg_path])
    back = convert_checkpoint.main([str(tmp_path / "w.ckpt"), str(tmp_path / "w.pth"),
                                    "--cfg", cfg_path])
    # both tools print the parameter count of the model
    jax_line, line = capsys.readouterr().out.strip().splitlines()
    assert line.split(" -> ")[0] == jax_line.split(" -> ")[0]
    saved = torch.load(tmp_path / "w.pth", map_location="cpu", weights_only=True)
    assert list(saved) == ["model"] and list(saved["model"]) == list(back)
    assert set(back) == set(original)
    for k, v in original.items():
        assert torch.equal(saved["model"][k], v), k


def test_jax_session_ckpt_to_pth_equals_its_params_and_constants(tmp_path):
    from stemseg_tpu_torch.inference.main import load_model

    jcfg, cfg = jax_load_config(OVER), load_config(OVER)
    jmodel = jax_build_model(jcfg, for_training=True)
    variables = random_variables(jmodel, (1, 4, 64, 96, 3), 6)
    state, _ = create_train_state(jmodel, jcfg, jax.random.PRNGKey(0),
                                  np.zeros((1, 4, 64, 96, 3), np.float32), accumulate_steps=2)
    state = state.replace(params=variables["params"], constants=variables["constants"])
    (tmp_path / "run").mkdir()
    write_cfg(tmp_path / "run" / "config.yaml", OVER)
    ckpt = jax_save_checkpoint(str(tmp_path / "run"), 8, state, extra={"logger": {}})
    out = str(tmp_path / "run" / "000008.pth")
    back = convert_checkpoint.main([ckpt, out])  # config.yaml beside the .ckpt
    want = state_dict_from_jax(variables)
    assert set(back) == set(want)
    assert all(torch.equal(back[k], v) for k, v in want.items())
    model = load_model(cfg, out, device="cpu")
    assert all(torch.equal(model.state_dict()[k], v) for k, v in want.items())


def test_cfg_resolution(tmp_path):
    assert to_dict(convert_checkpoint.resolve_cfg("davis_2", "x.ckpt")) == \
        to_dict(load_preset("davis_2"))
    path = write_cfg(tmp_path / "c.yaml", OVER)
    assert to_dict(convert_checkpoint.resolve_cfg(path, "x.ckpt")) == to_dict(load_config(OVER))
    write_cfg(tmp_path / "config.yaml", OVER)
    assert to_dict(convert_checkpoint.resolve_cfg(None, str(tmp_path / "w.ckpt"))) == \
        to_dict(load_config(OVER))
    assert to_dict(convert_checkpoint.resolve_cfg(None, str(tmp_path / "sub" / "w.ckpt"))) == \
        to_dict(load_config({}))


def _mutated(variables, how):
    tree = copy.deepcopy(variables)
    head = tree["params"]["embedding_head"]
    if how == "extra_leaf":
        head["conv_extra"] = {"conv": {"kernel": np.zeros((1, 1, 1, 16, 2), np.float32)}}
    elif how == "missing_leaf":
        del head["conv_variance"]["conv"]["bias"]
    elif how == "wrong_shape":
        head["conv_variance"]["conv"]["bias"] = np.zeros(7, np.float32)
    elif how == "missing_constant":
        del tree["constants"]["embedding_head"]["time_scale"]
    elif how == "two_leaves_one_key":  # a GroupNorm's "scale" beside a conv's "kernel"
        head["conv_variance"]["conv"]["scale"] = head["conv_variance"]["conv"]["bias"]
    return tree


@pytest.mark.parametrize("how", ["extra_leaf", "missing_leaf", "wrong_shape",
                                 "missing_constant", "two_leaves_one_key"])
def test_a_tree_that_does_not_fill_the_model_is_refused(how, tmp_path):
    variables = random_variables(jax_build_model(jax_load_config(OVER), for_training=False),
                                 (1, 4, 64, 96, 3), 7)
    path = tmp_path / "w.ckpt"
    path.write_bytes(flax_serialization.msgpack_serialize(
        {"state": _mutated(variables, how), "extra": {}, "step": 0}))
    cfg_path = write_cfg(tmp_path / "cfg.yaml", OVER)
    with pytest.raises(ValueError, match="left over|unfilled|shapes differ|two leaves"):
        convert_checkpoint.main([str(path), str(tmp_path / "w.pth"), "--cfg", cfg_path])
    assert not os.path.exists(tmp_path / "w.pth")
