"""Boundaries of the PyTorch port: it imports no JAX and nothing of the JAX
package, its presets equal the JAX package's, its entry points refuse to run
without a CUDA device unless the caller asks for the CPU, and
``chip_smoke.py`` fails without a device or outside a checkout."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from stemseg_tpu.config import load_preset as jax_load_preset
from stemseg_tpu.config import to_dict as jax_to_dict
from stemseg_tpu_torch.config import load_preset, to_dict

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import stemseg_tpu_torch
names = [m.name for m in pkgutil.walk_packages(stemseg_tpu_torch.__path__, "stemseg_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "stemseg_tpu"))
assert {"stemseg_tpu_torch.losses.lovasz", "stemseg_tpu_torch.training.main",
        "stemseg_tpu_torch.data.synthetic", "stemseg_tpu_torch.data.augmenter",
        "stemseg_tpu_torch.data.instance_duplicator", "stemseg_tpu_torch.data.video_dataset",
        "stemseg_tpu_torch.data.video_loaders", "stemseg_tpu_torch.data.image_clip_loaders",
        "stemseg_tpu_torch.data.concat_dataset",
        "stemseg_tpu_torch.data.visualize_data_loading",
        "stemseg_tpu_torch.models.flax_msgpack", "stemseg_tpu_torch.inference.fused_pipeline",
        "stemseg_tpu_torch.inference.lsap", "stemseg_tpu_torch.ops.lsap",
        "stemseg_tpu_torch.eval", "stemseg_tpu_torch.eval.davis", "stemseg_tpu_torch.eval.mots",
        "stemseg_tpu_torch.eval.ytvis", "stemseg_tpu_torch.eval.main",
        "stemseg_tpu_torch.models.convert_checkpoint",
        "stemseg_tpu_torch.tools.eval_all", "stemseg_tpu_torch.tools.train_sustained",
        "stemseg_tpu_torch.parallel", "stemseg_tpu_torch.parallel.mesh",
        "stemseg_tpu_torch.utils.distributed",
        "stemseg_tpu_torch.training.optax_state"} <= set(names)
print(len(names), bad)
"""


def _no_cuda_env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_no_cuda_env(),
                         capture_output=True, text=True, timeout=300, check=True)
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 76
    assert bad == "[]", bad


_READ_WITHOUT_JAX = """
import sys
for name in ("jax", "jaxlib", "flax", "msgpack", "ml_dtypes", "stemseg_tpu"):
    sys.modules[name] = None  # importing any of them raises
from stemseg_tpu_torch.models.flax_msgpack import read_msgpack_file
tree = read_msgpack_file(sys.argv[1])
print(sorted(tree), tree["a"].dtype, tree["a"].tolist(), tree["b"], tree["c"].dtype)
"""


def test_the_ckpt_reader_needs_no_jax_flax_or_msgpack(tmp_path):
    import flax.serialization
    import ml_dtypes
    import numpy as np

    path = tmp_path / "x.ckpt"
    path.write_bytes(flax.serialization.msgpack_serialize(
        {"a": np.arange(3, dtype=np.float32), "b": [1, "x"],
         "c": np.ones(2, ml_dtypes.bfloat16)}))
    out = subprocess.run([sys.executable, "-c", _READ_WITHOUT_JAX, str(path)], cwd=REPO,
                         env=_no_cuda_env(), capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip() == "['a', 'b', 'c'] float32 [0.0, 1.0, 2.0] [1, 'x'] torch.bfloat16"


@pytest.mark.parametrize("name", ["davis_1", "davis_2", "kitti_mots_1", "kitti_mots_2",
                                  "youtube_vis"])
def test_presets_match_jax(name):
    assert to_dict(load_preset(name)) == jax_to_dict(jax_load_preset(name))


def _build_model():
    from stemseg_tpu_torch.models import build_model

    build_model(load_preset("davis_2"))


def _writer():
    from stemseg_tpu_torch.inference.output_utils import DavisOutputGenerator

    DavisOutputGenerator("unused")


def _ytvis_writer():
    from stemseg_tpu_torch.inference.output_utils import YoutubeVISOutputGenerator

    YoutubeVISOutputGenerator("unused")


def _kitti_writer():
    from stemseg_tpu_torch.inference.output_utils import KittiMOTSOutputGenerator

    KittiMOTSOutputGenerator("unused")


def _cli_model():
    from stemseg_tpu_torch.inference.main import load_model

    load_model(load_preset("davis_2"), "weights.pth")


def _trainer():
    from stemseg_tpu_torch.training.main import Trainer, make_parser

    args = make_parser().parse_args(["--model_dir", "unused", "--cfg", "davis_1"])
    Trainer(load_preset("davis_1"), "unused", args)


def _trainer_cli():
    from stemseg_tpu_torch.training.main import main

    main(["--model_dir", "unused", "--cfg", "davis_1"])


def _trainer_cli_kitti_mots():
    from stemseg_tpu_torch.training.main import main

    main(["--model_dir", "unused", "--cfg", "kitti_mots_2"])


@pytest.mark.parametrize("entry", [_build_model, _writer, _ytvis_writer, _kitti_writer,
                                   _cli_model, _trainer, _trainer_cli, _trainer_cli_kitti_mots])
def test_entry_points_need_cuda_or_explicit_cpu(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_eval_all_needs_cuda_or_explicit_cpu(tmp_path, monkeypatch):
    import json

    from stemseg_tpu_torch.tools import eval_all

    (tmp_path / "davis.pth").write_bytes(b"")
    (tmp_path / "davis_val.json").write_text(json.dumps(
        {"meta": {"category_labels": {"1": "object"}}, "sequences": []}))
    monkeypatch.setenv("DAVIS_BASE_DIR", str(tmp_path))
    monkeypatch.setenv("STEMSEG_JSON_ANNOTATIONS_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eval_all.main(["--models_dir", str(tmp_path), "--output_dir", str(tmp_path / "out"),
                       "--datasets", "davis"])


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_device_or_checkout(where, tmp_path):
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    env = _no_cuda_env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
