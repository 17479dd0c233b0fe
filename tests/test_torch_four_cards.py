"""Data parallelism on four cards, what the CPU can show of it:

* ``python3 chip_smoke.py --four-cards`` on a host with fewer than four
  CUDA devices (here: none) exits non-zero, says what it needs, and builds
  nothing, in a checkout and alone;
* ``init_from_env`` binds an NCCL group to the rank's card
  (``device_id=cuda:LOCAL_RANK``), so that a barrier before the first
  collective cannot guess another card; gloo groups are not bound;
* the inference CLI's ``main`` frees its model, ``TrackGenerator``, fused
  pipeline and device state when it returns, and a dropped fused pipeline
  frees its device state at once, without the cyclic GC: reference cycles
  kept a finished run's CUDA graphs and buffers alive, and an in-process
  caller that runs the CLI again and again (``tools.eval_all``, or four
  runs on four cards) filled the first card.

The rest of phase 23's parts are held on the CPU elsewhere: its one-process
reference of the ranks' gradient in ``test_torch_distributed.py``, four
``run_batch`` slots and ``--data_parallel`` over four devices in
``test_torch_data_parallel.py``."""

import gc
import json
import os
import shutil
import subprocess
import sys
import weakref

import cv2
import numpy as np
import pytest
import torch

from stemseg_tpu_torch.config import load_config, save_config
from stemseg_tpu_torch.inference import fused_pipeline
from stemseg_tpu_torch.inference import main as cli
from stemseg_tpu_torch.inference.clustering import ClusterParams
from stemseg_tpu_torch.inference.engine import InferenceEngine
from stemseg_tpu_torch.inference.windows import get_subsequence_frames
from stemseg_tpu_torch.models import build_model, init_random_weights
from stemseg_tpu_torch.utils import distributed
from stemseg_tpu_torch.utils.timer import Timer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_DIR = os.path.join(REPO, "build", "torch_kernels")

torch.set_num_threads(2)


def kernel_files():
    return sorted(os.listdir(KERNEL_DIR)) if os.path.isdir(KERNEL_DIR) else []


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_four_cards_needs_four_devices_and_builds_nothing(where, tmp_path):
    script, cwd = os.path.join(REPO, "chip_smoke.py"), REPO
    if where == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    before = kernel_files()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, script, "--four-cards"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "phase" not in out.stdout
    if where == "checkout":
        assert "needs 4 CUDA devices on one host, found 0" in out.stderr, out.stderr
    else:
        assert "root of a checkout" in out.stderr, out.stderr
    assert "nvcc" not in out.stdout + out.stderr
    assert kernel_files() == before
    assert not (tmp_path / "build").exists()


@pytest.fixture
def launched(monkeypatch):
    """torchrun's variables for rank 3 of 4, and a stand-in for
    ``init_process_group`` that records its arguments."""
    for key, value in {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "3",
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "29500"}.items():
        monkeypatch.setenv(key, value)
    calls = []
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda *args, **kwargs: calls.append((args, kwargs)))
    monkeypatch.setattr(distributed, "resolve_device", torch.device)
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: calls.append(("set_device", dev)))
    return calls


def test_nccl_group_is_bound_to_the_rank_card(launched):
    assert distributed.init_from_env("cuda") == torch.device("cuda", 3)
    assert launched[0] == ("set_device", torch.device("cuda", 3))
    (args, kwargs), = launched[1:]
    assert args == ("nccl",) and kwargs["device_id"] == torch.device("cuda", 3)
    assert (kwargs["rank"], kwargs["world_size"]) == (3, 4)
    assert kwargs["init_method"] == "tcp://127.0.0.1:29500"


@pytest.mark.parametrize("device, backend", [("cpu", None), ("cuda", "gloo")])
def test_gloo_group_is_not_bound(launched, device, backend):
    dev = distributed.init_from_env(device, backend)
    assert dev == (torch.device("cpu") if device == "cpu" else torch.device("cuda", 3))
    (args, kwargs), = [c for c in launched if c[0] != "set_device"]
    assert args == ("gloo",) and kwargs["device_id"] is None


NARROW = {"input": {"num_frames": 4, "num_classes": 2, "min_dim": 32, "max_dim": 48},
          "model": {"backbone": {"type": "R-50-FPN"},
                    "resnets": {"backbone_out_channels": 32, "res2_out_channels": 32,
                                "stem_out_channels": 16, "width_per_group": 8},
                    "embeddings": {"inter_channels": [32, 32, 16, 16], "gn_num_groups": 8},
                    "seediness": {"inter_channels": [32, 32, 16, 16], "gn_num_groups": 8}},
          "clustering": {"min_seediness_prob": 0.0, "max_instances": 5}}


class NoCyclicGC:
    """The cyclic garbage collector off inside the block: what is still
    alive after it is kept by a reference, or by a cycle."""

    def __enter__(self):
        gc.collect()
        gc.disable()

    def __exit__(self, *exc):
        gc.enable()
        return False


def tracked(monkeypatch, *classes):
    """Weak references to every instance of ``classes`` made from now."""
    refs = []
    for cls in classes:
        init = cls.__init__

        def tracking_init(self, *args, _init=init, **kwargs):
            refs.append(weakref.ref(self))
            _init(self, *args, **kwargs)

        monkeypatch.setattr(cls, "__init__", tracking_init)
    return refs


def test_cli_frees_its_device_state_when_main_returns(tmp_path, monkeypatch):
    rng = np.random.RandomState(0)
    sequences = []
    for sid, n in (("a", 5), ("b", 9)):
        (tmp_path / "davis" / sid).mkdir(parents=True)
        paths = [f"{sid}/{t:05d}.jpg" for t in range(n)]
        for path in paths:
            cv2.imwrite(str(tmp_path / "davis" / path),
                        rng.randint(0, 255, (48, 64, 3), np.uint8))
        sequences.append({"id": sid, "height": 48, "width": 64, "image_paths": paths,
                          "categories": {}, "segmentations": [{} for _ in paths]})
    (tmp_path / "ann").mkdir()
    (tmp_path / "ann" / "davis_val.json").write_text(json.dumps(
        {"meta": {"category_labels": {"1": "object"}}, "sequences": sequences}))
    cfg = load_config(NARROW)
    model = build_model(cfg, device="cpu")
    init_random_weights(model, 1)
    (tmp_path / "model").mkdir()
    torch.save({"model": model.state_dict()}, tmp_path / "model" / "davis.pth")
    save_config(cfg, str(tmp_path / "model" / "config.yaml"))
    del model
    monkeypatch.setenv("DAVIS_BASE_DIR", str(tmp_path / "davis"))
    monkeypatch.setenv("STEMSEG_JSON_ANNOTATIONS_DIR", str(tmp_path / "ann"))
    refs = tracked(monkeypatch, cli.TrackGenerator, fused_pipeline.FusedSequencePipeline,
                   fused_pipeline._State)
    for extra in ([], ["--data_parallel"]):
        Timer.reset()
        with NoCyclicGC():
            cli.main([str(tmp_path / "model" / "davis.pth"), "-o", str(tmp_path / "out"),
                      "--dataset", "davis", "--device", "cpu", "--frame_overlap", "2", *extra])
            alive = [type(r()).__name__ for r in refs if r() is not None]
        assert alive == [], (extra, alive)
    # the serial run, and the data-parallel run with a replica of its own
    assert len(refs) == 2 * 3 + 2


def test_a_dropped_fused_pipeline_frees_its_state_at_once(monkeypatch):
    """The device state holds its pipeline weakly: a pipeline dropped after
    a run (its state, buffers and graphs with it) is freed at once."""
    cfg = load_config(NARROW)
    model = build_model(cfg, device="cpu")
    init_random_weights(model, 2)
    c = cfg.clustering
    refs = tracked(monkeypatch, fused_pipeline.FusedSequencePipeline, fused_pipeline._State)
    frames = (np.random.RandomState(3).rand(6, 48, 64, 3) * 255).astype(np.uint8)
    with NoCyclicGC():
        pipe = fused_pipeline.FusedSequencePipeline(
            InferenceEngine(cfg, model),
            ClusterParams(c.primary_prob_threshold, c.secondary_prob_threshold,
                          c.min_seediness_prob, c.max_instances))
        pipe.run(frames, get_subsequence_frames(6, 4, 2), resize_hw=(32, 48))
        assert [r() is not None for r in refs] == [True, True]
        del pipe
        alive = [r() is not None for r in refs]
    assert alive == [False, False]
