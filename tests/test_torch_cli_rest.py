"""The rest of the inference CLI against the JAX package, on the CPU:

* the port's flax-msgpack reader (``models/flax_msgpack.py``) against
  ``flax.serialization.msgpack_restore``, leaf for leaf and bit for bit: on
  a JAX trainer's checkpoint written by ``save_checkpoint`` (float32 and
  int32 leaves, optax state, the step) with extras of bfloat16 arrays,
  numpy and Python scalars, complex numbers and nested lists; on flax's
  chunked leaves; and its refusals;
* the CLI on a JAX ``.ckpt`` gives the labels and PNGs of the ``.pth`` of
  the same weights, run with ``--profile_clustering --save_vis --profile``:
  the clustering report, a JPEG a frame and a chrome trace;
* ``ClusterTimeLog`` equal to JAX's on the same records, and the
  ``TrackGenerator``'s buckets (point counts, calls) equal to JAX's on the
  same windows;
* ``--save_vis``: the DAVIS writer's JPEGs equal to the JAX writer's, pixel
  for pixel; ``annotate_instance`` equal to JAX's;
* ``chip_smoke.py``'s JAX session writer (its msgpack encoder and the
  inverse of ``state_dict_from_jax``) writes what flax reads back as the
  JAX model's own variables.
"""

import copy
import json
import os

import cv2
import flax.serialization as flax_serialization
import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import yaml

from stemseg_tpu.config import load_config as jax_load_config
from stemseg_tpu.inference.clustering import ClusterTimeLog as JaxClusterTimeLog
from stemseg_tpu.inference.main import TrackGenerator as JaxTrackGenerator
from stemseg_tpu.inference.output_utils import DavisOutputGenerator as JaxDavisWriter
from stemseg_tpu.inference.output_utils import annotate_instance as jax_annotate_instance
from stemseg_tpu.models import build_model as jax_build_model
from stemseg_tpu.training.checkpoint import save_checkpoint as jax_save_checkpoint
from stemseg_tpu.training.step import create_train_state
from stemseg_tpu_torch.config import load_config, to_dict
from stemseg_tpu_torch.inference.clustering import ClusterTimeLog
from stemseg_tpu_torch.inference.main import TrackGenerator
from stemseg_tpu_torch.inference.output_utils import DavisOutputGenerator, annotate_instance
from stemseg_tpu_torch.models import build_model, state_dict_from_jax
from stemseg_tpu_torch.models.flax_msgpack import msgpack_restore
from test_torch_bf16 import write_davis_dataset
from test_torch_inference import H, OVERLAP, SEEDINESS_THRESH, T, W, synthetic_frames
from test_torch_model import SMALL, random_variables

torch.set_num_threads(2)

OVER = copy.deepcopy(SMALL)
OVER["input"].update(min_dim=64, max_dim=96)
OVER["training"].update(batch_size=2)
OVER["clustering"] = {"min_seediness_prob": 0.58}


def assert_same_tree(ours, theirs, path="payload"):
    """Leaf for leaf: the same containers and keys, arrays of the same dtype,
    shape and bytes, scalars of the same type and value."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and list(ours) == list(theirs), path
        for k in theirs:
            assert_same_tree(ours[k], theirs[k], f"{path}/{k}")
    elif isinstance(theirs, list):
        assert isinstance(ours, list) and len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_same_tree(a, b, f"{path}/{i}")
    elif isinstance(theirs, (np.ndarray, np.generic)) and theirs.dtype == ml_dtypes.bfloat16:
        assert torch.is_tensor(ours) and ours.dtype == torch.bfloat16, path
        assert tuple(ours.shape) == np.shape(theirs), path
        assert ours.view(torch.int16).numpy().tobytes() == np.asarray(theirs).tobytes(), path
    elif isinstance(theirs, np.ndarray):
        assert isinstance(ours, np.ndarray) and ours.dtype == theirs.dtype, path
        assert ours.shape == theirs.shape and ours.tobytes() == theirs.tobytes(), path
    else:
        assert type(ours) is type(theirs) and ours == theirs, path


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX trainer's session for random weights (``save_checkpoint`` of a
    ``TrainState`` with SGD momentum under ``optax.MultiSteps``), with
    extras of every kind the reader decodes; the port's ``.pth`` of the same
    weights; each beside a ``config.yaml``."""
    jcfg, cfg = jax_load_config(OVER), load_config(OVER)
    jmodel = jax_build_model(jcfg, for_training=True)
    variables = random_variables(jmodel, (1, 4, 64, 96, 3), 1)
    state, _ = create_train_state(jmodel, jcfg, jax.random.PRNGKey(0),
                                  np.zeros((1, 4, 64, 96, 3), np.float32), accumulate_steps=2)
    state = state.replace(params=variables["params"], constants=variables["constants"])
    extra = {"logger": {"elapsed": 12.5, "history": [[1, 0.5], [2, 0.25]]},
             "bf16": np.linspace(-3, 3, 7).astype(ml_dtypes.bfloat16),
             "scalars": [np.float32(1.5), np.int64(-7), np.bool_(True), 2 ** 40, -3, 0.1,
                         True, None, "text", b"bytes", 1 + 2j],
             "nested": [[1, [2, [3, np.arange(3, dtype=np.int32)]]], {"k": np.float64(2.5)}]}
    root = tmp_path_factory.mktemp("ckpt")
    paths = {}
    for kind in ("ckpt", "pth"):
        (root / kind).mkdir()
        (root / kind / "config.yaml").write_text(yaml.safe_dump(to_dict(cfg)))
    paths["ckpt"] = jax_save_checkpoint(str(root / "ckpt"), 6, state, extra=extra)
    paths["pth"] = str(root / "pth" / "weights.pth")
    torch.save(state_dict_from_jax(variables), paths["pth"])
    return cfg, jcfg, variables, paths


def test_reader_equals_flax_msgpack_restore_on_a_jax_session(jax_ckpt):
    _, _, variables, paths = jax_ckpt
    data = open(paths["ckpt"], "rb").read()
    theirs = flax_serialization.msgpack_restore(data)
    ours = msgpack_restore(data)
    assert_same_tree(ours, theirs)
    assert ours["step"] == 6 and set(ours["state"]) == {"step", "params", "constants",
                                                        "opt_state"}
    assert ours["state"]["step"].dtype == np.int32
    kernel = ours["state"]["params"]["fpn"]["fpn_inner1"]["conv"]["kernel"]
    assert kernel.dtype == np.float32 and np.array_equal(
        kernel, variables["params"]["fpn"]["fpn_inner1"]["conv"]["kernel"])
    assert ours["extra"]["bf16"].float().tolist() == [-3, -2, -1, 0, 1, 2, 3]


def test_reader_joins_chunked_leaves(monkeypatch):
    monkeypatch.setattr(flax_serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(4, 25),
            "bf16": np.arange(50).astype(ml_dtypes.bfloat16),
            "inner": {"small": np.arange(4, dtype=np.int32), "big": np.ones((3, 40), np.uint8)}}
    data = flax_serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    ours = msgpack_restore(data)
    assert_same_tree(ours, flax_serialization.msgpack_restore(data))
    assert ours["big"].shape == (4, 25) and ours["inner"]["big"].shape == (3, 40)


@pytest.mark.parametrize("case", ["unknown_ext", "truncated", "trailing"])
def test_reader_refuses_what_flax_does_not_write(case):
    import msgpack

    data = flax_serialization.msgpack_serialize({"a": np.zeros(3, np.float32)})
    data = {"unknown_ext": msgpack.packb({"a": msgpack.ExtType(9, b"xy")}),
            "truncated": data[:-1], "trailing": data + b"\x00"}[case]
    with pytest.raises(ValueError):
        msgpack_restore(data)


@pytest.fixture(scope="module")
def cli_runs(jax_ckpt, tmp_path_factory):
    """The port's CLI on the same sequence from the ``.ckpt`` (with
    ``--profile_clustering --save_vis --profile``) and from the ``.pth``:
    per run the labels, the printed report and the output dir."""
    from stemseg_tpu_torch.inference import main as cli

    root = tmp_path_factory.mktemp("cli")
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in write_davis_dataset(root, synthetic_frames()).items():
            mp.setenv(k, v)
        inner = TrackGenerator.do_clustering

        for kind, flags in (("ckpt", ["--profile_clustering", "--save_vis",
                                      "--profile", str(root / "trace")]),
                            ("pth", [])):
            seen = {}

            def do_clustering(self, out, _seen=seen):
                result = inner(self, out)
                _seen.setdefault("labels", []).append(np.asarray(result[0]))
                _seen["report"] = self.fps_report()
                return result

            mp.setattr(TrackGenerator, "do_clustering", do_clustering)
            out_dir = root / ("out_" + kind)
            cli.main([jax_ckpt[3][kind], "-o", str(out_dir), "--dataset", "davis",
                      "-fo", str(OVERLAP), "-st", str(SEEDINESS_THRESH), "--device", "cpu",
                      *flags])
            runs[kind] = (seen, out_dir)
    return runs, root


def test_cli_on_a_jax_ckpt_gives_the_labels_of_the_pth(jax_ckpt, cli_runs):
    from stemseg_tpu_torch.inference.main import load_model

    cfg, _, _, paths = jax_ckpt
    a = load_model(cfg, paths["ckpt"], device="cpu").state_dict()
    b = load_model(cfg, paths["pth"], device="cpu").state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)

    runs, _ = cli_runs
    (ckpt_seen, ckpt_out), (pth_seen, pth_out) = runs["ckpt"], runs["pth"]
    assert len(ckpt_seen["labels"]) == 1
    np.testing.assert_array_equal(ckpt_seen["labels"][0], pth_seen["labels"][0])
    assert len(np.unique(ckpt_seen["labels"][0])) > 3
    for t in range(T):
        name = os.path.join("results", "seqA", f"{t:05d}.png")
        assert (ckpt_out / name).read_bytes() == (pth_out / name).read_bytes()


def test_cli_profile_clustering_save_vis_and_profile(cli_runs):
    runs, root = cli_runs
    (seen, out_dir), (pth_seen, pth_out) = runs["ckpt"], runs["pth"]
    report = seen["report"]
    i = report.index("Clustering durations by point count (points: calls, mean ms):")
    # 4-frame windows of 16x24 points: 4 windows over the 10 frames
    assert report[i + 1].startswith(f"  {4 * 16 * 24:>9d}:    4 calls, ")
    assert report[i + 2].startswith("  average: ") and len(report) == i + 3
    assert not any("Clustering durations" in line for line in pth_seen["report"])

    assert sorted(os.listdir(out_dir / "vis" / "seqA")) == [f"{t:05d}.jpg" for t in range(T)]
    assert not os.path.exists(pth_out / "vis")
    first = cv2.imread(str(out_dir / "vis" / "seqA" / "00000.jpg"))
    assert first.shape == (H, W, 3)

    with open(root / "trace" / "trace.json") as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("conv" in n for n in names)


def test_cluster_time_log_matches_jax():
    rng = np.random.RandomState(0)
    ours, theirs = ClusterTimeLog(), JaxClusterTimeLog()
    assert ours.average_time == theirs.average_time == 0.0 and ours.summary() == {}
    for _ in range(9):
        n, d = int(rng.choice([1536, 6144, 207360])), float(rng.rand())
        ours.record(n, d)
        theirs.record(np.int64(n), d)
    assert ours.summary() == theirs.summary()
    assert list(ours.summary()) == sorted(ours.summary())
    assert ours.average_time == theirs.average_time


def test_track_generator_clustering_buckets_match_jax(jax_ckpt):
    cfg, jcfg, variables, _ = jax_ckpt
    frames = synthetic_frames()
    jtg = JaxTrackGenerator(jcfg, "davis", variables, JaxDavisWriter("unused"), 20,
                            seediness_thresh=SEEDINESS_THRESH, frame_overlap=OVERLAP,
                            use_fused=False, profile_clustering=True)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables))
    tg = TrackGenerator(cfg, "davis", model, DavisOutputGenerator("unused", device="cpu"), 20,
                        seediness_thresh=SEEDINESS_THRESH, frame_overlap=OVERLAP,
                        profile_clustering=True)
    for gen in (jtg, tg):
        gen.do_clustering(gen.do_inference(frames, (H, W)))
    ours, theirs = tg.cluster_time_log.summary(), jtg.cluster_time_log.summary()
    assert {p: n for p, (n, _) in ours.items()} == {p: n for p, (n, _) in theirs.items()} == \
        {4 * 16 * 24: 4}
    assert all(s > 0 for _, s in ours.values())


class VisSequence:
    id = "seqV"
    image_dims = (H, W)

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def load_images(self):
        return [f.copy() for f in self.frames]


def test_save_vis_jpegs_equal_the_jax_writer(tmp_path):
    frames = synthetic_frames()
    rng = np.random.RandomState(4)
    labels = rng.randint(-1, 5, (T, 16, 24)).astype(np.int32)
    labels[:, :4] = 7  # a track with the longest lifetime covers a band
    ids, counts = np.unique(labels, return_counts=True)
    counts = {int(i): int(c) for i, c in zip(ids, counts)}
    lifetimes = {i: T - (i % 3) for i in counts}
    seq = VisSequence(frames)
    for gen in (JaxDavisWriter(str(tmp_path / "jax"), save_visualization=True),
                DavisOutputGenerator(str(tmp_path / "port"), save_visualization=True,
                                     device="cpu")):
        gen.process_sequence(seq, labels, counts, lifetimes, None, mask_scale=4, max_tracks=4,
                             min_dim=64, max_dim=96)
    names = sorted(os.listdir(tmp_path / "jax" / "vis" / "seqV"))
    assert names == sorted(os.listdir(tmp_path / "port" / "vis" / "seqV")) == \
        [f"{t:05d}.jpg" for t in range(T)]
    for t, name in enumerate(names):
        ours = cv2.imread(str(tmp_path / "port" / "vis" / "seqV" / name))
        theirs = cv2.imread(str(tmp_path / "jax" / "vis" / "seqV" / name))
        np.testing.assert_array_equal(ours, theirs)
        assert ours.shape == (H, W, 3) and np.abs(ours.astype(int) - frames[t]).mean() > 10


@pytest.mark.parametrize("text", [None, "car 0.93"])
def test_annotate_instance_matches_jax(text):
    frames = synthetic_frames()
    mask = np.zeros((H, W), np.uint8)
    mask[10:20, 12:30] = 1
    ours = annotate_instance(frames[0].copy(), mask, (10, 200, 30), text)
    theirs = jax_annotate_instance(frames[0].copy(), mask, (10, 200, 30), text)
    np.testing.assert_array_equal(ours, theirs)
    assert not np.array_equal(ours, frames[0])


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("shape", ["davis", "ytvis"])
def test_chip_smoke_writes_a_jax_session_that_flax_reads(shape, tmp_path):
    import chip_smoke

    over = copy.deepcopy(OVER)
    if shape == "ytvis":
        over["input"]["num_classes"] = 4
        over["model"].update(use_seediness_head=False, use_semseg_head=True,
                             semseg={"inter_channels": [32, 32, 24, 24], "gn_num_groups": 8})
    variables = random_variables(jax_build_model(jax_load_config(over), for_training=False),
                                 (1, 4, 64, 96, 3), 3)
    sd = state_dict_from_jax(variables)
    torch.save({"model": sd}, tmp_path / "000006.pth")
    chip_smoke.write_jax_session(str(tmp_path / "000006.pth"), 6, str(tmp_path / "s.ckpt"))
    data = (tmp_path / "s.ckpt").read_bytes()
    payload = flax_serialization.msgpack_restore(data)
    assert_same_tree(msgpack_restore(data), payload)
    assert payload["step"] == 6 and int(payload["state"]["step"]) == 6
    for coll in ("params", "constants"):
        got, want = dict(_flat(payload["state"][coll])), dict(_flat(variables[coll]))
        assert got.keys() == want.keys(), coll
        for k in want:
            assert got[k].dtype == np.float32 and got[k].shape == np.shape(want[k]), k
            assert got[k].tobytes() == np.asarray(want[k]).tobytes(), k
    acc = dict(_flat(payload["state"]["opt_state"]["acc_grads"]))
    assert acc.keys() == dict(_flat(variables["params"])).keys()
