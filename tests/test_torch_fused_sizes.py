"""The port's fused sequence path across frame sizes, at the size of
``tests/test_torch_fused_pipeline.py`` (R-50-FPN, windows of 4 frames,
K = 5, the JAX model's flax init carried across with ``state_dict_from_jax``):

1. one ``FusedSequencePipeline`` over sequences of three raw sizes in
   alternation, A B C A B (60x90 and 64x96 share the 64x96 network input
   under two raw keys, as 720x1280 and 1080x1920 share YouTube-VIS's; 48x128
   has its own), each sequence's frames of its own from a seed: against the
   JAX package's fused pipeline (``backend="xla"``) on the same frames and
   weights, labels and fg masks bit-identical, multiclass masks within
   rtol 1e-5 and atol 1e-6 (``test_fused_matches_jax``'s bounds), track
   counts and lifetimes equal; and against a fresh port pipeline on each
   sequence, every output equal;
2. one device state a pipeline: every change of raw size replaces it, a
   sequence of the current size reuses it;
3. a replaced state is released at once (a weak reference to it dies
   without the cyclic GC) after its graphs are reset;
4. the CLI (``--device cpu``) over a YouTube-VIS set of four raw sizes
   interleaved writes one ``results.json``, byte for byte, on its fused,
   streaming (``--profile_clustering``) and ``--data_parallel`` routes,
   although ``--data_parallel`` runs the sequences grouped by size.
"""

import gc
import json
import os
import sys
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stemseg_tpu.config import load_config as jax_load_config
from stemseg_tpu.inference import get_subsequence_frames as jax_windows
from stemseg_tpu.inference.clustering import ClusterParams as JaxClusterParams
from stemseg_tpu.inference.engine import InferenceEngine as JaxEngine
from stemseg_tpu.inference.fused_pipeline import FusedSequencePipeline as JaxFused
from stemseg_tpu.models import build_model as jax_build_model
from stemseg_tpu_torch.config import load_config, load_preset, merge, save_config
from stemseg_tpu_torch.inference import fused_pipeline
from stemseg_tpu_torch.inference import main as cli
from stemseg_tpu_torch.inference.clustering import ClusterParams
from stemseg_tpu_torch.inference.engine import InferenceEngine
from stemseg_tpu_torch.inference.windows import get_subsequence_frames
from stemseg_tpu_torch.models import build_model, init_random_weights, state_dict_from_jax
from stemseg_tpu_torch.structures.geometry import compute_resize_params
from stemseg_tpu_torch.utils.timer import Timer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (the repo root: its mixed-size YouTube-VIS set)

torch.set_num_threads(2)

OVER = {"input": {"num_frames": 4, "num_classes": 2},
        "model": {"backbone": {"type": "R-50-FPN"}},
        # loose thresholds so that random weights still give clusters
        "clustering": {"min_seediness_prob": 0.3, "max_instances": 5}}
MIN_DIM, MAX_DIM = 64, 128
SIZES = {"A": (60, 90), "B": (64, 96), "C": (48, 128)}
ORDER = ["A", "B", "C", "A", "B"]
N_FRAMES = 8


def resize_hw(size):
    h, w = SIZES[size]
    new_w, new_h, _ = compute_resize_params((w, h), MIN_DIM, MAX_DIM)
    return new_h, new_w


def _params(cfg):
    c = cfg.clustering
    return (ClusterParams(c.primary_prob_threshold, c.secondary_prob_threshold,
                          c.min_seediness_prob, c.max_instances),
            JaxClusterParams(c.primary_prob_threshold, c.secondary_prob_threshold,
                             c.min_seediness_prob, c.max_instances))


def _pipe(cfg, model):
    return fused_pipeline.FusedSequencePipeline(InferenceEngine(cfg, model), _params(cfg)[0])


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jax_load_config(OVER), load_config(OVER)
    jmodel = jax_build_model(jcfg, for_training=False)
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                     jnp.zeros((1, 4, 64, 96, 3))))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables))
    rng = np.random.RandomState(11)
    seqs = [(size, (rng.rand(N_FRAMES, *SIZES[size], 3) * 255).astype(np.uint8))
            for size in ORDER]
    return jcfg, cfg, variables, model, seqs


@pytest.fixture(scope="module")
def alternating(setup):
    """The port's pipeline over ``ORDER``, the JAX fused pipeline (one, its
    compile buckets kept) on the same sequences, and a fresh port pipeline
    on each: ([port], [jax], [fresh], states made after each sequence)."""
    jcfg, cfg, variables, model, seqs = setup
    windows = get_subsequence_frames(N_FRAMES, 4, 2)
    assert windows == jax_windows(N_FRAMES, 4, 2)[0]
    pipe = _pipe(cfg, model)
    jpipe = JaxFused(JaxEngine(jcfg, variables), _params(jcfg)[1], backend="xla")
    port, jax_out, fresh, states = [], [], [], []
    for size, frames in seqs:
        port.append(pipe.run(frames, windows, resize_hw=resize_hw(size)))
        states.append(pipe.states_made)
        jax_out.append(jpipe.run(frames, windows, resize_hw=resize_hw(size)))
        fresh.append(_pipe(cfg, model).run(frames, windows, resize_hw=resize_hw(size)))
    return port, jax_out, fresh, states


@pytest.mark.parametrize("i", range(len(ORDER)))
def test_alternating_sizes_match_jax(alternating, i):
    port, jax_out, _, _ = alternating
    got, want = port[i], jax_out[i]
    assert got[0].dtype == np.int32 and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[3], want[3])
    if want[4] is None:
        assert got[4] is None
    else:
        np.testing.assert_allclose(got[4].numpy(), want[4], rtol=1e-5, atol=1e-6)
    assert got[1] == want[1] and got[2] == want[2]
    assert got[3].sum() > 0 and len(got[1]) > 2, "degenerate: no foreground or no clusters"


@pytest.mark.parametrize("i", range(len(ORDER)))
def test_alternating_sizes_match_fresh_pipelines(alternating, i):
    port, _, fresh, _ = alternating
    for a, b in zip(port[i], fresh[i]):
        if torch.is_tensor(a):  # the multiclass masks
            a, b = a.numpy(), b.numpy()
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_every_change_of_raw_size_replaces_the_state(setup, alternating):
    """One state a pipeline: A B C A B makes five (A and B share the 64x96
    network input, but the raw size is in the key); a sequence of the
    current key reuses it (C C A makes two)."""
    _, cfg, _, model, seqs = setup
    assert resize_hw("A") == resize_hw("B") == (64, 96) and resize_hw("C") == (48, 128)
    assert alternating[3] == [1, 2, 3, 4, 5]
    pipe = _pipe(cfg, model)
    windows = get_subsequence_frames(N_FRAMES, 4, 2)
    for size, frames in (seqs[2], seqs[2], seqs[0]):
        pipe.run(frames, windows, resize_hw=resize_hw(size))
    assert pipe.states_made == 2


class _Graph:
    """Stands in for a state's ``CUDAGraph``: records its reset."""

    def __init__(self, resets):
        self.resets = resets

    def reset(self):
        self.resets.append(self)


def test_a_replaced_state_is_released_after_its_graphs_are_reset(setup):
    """The replacement resets every graph of the old state, and nothing
    else holds the state: a weak reference to it is dead right after the
    next size's run, with the cyclic GC off."""
    _, cfg, _, model, seqs = setup
    pipe = _pipe(cfg, model)
    windows = get_subsequence_frames(N_FRAMES, 4, 2)
    resets = []
    gc.collect()
    gc.disable()
    try:
        pipe.run(seqs[0][1], windows, resize_hw=resize_hw("A"))
        old = pipe._state
        graphs = [_Graph(resets), _Graph(resets)]
        old.graphs.update({"prelude": graphs[0], ("scan_a", 2): graphs[1]})
        ref = weakref.ref(old)
        del old
        pipe.run(seqs[2][1], windows, resize_hw=resize_hw("C"))
        alive = ref() is not None
    finally:
        gc.enable()
    assert resets == graphs
    assert not alive
    assert pipe.states_made == 2 and pipe._state.graphs == {}


CLI_SIZES = {"S1": (72, 128), "S2": (108, 192), "S3": (48, 86), "S4": (38, 124)}
NARROW = {"input": {"min_dim": 96, "max_dim": 180, "num_frames": 4},
          "model": {"backbone": {"type": "R-50-FPN"},
                    "resnets": {"backbone_out_channels": 32, "res2_out_channels": 32,
                                "stem_out_channels": 16, "width_per_group": 8},
                    "embeddings": {"inter_channels": [32, 32, 16, 16], "gn_num_groups": 8},
                    "semseg": {"inter_channels": [32, 32, 16, 16], "gn_num_groups": 8}},
          "clustering": {"min_seediness_prob": 0.3},
          "data": {"youtube_vis": {"inference_frame_overlap": 2}}}


def test_cli_mixed_sizes_writes_one_results_json_on_every_route(tmp_path, monkeypatch):
    """The YT-VIS CLI over four raw sizes interleaved (s1_0 s2_0 s3_0 s4_0
    s1_1 ...): the serial fused run, ``--profile_clustering`` and
    ``--data_parallel`` (two CPU replicas, chunks of one size, so the
    sequences run in another order) write the same ``results.json``."""
    env, ids = chip_smoke.write_mixed_ytvis_set(str(tmp_path / "data"), per_size=2,
                                                sizes=CLI_SIZES, n_frames=6, seed=3)
    cfg = merge(load_preset("youtube_vis"), NARROW)
    model = build_model(cfg, device="cpu")
    init_random_weights(model, 4)
    (tmp_path / "model").mkdir()
    pth = str(tmp_path / "model" / "youtube_vis.pth")
    torch.save({"model": model.state_dict()}, pth)
    save_config(cfg, str(tmp_path / "model" / "config.yaml"))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ran = []
    process = cli.TrackGenerator._write

    def spy(self, sequence, *args, **kwargs):
        ran.append(sequence.id)
        return process(self, sequence, *args, **kwargs)

    monkeypatch.setattr(cli.TrackGenerator, "_write", spy)
    out = {}
    for name, extra in (("fused", []), ("streaming", ["--profile_clustering"]),
                        ("data_parallel", ["--data_parallel"])):
        Timer.reset()
        ran.clear()
        cli.main([pth, "-o", str(tmp_path / name), "--dataset", "ytvis", "--device", "cpu",
                  *extra])
        out[name] = ((tmp_path / name / "results.json").read_bytes(), list(ran))
    assert out["fused"][1] == out["streaming"][1] == ids
    assert out["data_parallel"][1] == sorted(ids, key=lambda s: (s[:2], s))
    assert out["fused"][0] == out["streaming"][0] == out["data_parallel"][0]
    instances = json.loads(out["fused"][0])
    assert len({r["video_id"] for r in instances}) > 2
