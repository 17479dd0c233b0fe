"""The benchmark's harness on the CPU: its files, its arithmetic, its
reference against the system under test at a tiny size, its import
hygiene, and that a run with the timed path broken comes out not
correct."""

import importlib.util
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from benchmark import common, counts, faults
from benchmark.reference import infer as ref_infer
from benchmark.reference import model as ref_model
from benchmark.tests.tiny import tiny

torch.set_num_threads(2)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


# -- the files ------------------------------------------------------------------------

def test_benchmark_json_follows_its_contract():
    spec = common.spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]] + [
        m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"] + [c["name"]])
        assert c["file"].startswith("benchmark/") and os.path.exists(
            os.path.join(common.ROOT, c["file"]))
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        reported = [m for m in e2e if w["name"] in e2e[m].get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= 1
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e
        for w in m["workloads"]:  # each cell that reads it reports what it moves
            assert w in e2e[m["moves"]].get("workloads", [w])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in (
            "lower", "higher")
    assert len(json.dumps(spec)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "traffic", "metrics"])
def test_every_file_loads(kind):
    folder = os.path.join(common.HERE, kind)
    files = sorted(os.listdir(folder))
    assert files
    for name in files:
        path = os.path.join(folder, name)
        if name.endswith(".json"):
            common.load_json(path)
        elif name.endswith(".py"):
            mod_spec = importlib.util.spec_from_file_location("m", path)
            mod = importlib.util.module_from_spec(mod_spec)
            mod_spec.loader.exec_module(mod)
            assert mod.read({}) is None  # a reader that finds nothing returns nothing
        elif name != "__pycache__":
            raise AssertionError(f"unexpected file {path}")


# -- the arithmetic ------------------------------------------------------------------

def test_cluster_bytes_by_hand():
    # 10 points at E = 4: 16 + 4 + 1 bytes read, 4 written a point; the
    # bandwidths of 2 seeds; the meta block
    assert counts.cluster_bytes(10, 4, 2) == 10 * 21 + 2 * 16 + 10 * 4 + 32 * 128 * 4


def test_flops_by_hand():
    with torch.device("meta"):
        conv = torch.nn.Conv2d(3, 8, 3, padding=1)
        x = torch.empty(2, 3, 10, 12)
        assert counts._flops(lambda: conv(x)) == 2 * 2 * 8 * 3 * 9 * 10 * 12
        x.requires_grad_(True)
        # backward: the data gradient and the weight gradient, each as much
        assert counts._flops(lambda: conv(x).sum().backward()) == 3 * 2 * 2 * 8 * 3 * 9 * 10 * 12


def _conv_flops_by_hooks(model, run):
    total = []

    def hook(mod, inp, out):
        k = mod.weight[0].numel()  # Cin / groups x kernel
        total.append(2 * out.numel() * k)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Conv3d))]
    with torch.no_grad():
        run()
    for h in hooks:
        h.remove()
    return sum(total)


def test_inference_flops_by_hand():
    conf, _ = tiny("stemseg-davis", "davis-val")
    cfg = conf["infer"]
    per_frame, per_window = counts.inference_flops(cfg, (64, 96))
    model = ref_model.Model(cfg)
    frame = torch.zeros(1, 3, 64, 96)
    assert per_frame == _conv_flops_by_hooks(model, lambda: model.backbone(frame))
    feats = [f.unsqueeze(2).expand(-1, -1, cfg["input"]["num_frames"], -1, -1)
             for f in model.backbone(frame)][::-1]
    # the heads' convs, and the expand step's two halves of one 1x1x1 conv
    # (F.conv3d, no module hook) counted from their shapes
    by_hooks = _conv_flops_by_hooks(model, lambda: model.heads(feats))
    assert per_window >= by_hooks
    assert per_window < 1.5 * by_hooks


# -- the reference against the system under test -----------------------------------

@pytest.mark.parametrize("config", ["stemseg-davis", "stemseg-ytvis"])
def test_reference_model_is_the_ports(config):
    from stemseg_tpu_torch.config import load_config
    from stemseg_tpu_torch.models import build_model

    conf, _ = tiny(config, "davis-val")
    cfg = conf["infer"]
    ref = ref_model.Model(cfg)
    state = common.random_weights(ref, 5, torch.device("cpu"))
    ref.load_state_dict(state)
    port = build_model(load_config(cfg), device="cpu")
    port.load_state_dict(state)
    x = torch.randn(2, 8, 3, 64, 96)
    with torch.no_grad():
        e_ref, s_ref = ref(x)
        out = port(x)
    torch.testing.assert_close(e_ref, out["embeddings"], rtol=1e-4, atol=1e-5)
    if s_ref is not None:
        torch.testing.assert_close(s_ref, out["semseg_masks"], rtol=1e-4, atol=1e-5)


def test_reference_clustering_is_the_ports():
    from stemseg_tpu_torch.ops.cluster import cluster_points_reference

    g = torch.Generator().manual_seed(3)
    p = 4000
    emb = torch.rand(p, 4, generator=g) * 2 - 1
    bw = torch.rand(p, 4, generator=g) * 20 + 1
    seed = torch.rand(p, generator=g)
    fg = torch.rand(p, generator=g) > 0.2
    want, _ = cluster_points_reference(emb, bw, seed, fg, e_dims=4, max_instances=20,
                                       primary=0.5, secondary=0.3, min_seediness=0.05,
                                       reference_secondary=True)
    got = ref_infer.cluster(emb, bw, seed, fg, 20, 0.5, 0.3, 0.05)
    assert torch.equal(got, want)


# -- whole runs at a tiny size ------------------------------------------------------------

@pytest.mark.parametrize("broken", [False, True], ids=["sound", "answers_altered"])
@pytest.mark.parametrize("config,dataset", [("stemseg-davis", None), ("stemseg-ytvis", "ytvis")],
                         ids=["davis", "ytvis"])
def test_inference_run(config, dataset, broken, monkeypatch):
    from benchmark.drivers import infer

    if broken:
        faults.plant("answers_altered", monkeypatch.setattr)
    conf, traffic = tiny(config, "davis-val", dataset=dataset)
    out = infer.run("davis-val-fp32", conf, traffic, 2 ** 31 + 11, 1.0, True, time.perf_counter(),
                    device="cpu")
    assert out["correct"] is (not broken), out["checks"]
    assert out["attempted"] >= 1 and out["ctx"]["frames"] > 0
    if not broken:
        assert out["checks"][0][1] == 0.0


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_batch"])
def test_training_run(fault, monkeypatch):
    from benchmark.drivers import train

    if fault:
        faults.plant(fault, monkeypatch.setattr)
    conf, traffic = tiny("stemseg-ytvis", "ytvis-train", frames=4)
    traffic["workers"] = 0
    out = train.run("ytvis-train-fp32", conf, traffic, 2 ** 31 + 13, 0.5, False,
                    time.perf_counter(), device="cpu")
    assert out["correct"] is (fault is None), out["checks"]


@pytest.mark.parametrize("fault", [None, "exchange_left_out", "half_batch"])
def test_data_parallel_run(fault, monkeypatch):
    from benchmark.drivers import train

    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    if fault:
        monkeypatch.setattr(train, "WORKER_ARGV", [os.path.join(common.HERE, "faults.py"), fault])
    conf, traffic = tiny("stemseg-davis", "davis-train-dp4", frames=4)
    traffic.update(world=2, workers=0)
    out = train.run("davis-train-dp4", conf, traffic, 2 ** 31 + 17, 0.5, False,
                    time.perf_counter(), device="cpu")
    assert out["correct"] is (fault is None), out["checks"]
    assert "clips_per_s" in out["end_to_end"]


# a rank worker that holds a module named like the JAX package's stack (rank 1 only)
STUB_JAX_RANK = (
    "import os, sys, types\n"
    "sys.path.insert(0, {root!r})\n"
    "if os.environ['RANK'] == '1':\n"
    "    sys.modules['jax'] = types.ModuleType('jax')\n"
    "from benchmark import run\n"
    "run.main(sys.argv[1:])\n")


def test_rank_holding_a_forbidden_module_gives_no_result(monkeypatch, capfd):
    from benchmark.drivers import train

    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    monkeypatch.setattr(train, "WORKER_ARGV", ["-c", STUB_JAX_RANK.format(root=common.ROOT)])
    conf, traffic = tiny("stemseg-davis", "davis-train-dp4", frames=4)
    traffic.update(world=2, workers=0)
    with pytest.raises(SystemExit) as exit_:
        train.run("davis-train-dp4", conf, traffic, 2 ** 31 + 19, 0.5, False,
                  time.perf_counter(), device="cpu")
    assert exit_.value.code not in (0, None)
    assert "['jax']" in capfd.readouterr().err


# -- imports ------------------------------------------------------------------------------

def _modules_after(code: str):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=common.ROOT, timeout=600,
                         env=dict(os.environ, PYTHONPATH=common.ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = _modules_after(
        "import sys, json, time, torch; torch.set_num_threads(2)\n"
        "from benchmark import run, common, counts, control\n"
        "from benchmark.drivers import infer, train\n"
        "from benchmark.tests.tiny import tiny\n"
        "conf, traffic = tiny('stemseg-davis', 'davis-val')\n"
        "out = infer.run('davis-val-fp32', conf, traffic, 1, 0.2, True, time.perf_counter(),"
        " device='cpu')\n"
        "common.read_metrics(['mfu.infer', 'cluster_roofline'], out['ctx'])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not mods & set(common.FORBIDDEN), mods & set(common.FORBIDDEN)
    assert "stemseg_tpu_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = _modules_after(
        "import sys, json, torch, numpy as np\n"
        "from benchmark.reference import model, infer, train\n"
        "from benchmark.tests.tiny import tiny\n"
        "conf, _ = tiny('stemseg-ytvis', 'davis-val')\n"
        "m = model.Model(conf['infer'])\n"
        "f = np.zeros((10, 48, 85, 3), np.uint8)\n"
        "infer.infer_sequence(m, conf['infer'], f, 4, True)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not mods & (set(common.FORBIDDEN) | {"stemseg_tpu_torch"})
