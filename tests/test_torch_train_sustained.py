"""``python -m stemseg_tpu_torch.tools.train_sustained`` at a tiny size on
the CPU (R-50 at narrow widths, 2 frames of 64x96, synthetic clips): 8
steps with a SIGINT after step 2 (the steps after it leave the signal time
to land), the relaunch resumes from the one
checkpoint the interrupt saved, the steps stitch, and the summary holds the
loss curve, both sessions' timing and the loader's waits."""

import json
import os
import subprocess
import sys

from stemseg_tpu_torch.config import load_config, save_config
from test_torch_trainer import TRAIN_SMALL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sustained_run_interrupts_resumes_and_reports(tmp_path):
    cfg_path = str(tmp_path / "small.yaml")
    save_config(load_config(TRAIN_SMALL), cfg_path)
    model_dir = tmp_path / "run"
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "stemseg_tpu_torch.tools.train_sustained", "--model_dir",
         str(model_dir), "--cfg", cfg_path, "--steps", "8", "--interrupt_at", "2", "--k", "2",
         "--num_cpu_workers", "1", "--device", "cpu", "--timeout", "120"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    with open(model_dir / "sustained_summary.json") as fh:
        summary = json.load(fh)
    assert summary["stitched"] and summary["failures"] == []
    stopped = int(os.path.basename(summary["interrupted_checkpoint"])[:6])
    assert 2 <= stopped < 8
    assert [s["steps"] for s in summary["sessions"]] == [stopped, 8 - stopped]
    assert len(summary["loss_curve"]) == 8 and summary["k"] == 2
    assert summary["loss_decreased"] == (summary["loss_last_k"] < summary["loss_first_k"])
    assert all(s["first_step_wait_s"] >= 0 and s["wall_s"] > 0 for s in summary["sessions"])
    assert summary["nvidia_smi"] is None and summary["accumulate_steps"] == 2
    assert sorted(f for f in os.listdir(model_dir) if f.endswith(".pth")) == \
        [f"{stopped:06d}.pth", "000008.pth"]
    assert "Restoring session from" in open(model_dir / "run.log").read()
