"""On the card: the control (the program's own bf16 path) comes out not
correct at each cell's own size and load, one seed a cell (the limits were
set from three or more; ``PERF.md``). Skips without the cards a cell needs.

    python -m pytest benchmark/tests/test_bench_card.py -q -m card
"""

import json
import os
import subprocess
import sys

import pytest

from benchmark import common

CELLS = [w["name"] for w in common.spec()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(workload, card):
    chips = {w["name"]: w["chips"] for w in common.spec()["workloads"]}[workload]
    if card < chips:
        pytest.skip(f"needs {chips} CUDA devices")
    kind = common.cell(workload)[3]["kind"]
    out = subprocess.run(
        [sys.executable, os.path.join(common.HERE, "control.py"), "--workload", workload,
         "--seconds", "10" if kind == "infer" else "0", "--bf16", "3500000001"],
        capture_output=True, text=True, cwd=common.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    reading = json.loads(out.stdout.strip().splitlines()[-1])
    assert reading["correct"] is False, reading["checks"]
