"""The benchmark of ``stemseg_tpu_torch`` on NVIDIA GPUs.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

runs one cell of ``BENCHMARK.json`` from the root of a checkout and prints
its result as the last line of standard output: the cell's end-to-end
metrics with ``--trace 0``, its per-layer metrics from a profiled run with
``--trace 1``. The cell's traffic file names the driver (``drivers/<kind>.py``)
that runs it. Exits non-zero, with no result, when the cards the cell asks
for are missing or the system under test cannot be imported.
"""

import time

T0 = time.perf_counter()  # the run's set-up starts here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--rank-worker", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)

    from benchmark import common

    if args.rank_worker is not None:  # a rank of a multi-rank run, on its parent's files
        kind = json.loads(args.rank_worker)["kind"]
        importlib.import_module(f"benchmark.drivers.{kind}").rank_worker(args)
        return
    spec, workload, conf, traffic = common.cell(args.workload)
    import stemseg_tpu_torch  # noqa: F401  (exits here in a tree without the program)

    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    common.require_cards(workload["chips"])
    out = driver.run(args.workload, conf, traffic, args.seed, args.seconds, bool(args.trace), T0)
    kind = "per_layer" if args.trace else "end_to_end"
    names = [m["name"] for m in spec[kind]
             if args.workload in m.get("workloads", [args.workload])]
    if args.trace:
        metrics = common.read_metrics(names, out["ctx"])
    else:
        metrics = {k: out["end_to_end"][k] for k in names}
    units = {m["name"]: m["unit"] for m in spec[kind]}
    common.finish(common.result_line(out, metrics, units), out["checks"])


if __name__ == "__main__":
    main()
