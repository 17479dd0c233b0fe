"""Readings of a cell's compared numbers over many seeds in one process, for
the program as the configuration states it, for its control (the
program's own lower precision, bfloat16) or with a fault planted
(``faults.py``), at the cell's own sizes and load:

    python3 benchmark/control.py --workload NAME --seconds S [--bf16]
        [--fault NAME] SEED...

Prints one JSON line a seed: the numbers compared, their limits and whether
the run came out correct. The benchmark's runs never run the control or a
fault; the limits in the traffic files were set from these readings
(``PERF.md``). A training cell's readings need no window: ``--seconds 0``
runs one optimizer step after set-up.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--fault")
    parser.add_argument("seeds", type=int, nargs="+")
    args = parser.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import importlib

    import torch

    from benchmark import common, faults

    _, workload, conf, traffic = common.cell(args.workload)
    common.require_cards(workload["chips"])
    driver = importlib.import_module(f"benchmark.drivers.{traffic['kind']}")
    if args.fault and traffic.get("world", 1) > 1:
        driver.WORKER_ARGV = [os.path.join(common.HERE, "faults.py"), args.fault]
    elif args.fault:
        faults.plant(args.fault)
    for seed in args.seeds:
        out = driver.run(args.workload, conf, traffic, seed, args.seconds, False,
                         time.perf_counter(), dtype=torch.bfloat16 if args.bf16 else None)
        print(json.dumps({"workload": args.workload, "seed": seed, "bf16": args.bf16,
                          "fault": args.fault,
                          "correct": out["correct"], "attempted": out["attempted"],
                          "checks": {n: [v, lim] for n, v, lim in out["checks"]}}), flush=True)


if __name__ == "__main__":
    main()
