"""The control, and the faults, at a cell's own size on the card:

    python3 stembench/control.py --workload NAME --seconds S \
        --seeds N [N ...] [--fault control|unchanged|half|altered|...]

Runs the cell as ``run.py`` does, with the timed path broken underneath
(``faults.broken``), and prints each seed's compared numbers beside their
limits, one JSON line a seed. Every line must read ``correct: false``.
The benchmark's own runs never run this.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
sys.path[0:1] = [str(ROOT / "src"), str(ROOT)]

from stembench import faults, generate, harness  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default="control")
    args = p.parse_args(argv)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = {c["name"]: c for c in bench["workloads"]}[args.workload]
    config = harness.load_json(harness.find("configs", cell["config"]))
    traffic = harness.load_json(harness.find("traffic", cell["traffic"]))
    for seed in args.seeds:
        d = generate.build_dictionary(config["dictionary"], seed)
        with faults.broken(traffic["entry"], args.fault, d):
            out = harness.run_cell(bench, cell, config, traffic, seed=seed,
                                   seconds=args.seconds, trace=False,
                                   device="cuda:0", t0=time.perf_counter())
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "failed": out["failed"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
