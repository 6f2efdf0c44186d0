"""The readings the limits of ``correct`` are set from (not part of a
benchmark run): the program's checked numbers on many seeds, and the
control's, each seed one short window of the cell's own traffic, in one
process.

    python3 perfbench/readings.py --workload <cell> --seeds 11,12,13 --seconds 8 [--control | --fault NAME]

``--control`` serves with the program's own lower-precision paths switched
on: ``--bf16`` (NAFNet, expert, router and fusion in bf16, the nearest
precision below their fp32) and ``--int8`` (the UNet evals' convolutions in
int8, the nearest below their bf16). ``--fault`` plants one of
``perfbench/faults.py``'s faults under the timed path. Prints one JSON line
a seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONTROL_ARGS = ("--bf16", "--int8")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    from perfbench import faults, harness

    cell = harness.load_cell(ROOT, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.monotonic()
        res = harness.run_cell(cell, seed, args.seconds, False, t0,
                               extra_server_args=CONTROL_ARGS if args.control else (),
                               fault=faults.FAULTS[args.fault] if args.fault else None)
        print(json.dumps({"seed": seed, "control": args.control, "fault": args.fault, "correct": res["correct"],
                          "attempted": res["attempted"], "failed": res["failed"],
                          "checks": {k: v["value"] for k, v in res["checks"].items()},
                          "levels": res["load"]["levels"],
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "wall_s": time.monotonic() - t0}), flush=True)


if __name__ == "__main__":
    main()
