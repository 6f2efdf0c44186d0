"""Runs one cell of the benchmark once and prints its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names its files under ``perfbench/`` (``harness.py`` lists them). The run
starts ``midd_tpu_torch``'s server on the card with checkpoints drawn from
the seed, warms it and the load generator (set-up), offers the cell's
traffic for ``--seconds``, then compares a sample of the answers with the
plain reference. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer ones, read from ``torch.profiler`` and the
harness's spans.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each with its limit. Exit
2, with no result, when the card the cell needs is missing, and 3 when a
module of JAX or of the JAX package was loaded, in this process or the load
generator's (looked at once more just before the result is printed). The caches the program
builds (nvcc's libraries in ``midd_tpu_torch/build``, Inductor's and
Triton's) stay inside the checkout.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / ".perfbench_cache"
    os.environ.update({
        "TORCHINDUCTOR_CACHE_DIR": str(cache / "inductor"),
        "TRITON_CACHE_DIR": str(cache / "inductor" / "triton"),
        "TORCH_EXTENSIONS_DIR": str(cache / "torch_extensions"),
        "CUDA_CACHE_PATH": str(cache / "nv"),
    })
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    cell = harness.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"{args.workload} needs {cell.entry['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T0)
        line = json.dumps(result)
        harness.check_modules()
    except harness.ForbiddenModules as e:
        print(str(e), file=sys.stderr)
        return 3
    print(line, flush=True)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
