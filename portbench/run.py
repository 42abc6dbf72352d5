"""Run one benchmark cell of the port once and print its result line.

    python3 portbench/run.py --workload serve_b16 --seed 7 --seconds 10 --trace 0

The cell is `portbench/workloads/<name>.json`. The run makes its inputs and
weights from --seed on the card, warms up the cell's own shapes (set-up),
measures for --seconds, and checks what the timed path produced against the
plain reference (portbench/reference/). With --trace 0 the result's
metrics are the cell's end-to-end metrics; with --trace 1 the run also
profiles a short tail after its window and reports the per-layer metrics
(portbench/metrics/). The last line of standard output is one JSON object;
the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.

It exits non-zero and prints no result without a CUDA card (it never
falls back to the CPU), without the program in the checkout, or when the
process has loaded JAX, flax or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import common  # noqa: E402

common.set_cache_dirs()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args()

    cell = common.load_cell(args.workload)
    try:
        common.require_cards(cell["chips"])
    except common.RunError as e:
        common.log(f"portbench: {e}")
        return 3
    import torch

    from portbench.harness import runner

    print(f"cell {args.workload}: config {cell['config']}, traffic {cell['traffic']}, "
          f"seed {args.seed}, {args.seconds} s, trace {args.trace}", flush=True)
    result = runner.execute(cell, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), T0)
    print(f"card: {common.card_line()}", flush=True)
    bad = common.forbidden_loaded()
    if bad:
        common.log(f"portbench: the process loaded {bad}; the port must run without JAX")
        return 4
    common.log(f"check details: {json.dumps(result.pop('_details'))}")
    for name, c in result["check"].items():
        common.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
