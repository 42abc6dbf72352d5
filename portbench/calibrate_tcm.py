"""Readings that the limits of a photo cell's `correct` are set from, on
the card at the cell's own size, in one process (calibrate.py's method for
a driver with its own `control` and `FAULTS`, as serve_tcm and serve_hific
have):

  * the program: whole runs (set-up, a short window, the check) on each
    of --seeds;
  * the control: the driver's `control`, the plain reference in float8
    e4m3 (precision.FP8, one step below the configuration's bfloat16) put
    in the program's place, against the reference with the program's
    roundings, on each of --control-seeds, over as many calls as a run
    checks;
  * each fault of the driver's FAULTS planted under the timed path, on
    each of --fault-seeds.

    python3 portbench/calibrate_tcm.py --workload tcm_2048x1536_b4 \
        --seeds 1,2,3 --control-seeds 4,5 --fault-seeds 6 --seconds 5

Prints every reading and, per number, the largest program reading and the
smallest control and fault readings; writes them as JSON to --out. This is
not part of a benchmark run.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import common  # noqa: E402

common.set_cache_dirs()


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def main() -> int:
    p = argparse.ArgumentParser(description="limit readings of one photo cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default="chiprun_out/calibrate")
    args = p.parse_args()

    cell = common.load_cell(args.workload)
    common.require_cards(cell["chips"])
    import torch

    from portbench.harness import runner

    drv = runner.driver(cell)
    dev = torch.device("cuda", 0)
    card = common.card_line()
    print(f"card: {card}", flush=True)
    out = {"cell": args.workload, "card": card, "program": {}, "control": {},
           "faults": {f: {} for f in drv.FAULTS}}

    def checks_of(res):
        c = {k: v["value"] for k, v in res["check"].items()}
        c.update({k: v for k, v in res["_details"].items() if not isinstance(v, list)})
        return c

    for seed in args.seeds:
        t = time.perf_counter()
        res = runner.execute(cell, seed, args.seconds, False, dev, t)
        out["program"][seed] = checks_of(res)
        print(f"program seed {seed} ({time.perf_counter() - t:.1f} s): "
              f"{json.dumps(out['program'][seed])} metrics "
              f"{json.dumps({k: v['value'] for k, v in res['metrics'].items()})} "
              f"memory {res['device']['memory_peak_bytes']}", flush=True)
    for seed in args.control_seeds:
        out["control"][seed] = drv.control(cell, seed, dev)
        print(f"control seed {seed}: {json.dumps(out['control'][seed])}", flush=True)
    for name, fault in drv.FAULTS.items():
        for seed in args.fault_seeds:
            res = runner.execute(cell, seed, args.seconds, False, dev, time.perf_counter(),
                                 fault=fault)
            out["faults"][name][seed] = checks_of(res)
            print(f"fault {name} seed {seed}: {json.dumps(out['faults'][name][seed])}",
                  flush=True)

    print("summary (largest program, smallest control / fault):")
    for k in cell["limits"]:
        line = f"  {k}: program max {max((c[k] for c in out['program'].values()), default=None)!r}"
        line += f", control min {min((c[k] for c in out['control'].values()), default=None)!r}"
        for name, runs in out["faults"].items():
            line += f", {name} min {min((c[k] for c in runs.values()), default=None)!r}"
        print(line, flush=True)
    path = Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    (path / f"{args.workload}.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
