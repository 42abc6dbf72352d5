"""Readings that the limits of `correct` are set from, for one cell, on the
card at the cell's own size, in one process:

  * the program: whole runs (set-up, a short window, the check) on each
    of --seeds;
  * the control: the plain reference put in the program's place, one
    precision step below the configuration's (serving: the codec's
    products in float8 e4m3 and the mask engine in bfloat16; training:
    float32 products in TF32, the card's own TF32 paths switched on),
    against the reference, on each of --control-seeds, over as many calls
    or steps as a run compares;
  * each fault of harness/faults.py planted under the timed path, on each
    of --fault-seeds.

    python3 portbench/calibrate.py --workload serve_b16 --seeds 1,2,3 \
        --control-seeds 4,5,6 --fault-seeds 7,8,9 --seconds 2

Prints every reading and, per number, the largest program reading and the
smallest control and fault readings; writes them all as JSON to --out.
This is not part of a benchmark run.
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


def serve_control(cell, seed, dev):
    import numpy as np
    import torch

    from portbench.harness import check, inputs
    from portbench.harness.serve import Plan
    from portbench.reference import codec as ref_codec
    from portbench.reference import precision

    spec, traffic = cell["config_spec"], cell["traffic_spec"]
    m, b = spec["model"], traffic["batch"]
    pool = inputs.structured_images(seed, traffic["pool"], m["img_size"][0], dev)
    plan = Plan(seed, traffic["pool"], b, traffic["bpps"])
    calls = np.random.default_rng([seed, 3]).choice(64, traffic["check_calls"], replace=False)
    sd = inputs.make_weights(ref_codec.codec_shapes(m), seed, "codec", dev)
    params, tails = ref_codec.serving_params(sd, m)
    del sd
    got, want = [], []
    for i in calls:
        imgs = pool[int(plan.starts[i]):int(plan.starts[i]) + b]
        bpp = float(plan.bpps[i])
        want.append(check.serving_reference(params, tails, spec, imgs, bpp))
        got.append(check.serving_reference(params, tails, spec, imgs, bpp, precision.FP8,
                                           precision.BF16))
    del params, tails, pool
    torch.cuda.empty_cache()
    return check.serving_gaps(got, want)


def train_control(cell, seed, dev):
    import torch

    from portbench.harness import check
    from portbench.harness.train import reference_steps

    spec, traffic = cell["config_spec"], cell["traffic_spec"]
    want = reference_steps(spec, traffic, seed, dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = reference_steps(spec, traffic, seed, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    details: dict = {}
    gaps = check.training_gaps(got, want, details)
    print(f"control details: {json.dumps(details)}", flush=True)
    return gaps


def main() -> int:
    p = argparse.ArgumentParser(description="limit readings of one cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--faults", default="", help="comma-separated names, default all")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="chiprun_out/calibrate")
    args = p.parse_args()

    cell = common.load_cell(args.workload)
    common.require_cards(cell["chips"])
    import torch

    from portbench.harness import faults, runner

    dev = torch.device("cuda", 0)
    kind = cell["traffic_spec"]["driver"]
    table = faults.SERVE if kind == "serve" else faults.TRAIN
    chosen = [f for f in args.faults.split(",") if f] or list(table)
    print(f"card: {common.card_line()}", flush=True)
    out = {"cell": args.workload, "card": common.card_line(), "program": {}, "control": {},
           "faults": {f: {} for f in chosen}}

    def show(label, seed, checks, extra=""):
        print(f"{label} seed {seed}: " + " ".join(f"{k}={v!r}" for k, v in checks.items())
              + extra, flush=True)

    for seed in args.seeds:
        t = time.perf_counter()
        res = runner.execute(cell, seed, args.seconds, False, dev, t)
        checks = {k: c["value"] for k, c in res["check"].items()}
        checks.update({k: v for k, v in res["_details"].items() if not isinstance(v, list)})
        out["program"][seed] = dict(checks, details=res["_details"])
        metrics = {k: v["value"] for k, v in res["metrics"].items()}
        show("program", seed, checks, f" ({time.perf_counter() - t:.1f} s) metrics "
             f"{json.dumps(metrics)} details {json.dumps(res['_details'])}")
    for seed in args.control_seeds:
        checks = (serve_control if kind == "serve" else train_control)(cell, seed, dev)
        out["control"][seed] = checks
        show("control", seed, checks)
    for name in chosen:
        for seed in args.fault_seeds:
            res = runner.execute(cell, seed, args.seconds, False, dev, time.perf_counter(),
                                 fault=table[name])
            checks = {k: c["value"] for k, c in res["check"].items()}
            checks.update({k: v for k, v in res["_details"].items()
                           if not isinstance(v, list)})
            out["faults"][name][seed] = checks
            show(f"fault {name}", seed, checks)

    print("summary (largest program, smallest control / fault):")
    for k in cell["limits"]:
        prog = [c[k] for c in out["program"].values()]
        ctrl = [c[k] for c in out["control"].values() if k in c]
        line = f"  {k}: program max {max(prog) if prog else None!r}, " \
               f"control min {min(ctrl) if ctrl else None!r}"
        for name in chosen:
            vals = [c[k] for c in out["faults"][name].values()]
            line += f", {name} min {min(vals) if vals else None!r}"
        print(line, flush=True)
    path = Path(args.out)
    path.mkdir(parents=True, exist_ok=True)
    with open(path / f"{args.workload}.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
