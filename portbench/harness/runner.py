"""One run of one cell: set-up, window, optional traced tail, the check,
and the result line's content.

`execute` is what `run.py` calls on the card; the CPU tests call it with a
tiny cell on the CPU. The driver module named by the cell's traffic
(`harness/<driver>.py`) does the cell's work and returns its end-to-end
metrics, its trace summary (with `--trace 1`) and its check numbers.
"""

from __future__ import annotations

import gc
import importlib
import math
import time
from typing import Optional

import torch

from portbench.harness import check, common


class Context:
    """What a driver needs of the run and what it reports back."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool, device,
                 t0: float, bench_dir=common.BENCH_DIR):
        self.cell, self.seed, self.seconds, self.trace = cell, int(seed), seconds, trace
        self.device = torch.device(device)
        self.t0 = t0
        self.work = common.work_module(cell["config"], bench_dir)
        self.setup_s: Optional[float] = None
        self.memory_peak = 0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def phase(self, name: str) -> None:
        """Log the seconds since process start at the end of a set-up phase."""
        common.log(f"setup: {name} done at {time.perf_counter() - self.t0:.3f} s")

    def mark_setup_done(self) -> None:
        self.setup_s = time.perf_counter() - self.t0

    def read_memory_peak(self) -> None:
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def driver(cell: dict):
    return importlib.import_module(f"portbench.harness.{cell['traffic_spec']['driver']}")


def per_layer(cell: dict, summary: Optional[dict], bench_dir=common.BENCH_DIR) -> dict:
    """The per-layer metrics that read something in this run's summary."""
    out = {}
    if summary is None:
        return out
    kind = cell["traffic_spec"]["driver"]
    for name, mod in common.metric_modules(bench_dir).items():
        if mod.META["driver"] != kind:
            continue
        value = mod.read(summary)
        if value is not None and math.isfinite(value):
            out[name] = {"value": value, "unit": mod.META["unit"]}
    return out


def execute(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float,
            bench_dir=common.BENCH_DIR, **driver_kwargs) -> dict:
    ctx = Context(cell, seed, seconds, trace, device, t0, bench_dir)
    res = driver(cell).run(ctx, **driver_kwargs)
    limits = cell["limits"]
    correct = check.verdict(res["checks"], limits)
    if trace:
        metrics = per_layer(cell, res["summary"], bench_dir)
    else:
        metrics = dict(res["end_to_end"])
        metrics["setup_s"] = {"value": ctx.setup_s, "unit": "s"}
    kind = torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu", "kind": kind,
                   "count": cell["chips"], "memory_peak_bytes": ctx.memory_peak}
    result = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
              "metrics": metrics, "device": device_info}
    if trace and res["summary"] is not None:
        s = res["summary"]
        device_info["busy_s"] = s["busy_s"]
        device_info["window_s"] = s["window_s"]
        result["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    result["check"] = {k: {"value": res["checks"].get(k), "limit": lim}
                       for k, lim in limits.items()}
    result["_details"] = dict(res.get("details", {}), **{
        k: v for k, v in res["checks"].items() if k not in limits})
    return result
