"""The traced tail of a `--trace 1` run and its reduction to a summary.

Ranges are opened from the benchmark's side only: an instance method
wrapped in `record_function`, or a module's forward between a pre-hook and
a hook. After the untraced window, `profile(fn)` runs fn under
`torch.profiler` (CPU and CUDA activities) inside one range,
`portbench.window`, exports the Chrome trace to the run's TMPDIR, reads it
and deletes it. The summary holds:

  * ranges: for each range name, its instances and the device seconds of
    the operations (kernels, copies, memsets) launched inside them, a
    launch being inside when its runtime call's host time falls in the
    range's host interval (any host thread: autograd's backward launches
    from its own);
  * window_s: the window range's length; busy_s: the union of device
    operations inside it;
  * device_ops: the 10 operation names with the most device time;
  * idle_gaps: device idle time inside the window, by the innermost range
    open on the host at the middle of each gap, the 10 largest.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List

import torch

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Ranges:
    """Ranges installed on the program's objects, removed by `close()`."""

    def __init__(self):
        self._undo: List[Callable[[], None]] = []
        self.names: set = set()

    def method(self, obj, attr: str, name: str) -> None:
        orig = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return orig(*args, **kwargs)

        setattr(obj, attr, wrapped)
        self.names.add(name)
        self._undo.append(lambda: delattr(obj, attr))

    def module(self, mod: torch.nn.Module, name: str) -> None:
        stack: list = []

        def pre(_m, _args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            stack.append(rf)

        def post(_m, _args, _out):
            stack.pop().__exit__(None, None, None)

        handles = [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
        self.names.add(name)
        self._undo.append(lambda: [h.remove() for h in handles])

    def close(self) -> None:
        while self._undo:
            self._undo.pop()()


def profile(fn: Callable[[], None], ranges: Ranges) -> dict:
    """Run fn under the profiler, then a synchronize, and return the
    summary of its trace over the names of `ranges`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return summarize(events, ranges.names)


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(events: List[dict], names) -> dict:
    """Reduce Chrome-trace events (ts and dur in microseconds) to the
    summary of the module docstring, in seconds; `names`: the ranges the
    benchmark opened (the profiler records others, the optimizers' own)."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    window = [e for e in xs if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    if not window:
        raise ValueError("the trace holds no window range")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    device = [e for e in xs if e.get("cat") in DEVICE_CATS]
    ranges = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") in names]

    # device seconds of the operations launched inside each range
    launched = sorted((launches[e["args"]["correlation"]], float(e["dur"]))
                      for e in device if e.get("args", {}).get("correlation") in launches)
    times = [t for t, _ in launched]
    prefix = [0.0]
    for _, d in launched:
        prefix.append(prefix[-1] + d)
    per_range: Dict[str, dict] = defaultdict(lambda: {"count": 0, "device_s": 0.0})
    for r in ranges:
        a, b = float(r["ts"]), float(r["ts"]) + float(r["dur"])
        i, j = bisect.bisect_left(times, a), bisect.bisect_right(times, b)
        per_range[r["name"]]["count"] += 1
        per_range[r["name"]]["device_s"] += (prefix[j] - prefix[i]) * 1e-6

    inside = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
              for e in device]
    busy = _merge([iv for iv in inside if iv[1] > iv[0]])
    busy_us = sum(b - a for a, b in busy)

    by_name: Dict[str, float] = defaultdict(float)
    for e in device:
        if w0 <= float(e["ts"]) <= w1:
            by_name[e["name"][:160]] += float(e["dur"]) * 1e-6
    gaps = []
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    spans = sorted((float(r["ts"]), float(r["ts"]) + float(r["dur"]), r["name"]) for r in ranges)
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        open_ = [s for s in spans if s[0] <= mid <= s[1]]
        name = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else "outside every range"
        idle[name] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {
        "ranges": dict(per_range),
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device_ops": top(by_name),
        "idle_gaps": top(idle),
    }
