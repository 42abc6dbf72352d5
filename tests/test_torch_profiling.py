"""The port's utils/profiling.py against the JAX package's on the CPU: the
step timer on one sequence of calls under a patched clock, the benchmark's
keys, and the trace and annotate contexts (a Chrome trace file holding the
annotated region)."""

import json
import os

import pytest
import torch

from contextual_image_compression_tpu.utils import profiling as jprof
from contextual_image_compression_tpu_torch.utils import profiling as tprof


class _Clock:
    def __init__(self, ticks):
        self.ticks = list(ticks)

    def __call__(self):
        return self.ticks.pop(0)


def _drive(mod, monkeypatch):
    """start/stop pairs (one stop without a start, one reset) on a clock
    that reads 0.0, 0.25, 1.0, 1.5, 4.0, 4.125, 10.0, 10.5."""
    monkeypatch.setattr(mod.time, "perf_counter", _Clock([0.0, 0.25, 1.0, 1.5, 4.0, 4.125,
                                                          10.0, 10.5]))
    t = mod.StepTimer()
    seen = [(t.steps, t.images, t.elapsed)]
    t.stop(7)  # no start: ignored
    for images in (16, 16, 8):
        t.start()
        t.stop(images)
        seen.append((t.steps, t.images, t.elapsed, t.images_per_sec, t.sec_per_step))
    t.reset()
    seen.append((t.steps, t.images, t.elapsed))
    t.start()
    t.stop(4)
    seen.append((t.steps, t.images, t.elapsed, t.images_per_sec, t.sec_per_step))
    return seen


def test_step_timer_matches_jax(monkeypatch):
    want = _drive(jprof, monkeypatch)
    got = _drive(tprof, monkeypatch)
    assert got == want
    t = tprof.StepTimer()
    assert t.images_per_sec != t.images_per_sec and t.sec_per_step != t.sec_per_step  # nan


def test_benchmark_has_jax_keys():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": x * 2, "parts": (x + 1, [x - 1])}

    got = tprof.benchmark(fn, torch.ones(4), warmup=1, iters=3)
    want = jprof.benchmark(lambda x: x * 2, 1.0, warmup=1, iters=3)
    assert set(got) == set(want) == {"sec_per_call", "calls_per_sec"}
    assert len(calls) == 4 and got["sec_per_call"] > 0
    assert got["calls_per_sec"] == pytest.approx(1.0 / got["sec_per_call"])


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    log_dir = tmp_path / "trace"
    with tprof.trace(str(log_dir)) as prof:
        with tprof.annotate("port_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert isinstance(prof, torch.profiler.profile)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].startswith("torch_trace_") and files[0].endswith(".json")
    events = json.loads((log_dir / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "port_region" for e in events)
