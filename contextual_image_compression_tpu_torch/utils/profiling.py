"""Tracing and throughput measurement, the counterpart of the JAX package's
`utils/profiling.py`: a `torch.profiler` trace context that writes a Chrome
trace (viewable in Perfetto or chrome://tracing), the program's named spans
inside it, a step timer with images/sec accounting, and a wall-clock
benchmark of a function.

Spans: `annotate(name)` opens `torch.profiler.record_function(name)` while
a torch profiler records (`trace`, or any other on the calling thread), so
the span lands in the same Chrome trace, on the same clock, as the card's
kernels, copies and runtime calls, and the device's idle gaps can be put
down to the span open on the host. With no profiler it returns a shared
null context after one C call. `SPANS` names every span the program opens.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the host's operators and, where CUDA is available, the card's
    kernels; on exit write `torch_trace_<pid>_<ms>.json` (Chrome trace
    format) into log_dir. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"torch_trace_{os.getpid()}_{int(time.time() * 1000)}.json"))


SPANS = (
    # serve.py, CompressionPipeline.__call__ end to end
    "pipeline.upload", "pipeline.mask", "pipeline.codec", "pipeline.symbols",
    "pipeline.download",
    # models/adaptive.py, AdaptiveCodec.apply end to end; models/attention.py
    "codec.encode", "codec.plan", "codec.quantize", "codec.generate", "codec.attention",
    # train/gan_trainer.py, inside GANStepBuilder.g_backward; step.allreduce
    # around each gradient reduction on a mesh (D's in d_phase too)
    "step.losses", "step.perceptual", "step.backward", "step.allreduce",
    # data/pipeline.py, CompressionDataset.epoch
    "data.batch",
    # models/hific.py, HiFiCCodec.apply: E, the hyperprior, G; the residual
    # blocks inside G; each ChannelNorm
    "hific.analysis", "hific.hyper", "hific.synthesis", "hific.resblocks", "hific.norm",
    # models/tcm.py, TCMCodec.apply: g_a, the hyperprior, the slice chain, g_s;
    # each windowed attention Block wherever it sits
    "tcm.analysis", "tcm.hyper", "tcm.slices", "tcm.synthesis", "tcm.swin",
)

_OFF = contextlib.nullcontext()
_profiler_enabled = torch._C._autograd._profiler_enabled


def annotate(name: str) -> contextlib.AbstractContextManager:
    """Named span inside a profiler trace; a shared null context when no
    profiler records."""
    if not _profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock throughput meter (host-side; the caller waits for the
    device's results before `stop`)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0: Optional[float] = None
        self.steps = 0
        self.images = 0
        self.elapsed = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, batch_images: int = 0):
        if self._t0 is None:
            return
        self.elapsed += time.perf_counter() - self._t0
        self.steps += 1
        self.images += batch_images
        self._t0 = None

    @property
    def images_per_sec(self) -> float:
        return self.images / self.elapsed if self.elapsed > 0 else float("nan")

    @property
    def sec_per_step(self) -> float:
        return self.elapsed / self.steps if self.steps else float("nan")


def _wait_for(out) -> None:
    """Wait until the devices of the tensors in `out` (nested tuples, lists
    and dicts) have computed them."""
    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(out)
    for dev in devices:
        torch.cuda.synchronize(dev)


def benchmark(fn: Callable, *args, warmup: int = 2, iters: int = 10) -> Dict[str, float]:
    """Time fn(*args) on the host clock, waiting for each call's tensor
    outputs on their devices."""
    for _ in range(warmup):
        _wait_for(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        _wait_for(fn(*args))
    dt = (time.perf_counter() - t0) / iters
    return {"sec_per_call": dt, "calls_per_sec": 1.0 / dt if dt > 0 else float("inf")}
