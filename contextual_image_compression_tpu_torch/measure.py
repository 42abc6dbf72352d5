"""Helpers of the scripts that run the port on the card (`chip_smoke.py`,
`scripts/torch_pipeline_profile.py`): the card's name and power limit,
CUDA-event timing, and seeded inputs and statistics for a full-width run.
"""

from __future__ import annotations

import math
import subprocess
import time

import numpy as np
import torch


def card_name_and_power() -> str:
    """The first card as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` prints it, e.g. 'NVIDIA H100 80GB HBM3, 700.00 W'."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one fn() in milliseconds: CUDA events around
    fn() while the card is held busy (`torch.cuda._sleep`, 1.5 times the host
    time of one call) so that the host enqueues the call before the start
    event fires. The host's launch overhead (Python, the wrapper, ctypes) thus
    stays out of the sample, which `event_ms` counts in; a fn that
    synchronizes inside counts it all the same."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(1.5 * host_s, 1e-3) * 2.0e9)  # SM clock below 2 GHz
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def structured_images(rng: np.random.RandomState, b: int, size: int) -> np.ndarray:
    """(b, size, size, 3) uint8 images with blobs, edges and a little texture."""
    yy, xx = np.mgrid[0:size, 0:size] / size
    out = []
    for _ in range(b):
        img = np.zeros((size, size, 3))
        for _ in range(3):
            cy, cx, r = rng.rand(3) * [1, 1, 0.2] + [0, 0, 0.05]
            img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))[..., None] * rng.rand(3)
        img += (xx * math.cos(rng.rand() * 6) + yy * math.sin(rng.rand() * 6) > 0.3)[..., None] * rng.rand(3) * 0.4
        img += 0.05 * rng.rand(size, size, 3)
        out.append(img / img.max())
    return (np.stack(out) * 255).astype(np.uint8)


def randomize_stats(codec: torch.nn.Module, seed: int) -> None:
    """SAGAN gamma 0.5 (it initializes to 0, which hides attention) and
    non-trivial BatchNorm statistics, made from a seed."""
    from contextual_image_compression_tpu_torch.models.layers import KBatchNorm

    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in codec.modules():
            if isinstance(mod, KBatchNorm):
                c = mod.weight.shape[0]
                for t, v in ((mod.running_mean, torch.randn(c, generator=gen) * 0.1),
                             (mod.running_var, torch.rand(c, generator=gen) * 0.5 + 0.75),
                             (mod.weight, torch.rand(c, generator=gen) * 0.5 + 0.75),
                             (mod.bias, torch.randn(c, generator=gen) * 0.05)):
                    t.copy_(v.to(t.dtype))
        codec.hq_encoder.attention.gamma.fill_(0.5)
