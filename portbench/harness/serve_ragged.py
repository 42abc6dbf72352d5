"""Ragged serving cells: one caller in a closed loop on the GAN
`CompressionPipeline`, each call carrying its own number of images.

Set-up: as harness/serve.py (the codec's float32 weights and a pool of
uint8 images from the seed, the pipeline built from the weights), then one
warm-up call at each batch size of `warmup_batches` (1, 2, 4, 8, 16), so
that every bucket `_padded_batch` pads to is run before the window. Window:
call after call, numpy in and numpy out, each call b consecutive pool
images from a seeded offset (serve.Plan at `max_batch`) and a seeded target
bpp, b drawn from 1..max_batch with P(b) proportional to 1 / b (`sizes`),
until `--seconds` have passed. A seeded reservoir keeps `check_calls` of
the window's calls for the check (serve.check_serving, the GAN serving
cells' check and limits).

The pipeline's counters (images served, padding images added, padded
batch sizes run for the first time) are read with getattr, so that a
program without them runs the cell and only the metrics that read them
(`padded_pct`, `mfu`) read nothing; the window's counts are the summary's
`untraced` `counters`, and the traced tail's its `counters`.

End-to-end: serve_img_per_s (images decoded / window seconds) and
serve_call_p95_ms (95th percentile of every call, host clock).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from portbench.harness import inputs, trace
from portbench.harness.common import log
from portbench.harness.serve import Plan, check_serving, model_config
from portbench.reference import codec as ref_codec


def sizes(seed: int, max_batch: int, n: int = 1 << 16) -> np.ndarray:
    """The seed's batch sizes, 1..max_batch with P(b) proportional to 1 / b."""
    b = np.arange(1, max_batch + 1)
    p = (1.0 / b) / (1.0 / b).sum()
    return np.random.default_rng([int(seed), 4]).choice(b, size=n, p=p)


def _counts(pipe):
    """The pipeline's counters, or None where it has none."""
    count = getattr(pipe, "counts", None)
    return count() if callable(count) else None


def _reset(pipe) -> None:
    reset = getattr(pipe, "reset_counts", None)
    if callable(reset):
        reset()


def run(ctx, fault=None) -> dict:
    """fault: None, or a function (pipeline) -> None that breaks the timed
    path (harness/faults.py)."""
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    spec, traffic, dev = ctx.cell["config_spec"], ctx.cell["traffic_spec"], ctx.device
    m = spec["model"]
    mcfg, scfg = model_config(spec)
    top, pool_n = traffic["max_batch"], traffic["pool"]

    ctx.phase("imports")
    weights = inputs.make_weights(ref_codec.codec_shapes(m), ctx.seed, "codec", dev)
    pool = inputs.structured_images(ctx.seed, pool_n, m["img_size"][0], dev).cpu().numpy()
    ctx.phase("weights and images")
    pipe = CompressionPipeline(state_dict=weights, model_config=mcfg, saliency_config=scfg,
                               device=dev)
    del weights
    ctx.phase("pipeline")
    if fault is not None:
        fault(pipe)
    plan = Plan(ctx.seed, pool_n, top, traffic["bpps"])
    batch = sizes(ctx.seed, top)
    for i, b in enumerate(traffic["warmup_batches"]):
        s = int(plan.starts[-1 - i])
        pipe(pool[s:s + b], target_bpp=float(plan.bpps[-1 - i]))
        ctx.sync()
        ctx.phase(f"warm-up call {i} (batch {b})")
    ctx.mark_setup_done()
    _reset(pipe)

    # ---- the window
    kept: List[dict] = []
    lat: List[float] = []
    k_keep = traffic["check_calls"]
    images = 0
    t_start = time.perf_counter()
    i = 0
    while True:
        s, bpp, b = int(plan.starts[i]), float(plan.bpps[i]), int(batch[i])
        t0 = time.perf_counter()
        decoded, info = pipe(pool[s:s + b], target_bpp=bpp)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        images += b
        rec = {"call": i, "start": s, "bpp": bpp, "decoded": decoded,
               "hq_symbols": info["hq_symbols"], "lq_symbols": info["lq_symbols"],
               "mask": info["mask"]}
        if len(kept) < k_keep:  # reservoir sampling over the window's calls
            kept.append(rec)
        else:
            j = int(plan.keep_rng.integers(0, i + 1))
            if j < k_keep:
                kept[j] = rec
        i += 1
        if t1 - t_start >= ctx.seconds:
            break
    window_s = time.perf_counter() - t_start
    n_calls = i
    window_counts = _counts(pipe)
    log(f"window counters: {window_counts}")
    e2e = {
        "serve_img_per_s": {"value": images / window_s, "unit": "images/s"},
        "serve_call_p95_ms": {"value": 1e3 * float(np.percentile(lat, 95)), "unit": "ms"},
    }
    log(f"window: {n_calls} calls, {images} images ({images / n_calls:.3f} a call) in "
        f"{window_s:.3f} s; call ms median {1e3 * float(np.median(lat)):.3f} p95 "
        f"{e2e['serve_call_p95_ms']['value']:.3f}")

    summary = None
    if ctx.trace:
        summary = _traced_tail(ctx, pipe, pool, plan, batch, n_calls, traffic, spec)
        summary["untraced"] = {"images": images, "seconds": window_s,
                               "counters": window_counts}
    ctx.read_memory_peak()

    for rec in kept:  # to the host before the program's state is freed
        for key in ("hq_symbols", "lq_symbols", "mask"):
            rec[key] = rec[key].float().cpu()
    del pipe
    ctx.free()
    checks = check_serving(ctx, kept, pool, spec)
    return {"attempted": n_calls, "failed": 0, "end_to_end": e2e, "summary": summary,
            "checks": checks}


def _traced_tail(ctx, pipe, pool, plan, batch, start, traffic, spec) -> dict:
    from contextual_image_compression_tpu_torch.utils import profiling

    r = trace.Ranges()
    r.names.update(getattr(profiling, "SPANS", ()))
    r.names.add("serve.call")  # opened below, around each call
    r.method(pipe.codec, "apply", "codec.apply")
    _reset(pipe)

    def tail():
        for i in range(start, start + traffic["trace_calls"]):
            s, b = int(plan.starts[i]), int(batch[i])
            with torch.profiler.record_function("serve.call"):
                pipe(pool[s:s + b], target_bpp=float(plan.bpps[i]))

    try:
        summary = trace.profile(tail, r)
    finally:
        r.close()
    summary["counters"] = _counts(pipe)
    log(f"traced tail counters: {summary['counters']}")
    summary["work"] = {"flops_per_image": ctx.work.flops_per_image(spec["model"]),
                       "peak_flops": spec["peak_flops"]}
    return summary
