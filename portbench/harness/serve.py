"""Serving cells: one caller in a closed loop on `CompressionPipeline`.

Set-up: the codec's float32 weights and a pool of uint8 images from the
seed, made on the card; the pipeline built from the weights (it quantizes
the w8 rows, casts to bf16 and prepares its tail itself); warm-up calls at
the cell's batch. Window: call after call, numpy in and numpy out, each
call `batch` consecutive pool images from an offset and a target bpp drawn
from the seed, until `--seconds` have passed. A seeded reservoir keeps
`check_calls` of the window's calls (their decoded images, symbols and
masks) for the check that follows the window.

End-to-end: serve_img_per_s (images decoded / window seconds) and
serve_call_p95_ms (95th percentile of every call, host clock).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import check, inputs, trace
from portbench.harness.common import log
from portbench.reference import codec as ref_codec


def model_config(spec: dict):
    from contextual_image_compression_tpu_torch.config import (
        ModelConfig,
        QuantizerConfig,
        SaliencyConfig,
    )

    def tuples(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    m = dict(tuples(spec["model"]), quantizer=QuantizerConfig(**spec["model"]["quantizer"]))
    return ModelConfig(**m), SaliencyConfig(**tuples(spec["saliency"]))


class Plan:
    """The seed's call sequence: pool offsets and target bpps."""

    def __init__(self, seed: int, pool: int, batch: int, bpps, n: int = 1 << 16):
        rng = np.random.default_rng([int(seed), 1])
        self.starts = rng.integers(0, pool - batch + 1, size=n)
        self.bpps = rng.choice(np.asarray(bpps, np.float64), size=n)
        self.keep_rng = np.random.default_rng([int(seed), 2])


def run(ctx, fault=None) -> dict:
    """fault: None, or a function (pipeline) -> None that breaks the timed
    path (harness/faults.py)."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    spec, traffic, dev = ctx.cell["config_spec"], ctx.cell["traffic_spec"], ctx.device
    m = spec["model"]
    mcfg, scfg = model_config(spec)
    b, pool_n = traffic["batch"], traffic["pool"]

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
    plan = Plan(ctx.seed, pool_n, b, traffic["bpps"])
    for i in range(traffic["warmup_calls"]):
        pipe(pool[plan.starts[-1 - i]:plan.starts[-1 - i] + b], target_bpp=plan.bpps[-1 - i])
        ctx.sync()
        ctx.phase(f"warm-up call {i}")
    ctx.mark_setup_done()

    # ---- the window
    ops.reset_launch_counts()
    kept: List[dict] = []
    lat: List[float] = []
    k_keep = traffic["check_calls"]
    t_start = time.perf_counter()
    i = 0
    while True:
        s, bpp = int(plan.starts[i]), float(plan.bpps[i])
        t0 = time.perf_counter()
        decoded, info = pipe(pool[s:s + b], target_bpp=bpp)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
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
    launches = {k: v / n_calls for k, v in ops.launch_counts().items() if v}
    log(f"launches per call: {launches}")
    e2e = {
        "serve_img_per_s": {"value": n_calls * b / window_s, "unit": "images/s"},
        "serve_call_p95_ms": {"value": 1e3 * float(np.percentile(lat, 95)), "unit": "ms"},
    }
    log(f"window: {n_calls} calls of {b} in {window_s:.3f} s; call ms median "
        f"{1e3 * float(np.median(lat)):.3f} p95 {e2e['serve_call_p95_ms']['value']:.3f}")

    summary = None
    if ctx.trace:
        summary = _traced_tail(ctx, pipe, pool, plan, n_calls, traffic, m, spec)
        summary["untraced"] = {"images": n_calls * b, "seconds": window_s}
    ctx.read_memory_peak()

    for rec in kept:  # to the host before the program's state is freed
        for key in ("hq_symbols", "lq_symbols", "mask"):
            rec[key] = rec[key].float().cpu()
    del pipe
    ctx.free()
    checks = check_serving(ctx, kept, pool, spec)
    return {"attempted": n_calls, "failed": 0, "end_to_end": e2e, "summary": summary,
            "checks": checks}


def _traced_tail(ctx, pipe, pool, plan, start, traffic, m, spec) -> dict:
    b = traffic["batch"]
    r = trace.Ranges()
    r.names.add("serve.call")  # opened below, around each call
    r.method(pipe.codec, "apply", "codec.apply")
    r.module(pipe.codec.hq_encoder.attention, "hq_attention")

    def tail():
        for i in range(start, start + traffic["trace_calls"]):
            s = int(plan.starts[i])
            with torch.profiler.record_function("serve.call"):
                pipe(pool[s:s + b], target_bpp=float(plan.bpps[i]))

    try:
        summary = trace.profile(tail, r)
    finally:
        r.close()
    work = ctx.work
    flops, nbytes = work.attention(m, b)
    summary["work"] = {"flops_per_image": work.flops_per_image(m),
                       "attention_flops": flops, "attention_bytes": nbytes,
                       "peak_flops": spec["peak_flops"],
                       "peak_bytes_per_s": spec["peak_bytes_per_s"]}
    return summary


def check_serving(ctx, kept: List[dict], pool: np.ndarray, spec: dict) -> Dict[str, float]:
    """The reference over the kept calls, from the seed's float32 weights;
    the worst image's gaps (harness/check.py)."""
    m = spec["model"]
    dev = ctx.device
    sd = inputs.make_weights(ref_codec.codec_shapes(m), ctx.seed, "codec", dev)
    params, tails = ref_codec.serving_params(sd, m)
    del sd
    got, want = [], []
    for rec in kept:
        imgs = torch.from_numpy(pool[rec["start"]:rec["start"] + len(rec["decoded"])]).to(dev)
        want.append(check.serving_reference(params, tails, spec, imgs, rec["bpp"]))
        got.append({"decoded": torch.from_numpy(rec["decoded"]), "mask": rec["mask"],
                    "hq_symbols": rec["hq_symbols"], "lq_symbols": rec["lq_symbols"]})
    return check.serving_gaps(got, want)

