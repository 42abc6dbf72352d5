"""TCM serving cells: one caller in a closed loop on
`CompressionPipeline(model_config=TCMConfig(...))`.

Set-up: TCM's float32 weights (`make_weights`) and a pool of uint8 photos
(serve_hific.photos) from the seed, made on the card; the pipeline built
from the weights (it makes TCM's serving form: GDN's effective
parameters, the cast to bf16 but the prior of z, the attention masks);
warm-up calls at the cell's batch. Window: call after call, numpy in and
numpy out, each call `batch` consecutive pool photos from a seeded offset
(serve.Plan), until `--seconds` have passed; the windows attended (plain
and shifted) and the slice steps a call are logged from the program's
counters where it has them. A seeded reservoir keeps `check_calls` of the
window's calls for the check that follows.

End-to-end: serve_img_per_s (photos decoded / window seconds) and
serve_call_p95_ms (95th percentile of every call, host clock).

The check, over the kept calls, image by image against the plain
reference (reference/tcm.py) in float32 with the program's bf16 roundings
(precision.BF16; none for a float32 configuration), TF32 off, on the
card one image at a time with the attention in chunks of windows. The
reference decodes the symbols the program sent (reference.serve's
`given`): slice by slice it forms its own mu, sigma and LRP from its
decoding of the program's earlier slices, so that a symbol flipped by
rounding order, which moves every later slice through SWAtten's windows,
is counted once. Held to limits (serve_hific.gaps):
  * decoded_far: the worst image's share of uint8 values more than 3
    levels from the reference's decoding of the program's symbols;
  * symbol_mismatch: the share of y and z symbols that differ (z: the
    reference's encoder; y: against the mu of that decoding);
  * bits_gap: the worst image's |bits - reference| / reference, the
    reference's bits of the program's symbols;
  * symbol_mismatch_free: y against the reference's own z and own chain,
    no input from the program;
read, not held to a limit: decoded_rmse, decoded_clipped (the program's
share of values at 0 or 255), sigma_at_bound (the reference's share of
scales at the lower bound 0.11).

Weights (`make_weights`, one uniform draw of the seed's codec stream):
kernels uniform with std gain / sqrt(fan in) (the residual branches' last
layers of BRANCH_OUTPUTS at BRANCH_GAIN), biases in +-0.05; LN's scale in
[0.75, 1.25] and shift in +-0.1; GDN's effective beta in [0.75, 1.25] and
gamma 0.1 I plus off-diagonal terms in [0, 1e-3], stored reparametrised;
relative-position biases in +-1; the image head at IMAGE_HEAD_GAIN with
biases 0.5 +- 0.05 and the scale heads at SCALE_HEAD_GAIN with biases
SCALE_HEAD_BIAS +- 0.4, so that neither images nor scales sit in their
clamps; the prior of z at TF-Compression's initial density, as
serve_hific.make_weights makes it.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import faults, inputs, serve_hific, trace
from portbench.harness.common import log
from portbench.harness.serve import Plan
from portbench.reference import tcm as ref_tcm
from portbench.reference.precision import FP8

BRANCH_GAIN = 0.3
BRANCH_OUTPUTS = ("conv1_2.weight", "conv_block.conv2.weight", "msa.linear.weight",
                  "mlp.2.weight")
IMAGE_HEAD_GAIN, SCALE_HEAD_GAIN, SCALE_HEAD_BIAS = 0.005, 0.1, 2.0
PEDESTAL = 2.0 ** -36
BPPS = (1.0,)  # the Plan's bpp draw; TCM takes none


def tcm_config(spec: dict):
    from contextual_image_compression_tpu_torch.config import TCMConfig

    return TCMConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in spec["model"].items()})


def _heads(m: dict):
    """The names of the image head's and the scale heads' last kernels."""
    g_s = len(ref_tcm._stages(m)[1]) - 1
    return f"g_s.{g_s}.0.", tuple(f"cc_scale_transforms.{i}.4." for i in range(m["num_slices"]))


@torch.no_grad()
def make_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 tensors for every name of reference/tcm.py's shape table
    (see the module docstring)."""
    shapes = ref_tcm.shapes(m)
    total = sum(math.prod(s) for s in shapes.values())
    draw = torch.rand(total, generator=inputs.generator(seed, "codec", device), device=device)
    layers = len(m["factorized_filters"]) + 1
    init_scale = 10.0 ** (1.0 / layers)
    dims = [1] + list(m["factorized_filters"]) + [1]
    image_head, scale_heads = _heads(m)
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        u = draw[off:off + n].view(shape)
        off += n
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("entropy_bottleneck."):
            if leaf.startswith("matrix"):
                k = int(leaf[len("matrix"):])
                centre = math.log(math.expm1(1.0 / init_scale / dims[k + 1]))
                out[name] = centre + (u - 0.5) * 0.1
            elif leaf.startswith("factor"):
                out[name] = (u - 0.5) * 0.1
            else:  # biases and offsets
                out[name] = u - 0.5
        elif leaf == "beta":
            out[name] = torch.sqrt(u * 0.5 + 0.75 + PEDESTAL)
        elif leaf == "gamma":
            eye = torch.eye(shape[0], device=device)
            out[name] = torch.sqrt(0.1 * eye + (1.0 - eye) * u * 1e-3 + PEDESTAL)
        elif leaf == "relative_position_params":
            out[name] = u * 2.0 - 1.0
        elif ".ln" in name:
            out[name] = u * 0.5 + 0.75 if leaf == "weight" else u * 0.2 - 0.1
        elif leaf == "weight":
            gain = BRANCH_GAIN if name.endswith(BRANCH_OUTPUTS) else 1.0
            if name.startswith(image_head):
                gain = IMAGE_HEAD_GAIN
            elif name.startswith(scale_heads):
                gain = SCALE_HEAD_GAIN
            fan_in = math.prod(shape[1:])
            out[name] = (u * 2.0 - 1.0) * gain * math.sqrt(3.0 / fan_in)
        elif name.startswith(image_head):
            out[name] = 0.45 + u * 0.1
        elif name.startswith(scale_heads):
            out[name] = SCALE_HEAD_BIAS - 0.4 + u * 0.8
        else:
            out[name] = u * 0.1 - 0.05
    return out


def _program_counts():
    """The program's window and slice counters, or None where it has none."""
    try:
        from contextual_image_compression_tpu_torch.models import tcm
    except ImportError:
        return None
    return getattr(tcm, "counts", None), getattr(tcm, "reset_counts", None)


def run(ctx, fault=None) -> dict:
    """fault: None, or a function (pipeline) -> None that breaks the timed
    path (FAULTS)."""
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    spec, traffic, dev = ctx.cell["config_spec"], ctx.cell["traffic_spec"], ctx.device
    cfg = tcm_config(spec)
    b, pool_n = traffic["batch"], traffic["pool"]

    ctx.phase("imports")
    weights = make_weights(spec["model"], ctx.seed, dev)
    pool = serve_hific.photos(ctx.seed, pool_n, traffic["height"], traffic["width"],
                              dev).cpu().numpy()
    ctx.phase("weights and photos")
    pipe = CompressionPipeline(state_dict=weights, model_config=cfg, device=dev)
    del weights
    ctx.phase("pipeline")
    if fault is not None:
        fault(pipe)
    plan = Plan(ctx.seed, pool_n, b, BPPS)
    for i in range(traffic["warmup_calls"]):
        s = int(plan.starts[-1 - i])
        pipe(pool[s:s + b])
        ctx.sync()
        ctx.phase(f"warm-up call {i}")
    ctx.mark_setup_done()
    count, reset = _program_counts() or (None, None)
    if reset is not None:
        reset()

    # ---- the window
    kept: List[dict] = []
    lat: List[float] = []
    k_keep = traffic["check_calls"]
    t_start = time.perf_counter()
    i = 0
    while True:
        s = int(plan.starts[i])
        t0 = time.perf_counter()
        decoded, info = pipe(pool[s:s + b])
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        rec = {"call": i, "start": s, "decoded": decoded, "y_symbols": info["y_symbols"],
               "z_symbols": info["z_symbols"], "bits": info["bits"]}
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
    if count is not None:
        log(f"program counters per call: {({k: v / n_calls for k, v in count().items()})}")
    e2e = {
        "serve_img_per_s": {"value": n_calls * b / window_s, "unit": "images/s"},
        "serve_call_p95_ms": {"value": 1e3 * float(np.percentile(lat, 95)), "unit": "ms"},
    }
    log(f"window: {n_calls} calls of {b} in {window_s:.3f} s; call ms median "
        f"{1e3 * float(np.median(lat)):.3f} p95 {e2e['serve_call_p95_ms']['value']:.3f}")

    summary = None
    if ctx.trace:
        summary = _traced_tail(ctx, pipe, pool, plan, n_calls, traffic, spec)
        summary["untraced"] = {"images": n_calls * b, "seconds": window_s}
    ctx.read_memory_peak()

    for rec in kept:  # to the host before the program's state is freed
        for key in ("y_symbols", "z_symbols", "bits"):
            rec[key] = rec[key].float().cpu()
    del pipe
    ctx.free()
    checks = check_tcm(ctx, kept, pool, spec)
    return {"attempted": n_calls, "failed": 0, "end_to_end": e2e, "summary": summary,
            "checks": checks}


def _traced_tail(ctx, pipe, pool, plan, start, traffic, spec) -> dict:
    from contextual_image_compression_tpu_torch.utils import profiling

    b = traffic["batch"]
    r = trace.Ranges()
    r.names.update(getattr(profiling, "SPANS", ()))
    r.names.add("serve.call")  # opened below, around each call

    def tail():
        for i in range(start, start + traffic["trace_calls"]):
            s = int(plan.starts[i])
            with torch.profiler.record_function("serve.call"):
                pipe(pool[s:s + b])

    try:
        summary = trace.profile(tail, r)
    finally:
        r.close()
    m, work = spec["model"], ctx.work
    h, w = traffic["height"], traffic["width"]
    flops, nbytes = work.swin(m, h, w)
    summary["work"] = {"flops_per_image": work.flops_per_image(m, h, w),
                       "swin_flops": b * flops, "swin_bytes": b * nbytes,
                       "peak_flops": spec["peak_flops"],
                       "peak_bytes_per_s": spec["peak_bytes_per_s"]}
    return summary


@torch.no_grad()
def reference_answers(params, m: dict, images_u8: torch.Tensor, rnd=None,
                      sent: List[dict] = None) -> List[dict]:
    """The reference's answer for each image of a call, on the host; `rnd`
    defaults to the program's roundings; `sent`: for each image the
    symbols another coder sent, which the reference decodes."""
    rnd = serve_hific.program_rounding(m) if rnd is None else rnd
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        for i, img in enumerate(images_u8):
            given = None
            if sent is not None:
                given = {k: sent[i][k][None].to(img.device) for k in ("y_symbols", "z_symbols")}
            r = ref_tcm.serve(params, m, img[None], rnd, given)
            out.append({k: r[k][0].cpu() for k in ("decoded", "y_symbols", "z_symbols")})
            out[-1].update(bits=float(r["bits"][0]), sigma_at_bound=float(r["sigma_at_bound"]))
            if "y_symbols_free" in r:
                out[-1]["y_symbols_free"] = r["y_symbols_free"][0].cpu()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def check_tcm(ctx, kept: List[dict], pool: np.ndarray, spec: dict) -> Dict[str, float]:
    """The reference over the kept calls, from the seed's float32 weights."""
    params = make_weights(spec["model"], ctx.seed, ctx.device)
    got, want = [], []
    for rec in kept:
        imgs = torch.from_numpy(pool[rec["start"]:rec["start"] + len(rec["decoded"])])
        sent = serve_hific._per_image(rec)
        want += reference_answers(params, spec["model"], imgs.to(ctx.device), sent=sent)
        got += sent
    return serve_hific.gaps(got, want)


def control(cell: dict, seed: int, dev) -> Dict[str, float]:
    """The reference in float8 (precision.FP8) put in the program's place,
    against the reference decoding its symbols, over as many calls as a
    run checks."""
    spec, traffic = cell["config_spec"], cell["traffic_spec"]
    m, b = spec["model"], traffic["batch"]
    pool = serve_hific.photos(seed, traffic["pool"], traffic["height"], traffic["width"], dev)
    plan = Plan(seed, traffic["pool"], b, BPPS)
    calls = np.random.default_rng([seed, 3]).choice(64, traffic["check_calls"], replace=False)
    params = make_weights(m, seed, dev)
    got, want = [], []
    for i in calls:
        imgs = pool[int(plan.starts[i]):int(plan.starts[i]) + b]
        sent = reference_answers(params, m, imgs, FP8)
        want += reference_answers(params, m, imgs, sent=sent)
        got += sent
    return serve_hific.gaps(got, want)


FAULTS = {"answer_altered": serve_hific.answer_altered, "half_batch": faults.serve_half_batch}
