"""HiFiC serving cells: one caller in a closed loop on
`CompressionPipeline(model_config=HiFiCConfig(...))`.

Set-up: HiFiC's float32 weights (`make_weights`) and a pool of uint8
photos (`photos`) from the seed, made on the card; the pipeline built from
the weights (it casts every layer but the prior of z to bf16); warm-up
calls at the cell's batch. Window: call after call, numpy in and numpy
out, each call `batch` consecutive pool photos from a seeded offset
(serve.Plan), until `--seconds` have passed. A seeded reservoir keeps
`check_calls` of the window's calls for the check that follows.

End-to-end: serve_img_per_s (photos decoded / window seconds) and
serve_call_p95_ms (95th percentile of every call, host clock).

The check, over the kept calls, image by image against the plain
reference (reference/hific.py) in float32 with the program's bf16
roundings (precision.BF16; none for a float32 configuration), TF32 off.
The reference decodes the symbols the program sent (reference.serve's
`given`): one z symbol flipped by rounding moves mu over a 15 x 15 patch
of y and with it hundreds of y symbols and thousands of pixels, so a
free-running comparison measures that amplification and not the
program's arithmetic (on an H100 at 2048x1536: 6.4-7.1% of symbols and
68-70% of values more than 3 levels off, against 40% and 81% for float8).
Held to limits:
  * decoded_far: the worst image's share of uint8 values more than 3
    levels from the reference's decoding of the program's symbols;
  * symbol_mismatch: the share of y and z symbols that differ (z: the
    reference's encoder; y: against the mu of the program's z);
  * bits_gap: the worst image's |bits - reference| / reference, the
    reference's bits of the program's symbols;
  * symbol_mismatch_free: as symbol_mismatch, but y against the
    reference's own z, so that no input of the reference comes from the
    program: the amplification above stays inside it, a wrong encoder or
    hyperprior does not;
read, not held to a limit: decoded_rmse (worst image, levels),
decoded_clipped (the program's share of values at 0 or 255),
sigma_at_bound (the reference's share of scales at the lower bound 0.11).

Weights (`make_weights`, one uniform draw of the seed's codec stream):
He-uniform kernels (std sqrt(2 / fan in), fan in Cin k^2, a quarter of it
for a stride-2 transposed convolution), biases in +-0.05, ChannelNorm's
scale in [0.75, 1.25] and shift in +-0.1; the image head at 0.15 of He
with biases 0.5 +- 0.05 and the sigma head at 0.15 of He with biases in
[0.8, 1.2], so that neither images nor scales sit in their clamps; the
prior of z at TF-Compression's initial density (init_scale 10, matrices
+-0.05 around it), biases and offsets in +-0.5, factors in +-0.05.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from portbench.harness import faults, inputs, trace
from portbench.harness.common import log
from portbench.harness.serve import Plan
from portbench.reference import hific as ref_hific
from portbench.reference.precision import BF16, FLOAT32, FP8

IMAGE_HEAD, SCALE_HEAD = "synthesis.out.", "hyper_scale.out."
BPPS = (1.0,)  # the Plan's bpp draw; HiFiC takes none


def hific_config(spec: dict):
    from contextual_image_compression_tpu_torch.config import HiFiCConfig

    return HiFiCConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in spec["model"].items()})


def _fan_in(name: str, shape) -> float:
    k = shape[2] * shape[3]
    if ".up" in name:  # stride-2 transposed convolution (Cin, Cout, k, k)
        return shape[0] * k / 4.0
    return shape[1] * k


@torch.no_grad()
def make_weights(m: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 tensors for every name of reference/hific.py's shape table
    (see the module docstring)."""
    shapes = ref_hific.shapes(m)
    total = sum(math.prod(s) for s in shapes.values())
    draw = torch.rand(total, generator=inputs.generator(seed, "codec", device), device=device)
    layers = len(m["factorized_filters"]) + 1
    init_scale = 10.0 ** (1.0 / layers)
    dims = [1] + list(m["factorized_filters"]) + [1]
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        u = draw[off:off + n].view(shape)
        off += n
        leaf = name.rsplit(".", 1)[-1]
        if name.startswith("z_prior."):
            if leaf.startswith("matrix"):
                k = int(leaf[len("matrix"):])
                centre = math.log(math.expm1(1.0 / init_scale / dims[k + 1]))
                out[name] = centre + (u - 0.5) * 0.1
            elif leaf.startswith("factor"):
                out[name] = (u - 0.5) * 0.1
            else:  # biases and offsets
                out[name] = u - 0.5
        elif "norm" in name:  # ChannelNorm
            out[name] = u * 0.5 + 0.75 if leaf == "weight" else u * 0.2 - 0.1
        elif leaf == "weight":
            gain = 0.15 if name.startswith((IMAGE_HEAD, SCALE_HEAD)) else 1.0
            half = gain * math.sqrt(6.0 / _fan_in(name, shape))
            out[name] = (u * 2.0 - 1.0) * half
        elif name.startswith(IMAGE_HEAD):
            out[name] = 0.45 + u * 0.1
        elif name.startswith(SCALE_HEAD):
            out[name] = 0.8 + u * 0.4
        else:
            out[name] = u * 0.1 - 0.05
    return out


@torch.no_grad()
def photos(seed: int, n: int, height: int, width: int, device, chunk: int = 4) -> torch.Tensor:
    """(n, height, width, 3) uint8 photos from the seed's image stream: the
    recipe of inputs.structured_images (three soft blobs, an edge, a little
    texture) at the photos' own aspect."""
    gen = inputs.generator(seed, "images", device)
    yy = (torch.arange(height, device=device, dtype=torch.float32) / height)[:, None]
    xx = (torch.arange(width, device=device, dtype=torch.float32) / width)[None, :]
    outs = []
    for start in range(0, n, chunk):
        b = min(chunk, n - start)
        blobs = torch.rand((b, 3, 3), generator=gen, device=device)
        colours = torch.rand((b, 3, 3), generator=gen, device=device)
        angle = torch.rand((b,), generator=gen, device=device) * 6.0
        edge_colour = torch.rand((b, 3), generator=gen, device=device)
        img = 0.05 * torch.rand((b, height, width, 3), generator=gen, device=device)
        for k in range(3):
            cy, cx = blobs[:, k, 0, None, None], blobs[:, k, 1, None, None]
            r = blobs[:, k, 2, None, None] * 0.2 + 0.05
            blob = torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r))
            img = img + blob[..., None] * colours[:, k, None, None, :]
        edge = (xx * torch.cos(angle)[:, None, None] + yy * torch.sin(angle)[:, None, None]) > 0.3
        img = img + edge[..., None] * edge_colour[:, None, None, :] * 0.4
        img = img / img.amax(dim=(1, 2, 3), keepdim=True)
        outs.append((img * 255).to(torch.uint8))
    return torch.cat(outs)


def run(ctx, fault=None) -> dict:
    """fault: None, or a function (pipeline) -> None that breaks the timed
    path (FAULTS)."""
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    spec, traffic, dev = ctx.cell["config_spec"], ctx.cell["traffic_spec"], ctx.device
    cfg = hific_config(spec)
    b, pool_n = traffic["batch"], traffic["pool"]

    ctx.phase("imports")
    weights = make_weights(spec["model"], ctx.seed, dev)
    pool = photos(ctx.seed, pool_n, traffic["height"], traffic["width"], dev).cpu().numpy()
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
    checks = check_hific(ctx, kept, pool, spec)
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
    flops, nbytes = work.resblocks(m, h, w)
    summary["work"] = {"flops_per_image": work.flops_per_image(m, h, w),
                       "resblock_flops": b * flops, "resblock_bytes": b * nbytes,
                       "peak_flops": spec["peak_flops"],
                       "peak_bytes_per_s": spec["peak_bytes_per_s"]}
    return summary


def program_rounding(m: dict):
    """The reference's roundings that follow the configuration's dtype."""
    return BF16 if m["dtype"] == "bfloat16" else FLOAT32


@torch.no_grad()
def reference_answers(params, m: dict, images_u8: torch.Tensor, rnd=None,
                      sent: List[dict] = None) -> List[dict]:
    """The reference's answer for each image of a call, on the host; `rnd`
    defaults to the program's roundings; `sent`: for each image the
    symbols another coder sent, which the reference decodes."""
    rnd = program_rounding(m) if rnd is None else rnd
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = []
        for i, img in enumerate(images_u8):
            given = None
            if sent is not None:
                given = {k: sent[i][k][None].to(img.device) for k in ("y_symbols", "z_symbols")}
            r = ref_hific.serve(params, m, img[None], rnd, given)
            out.append({k: r[k][0].cpu() for k in ("decoded", "y_symbols", "z_symbols")})
            out[-1].update(bits=float(r["bits"][0]), sigma_at_bound=float(r["sigma_at_bound"]))
            if "y_symbols_free" in r:
                out[-1]["y_symbols_free"] = r["y_symbols_free"][0].cpu()
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def gaps(got: List[dict], want: List[dict]) -> Dict[str, float]:
    """got / want: one dict per image (decoded (H, W, 3) uint8, y_symbols,
    z_symbols, bits)."""
    far = rmse = bits_gap = clipped = sigma = 0.0
    differ = differ_free = total = 0
    for g, w in zip(got, want):
        d = (g["decoded"].float() - w["decoded"].float()).flatten()
        far = max(far, float((d.abs() > 3).float().mean()))
        rmse = max(rmse, float(torch.sqrt((d * d).mean())))
        z_differ = int((g["z_symbols"].float() != w["z_symbols"]).sum())
        differ += z_differ + int((g["y_symbols"].float() != w["y_symbols"]).sum())
        free = w.get("y_symbols_free", w["y_symbols"])
        differ_free += z_differ + int((g["y_symbols"].float() != free).sum())
        total += g["z_symbols"].numel() + g["y_symbols"].numel()
        bits_gap = max(bits_gap, abs(g["bits"] - w["bits"]) / max(abs(w["bits"]), 1e-30))
        dec = g["decoded"]
        clipped = max(clipped, float(((dec == 0) | (dec == 255)).float().mean()))
        sigma = max(sigma, w["sigma_at_bound"])
    return {"decoded_far": far, "symbol_mismatch": differ / max(total, 1), "bits_gap": bits_gap,
            "symbol_mismatch_free": differ_free / max(total, 1), "decoded_rmse": rmse,
            "decoded_clipped": clipped, "sigma_at_bound": sigma}


def _per_image(rec: dict) -> List[dict]:
    return [{"decoded": torch.as_tensor(rec["decoded"][i]), "y_symbols": rec["y_symbols"][i],
             "z_symbols": rec["z_symbols"][i], "bits": float(rec["bits"][i])}
            for i in range(len(rec["decoded"]))]


def check_hific(ctx, kept: List[dict], pool: np.ndarray, spec: dict) -> Dict[str, float]:
    """The reference over the kept calls, from the seed's float32 weights."""
    params = make_weights(spec["model"], ctx.seed, ctx.device)
    got, want = [], []
    for rec in kept:
        imgs = torch.from_numpy(pool[rec["start"]:rec["start"] + len(rec["decoded"])])
        sent = _per_image(rec)
        want += reference_answers(params, spec["model"], imgs.to(ctx.device), sent=sent)
        got += sent
    return gaps(got, want)


def control(cell: dict, seed: int, dev) -> Dict[str, float]:
    """The reference in float8 (precision.FP8) put in the program's place,
    against the reference decoding its symbols, over as many calls as a
    run checks."""
    spec, traffic = cell["config_spec"], cell["traffic_spec"]
    m, b = spec["model"], traffic["batch"]
    pool = photos(seed, traffic["pool"], traffic["height"], traffic["width"], dev)
    plan = Plan(seed, traffic["pool"], b, BPPS)
    calls = np.random.default_rng([seed, 3]).choice(64, traffic["check_calls"], replace=False)
    params = make_weights(m, seed, dev)
    got, want = [], []
    for i in calls:
        imgs = pool[int(plan.starts[i]):int(plan.starts[i]) + b]
        sent = reference_answers(params, m, imgs, FP8)
        want += reference_answers(params, m, imgs, sent=sent)
        got += sent
    return gaps(got, want)


def answer_altered(pipe) -> None:
    """The first photo of every call decoded inverted and its first y
    symbol moved by one."""
    run = pipe._run

    def altered(imgs, bpp):
        decoded, info = run(imgs, bpp)
        decoded = decoded.clone()
        decoded[0] = 255 - decoded[0]
        info = dict(info)
        info["y_symbols"] = info["y_symbols"].clone()
        info["y_symbols"][0, 0, 0, 0] += 1.0
        return decoded, info

    pipe._run = altered


FAULTS = {"answer_altered": answer_altered, "half_batch": faults.serve_half_batch}
