"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from contextual_image_compression_tpu_torch/csrc
   and its range coder (g++) from contextual_image_compression_tpu_torch/native,
   printing each kernel's registers and spills (and failing if a K2 / K6
   tensor-core kernel, bf16 or float32, spills, or if it or K8's float32
   kernel starts at other than the 168 registers its setmaxnreg split deals
   out);
3. holds the serving kernels (K1 contextual mask, K2 attention block, K3 quantizer)
   against its plain PyTorch twin on the card at the serving path's shapes
   (B = 16, 256^2, D = 512) and times kernel, twin and, where one exists, a
   library call with CUDA events (`measure.event_ms`: the host's launch
   inside, as a caller pays it) and on the device alone (`measure.device_ms`,
   K1-K3); K2 also beside the library call timed the same way, in float32
   (the "tf32x3" route: three TF32 passes on the tensor cores) beside the
   float32 library calls (TF32 off) and the float32 bound, and with the share
   of bf16 outputs bit-identical to the twin. K1 must take the cluster route at 256^2, run one
   kernel and no memset per call (torch.profiler) and repeat bit for bit;
   its tiled route is held at (2, 512, 512). K3 runs under no_grad, one
   kernel per call;
4. checks the serving pipeline at a small size on the card against the same
   pipeline on the CPU (where each wrapper runs its twin), and the same with
   the W8A8 latent / fc projections (dense_int8);
5. runs CompressionPipeline(ModelConfig(), device="cuda") at full width with
   seeded random weights (attention gamma 0.5, random BN statistics) on
   B = 16 structured 256^2 images three times, checking shapes, finite
   symbols and that the kernels' launch counters moved by K1 +1, K2 +1 and
   K3 +2 per call;
6. holds K3b (the quantizer's backward) against its twin at the training
   path's shapes (B = 16, D = 1024 and 512, float32 and bf16), one kernel
   per call, and times it;
7. checks two GAN training steps (with and without D) of a tiny codec on the
   card against the same steps on the CPU: losses, per-component gradients,
   parameters and BatchNorm statistics, with the perceptual loss's VGG19
   ReLU and max-pool decisions on the card taken from the CPU step; then
   the same two steps in mixed precision (bf16 activations, float32
   parameters) at bf16's bars (check_small_mixed_step_against_cpu);
8. trains at full width (TrainConfig() defaults, random VGG19 for the
   perceptual loss): masks of 32 synthetic images through K1, a
   device-resident dataset, GANTrainer.fit for 4 steps after one warm-up
   step, and the rate-control probe, checking finite metrics, moved
   parameters and BatchNorm statistics, and the launch counts (K1 +1; per
   step K2 +1, K3 +2, K3b +2; per probe point K2 +1, K3 +2), then times
   steps with and without D; after step 10 the same runs in mixed
   precision (ModelConfig(dtype='bfloat16', param_dtype='float32'), VGG19
   float32): K2 on "wgmma" under autograd, K3 / K3b in bf16, parameters, BN
   statistics and Adam moments float32 and moved, the 'final' checkpoint
   resumed bitwise, and its step times printed beside the float32 ones;
9. holds K4 (the smooth mask) against its twin at B = 64, 256^2, on the
   saliency maps of both non-'combined' methods (the cluster route, one
   kernel per call, bitwise repeatable) and at (2, 512, 512) (the tiled
   route), and times it;
10. runs the mask path at full width: prepare_masks over 128 seeded rich
   synthetic images at 256^2 in device batches of 64 for
   method='spectral_residual' and 'fine_grained' (K4 +1 per batch, K1 0),
   plus one batch of binary masks, checking the masks against the port on
   the CPU on the first images, and times one batch's stages; then the
   masks with the FFT spectral core (spectral_dft_matmul=False, cuFFT) of
   16 images, 'combined' through K1 and 'spectral_residual' through K4,
   smooth and binary, against the CPU port;
11. holds K5 (the DCT transform and quantizer) against its twin at B = 128,
   256^2, quality 75, and times it (host-inclusive and on the device alone)
   beside a cuBLAS formulation;
12. runs the DCT baseline at full width on 128 seeded images: evaluate at
   qualities 10..90 with PSNR / SSIM, entropy bpp and the measured bpp of 4
   range-coded streams (the coder is built with g++ first), streams encoded
   on the card and decoded on the CPU and the reverse, and the round trip's
   images per second and stages (K5 +1 per codec call);
13. holds K6 (the attention core) against its twin at K2's shapes in bf16
   and float32, and times it beside softmax(q k^T) v in three calls and SDPA
   (K2 likewise, float32 on the "tf32x3" route);
14. holds K7a and K7b (the fused SAGAN block) against their twin with the
   HQ encoder's SelfAttention weights of a full-width codec (gamma 0.5) on
   a (16, 256, 32, 32) activation, K7b reading the NCHW tensor through
   x.permute(0, 2, 3, 1), and against the module's own forward (F.linear
   projections + K2), bf16 on the "wgmma" route and float32 on the
   "tf32x3" one (three TF32 passes on the tensor cores; route counts);
   times both, host-inclusive and on the device alone, beside the composed
   torch yardstick (float32: TF32 off) and the float32 bounds;
15. holds K8 (the fused generator tail) against its twin and against
   packed_tail_forward(use_pallas=False) with the HQ generator's deconv4,
   bn4 (random statistics) and out_conv on a (16, 128, 128, 128) input,
   bf16 on the "wgmma" route and float32 on the "tf32x3" one, and times it
   the same two ways, float32 beside cuDNN's float32 (TF32 off) and its
   bounds;
16. drives the entry points of K6-K8 once at full width in bf16
   (attention_core, sagan_block, sagan_block_spatial,
   packed_tail_forward(use_pallas=True)): each kernel +1 and no other;
17. runs the storable codec: at the small config, containers made on the
   card and on the CPU decode on both; at full width
   (ModelConfig(skip_mode='zero'), 16 structured images)
   encode_to_bitstream then decode_from_bitstream (K1 +1, K2 +1, K3 +2),
   the decode held against the direct call, with the measured bpp and the
   encode, decode and host-coder times;
18. checks that the serving, training, mask and storable-codec paths at 256^2
   ran K1 and K4 on the cluster route only, and K2 / K6 on the route of
   their dtype (serving, W8A8 serving, mixed training, storable codec and
   entry points "wgmma", float32 training "tf32x3");
19. prints its wall time, a `kernels` JSON line and, last, {"ok": true,
   "device": {...}}.

After step 5 a full-width W8A8 serving call (the pipeline's codec built
with dense_int8 instead of dense_w8: activations quantized per row, int32
products through torch._int_mm) runs three times at B = 16, each K1 +1, K2
+1, K3 +2, timed beside the dense_w8 pipeline on the same weights.

Checkpoints (the JAX package's files, read and written without flax) and
the autoencoder run in four more phases, after step 5, in step 8 and after
step 17:

(a) serves the JAX-trained tiny GAN of tests/fixtures/jax_tiny_gan
   (CompressionPipeline(model_dir=...), provenance all 'final', K1 +1, K2
   +1, K3 +2) against the JAX pipeline's committed outputs and the port's
   CPU pipeline on the same files;
(b) saves the seeded full-width codec's float32 state through the store
   into a temporary directory (1.67 GB) and serves it from there at B = 16,
   bitwise equal to the pipeline built from the state dict, with the bytes,
   write and load seconds and GB/s;
(c) in step 8, fit writes the full-width train state ('final', ~5 GB, the
   background writer) into a temporary model_dir; the save is timed once
   more on its own, a fresh GANTrainer(...).init_state(resume=True) on the
   card restores it bitwise (parameters, BN statistics, Adam moments and
   steps, the step counter; the history equal), and one step with D from
   each agrees within 1e-5; at the tiny config a 'host' mode save matches a
   'background' one byte for byte and nan_guard raises FloatingPointError
   on a NaN parameter;
(d) loads the trained autoencoder of runs/ae_ref on the card: 64 seeded
   128^2 images within 1e-5 of the CPU port, ae_metrics and images per
   second, 2 epochs of fit at B = 16, a save / load round trip bitwise, and
   no kernel launch.

The evaluation slice adds four phases:

(a) after the builds, prints which of cv2, PIL, matplotlib, jpeglib.h,
   png.h, libjpeg.so and libpng.so the machine has, beside CARD_LIBRARIES
   (what the card's machine had when this was written, which fixes the
   routes of (c) and (d) in the source), and checks that the native image
   loader builds exactly where that record says it can (it does not there:
   no libjpeg / libpng headers);
(b) at the end, holds K1's bf16 route (compute_dtype=bfloat16, the TPU
   kernel's bf16 compute) against its bf16 twin at B = 16, 256^2, bit for
   bit, and within 5e-2 of the float32 kernel, one kernel per call, its
   tiled route at (2, 512, 512), and times it beside the float32 route;
(c) runs the evaluation entry point at full width: the seeded codec written
   in JAX's layout to a temporary model_dir, CodecEvaluator with
   SaliencyConfig(mask_engine_dtype='bfloat16') through load_models,
   prepare_masks (K1 bf16 +1), test_compression (3 bpps) and
   test_rate_control (10 bpps) over the 16 JPEGs of
   runs/ae_ref/compressed_outputs, with each bpp's PSNR, SSIM, analytic and
   measured bpp and each call's wall time (K2 +1 on "tf32x3" and K3 +2 per
   codec forward); then the JAX-trained tiny GAN through the same evaluator,
   card against the CPU port within the bars of tests/test_torch_eval.py;
(d) evaluate_autoencoder on runs/ae_ref over the same JPEGs, card against
   the CPU port, no kernel launch.

K1's bf16 launches are counted apart (`launch_counts()`: 'K1' float32,
'K1bf16' bf16) and K1bf16 has its own line in the kernels JSON.

K7a / K7b and K8 are also timed against their float32 library calls with
TF32 off: the SAGAN block composed of F.linear and softmax(q k^T) v in three
calls (and SelfAttention.forward, F.linear + K2), and
packed_tail_forward(use_pallas=False) on cuDNN.

Any failed check raises, so the exit code is non-zero and no result line is
printed. Without CUDA, or without the port package beside it, it exits 1.
"""

import copy
import json
import math
import os
import pathlib
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

T_START = time.time()
H100_BF16_TFLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_FP32_TFLOPS = 67e12   # CUDA-core float32 peak
# CUDA-core bf16 peak outside the tensor cores (packed bf16x2, H100 SXM white paper)
H100_BF16_CUDA_CORE_TFLOPS = 134e12
H100_TF32_TFLOPS = 495e12  # dense TF32 tensor-core peak
H100_HBM_BYTES_S = 3.35e12


def log(msg):
    print(msg, flush=True)


def launch_counts():
    """The port's launch counts (ops.launch_counts()) with K1's two routes
    apart: 'K1' its float32 launches, 'K1bf16' its bf16 ones (the
    wrapper's routes 'cluster_bf16' and 'tiled_bf16')."""
    from contextual_image_compression_tpu_torch import ops

    counts = ops.launch_counts()
    routes = ops.route_counts()["K1"]
    counts["K1bf16"] = routes["cluster_bf16"] + routes["tiled_bf16"]
    counts["K1"] -= counts["K1bf16"]
    return counts


def expect(**nonzero):
    """A full launch-count dict (as launch_counts() gives it): the given
    kernels at their counts, every other kernel at 0."""
    from contextual_image_compression_tpu_torch import ops

    keys = (*ops.KERNEL_WRAPPERS, "K1bf16")
    unknown = set(nonzero) - set(keys)
    if unknown:
        raise KeyError(f"unknown kernels {unknown}")
    return {k: nonzero.get(k, 0) for k in keys}


def bound_ms(nbytes, ops, peak_ops):
    """The bound in ms and what sets it. ops and peak_ops may be equal-length
    tuples: work of several types on the same units, whose times add."""
    t_bytes = nbytes / H100_HBM_BYTES_S
    if isinstance(ops, tuple):
        t_ops = sum(o / pk for o, pk in zip(ops, peak_ops, strict=True))
    else:
        t_ops = ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def one_kernel_per_call(label, fn, wrapper, kernel, calls=3):
    """Fail unless `calls` fn() calls add `calls` to the wrapper's launch
    count and torch.profiler (ProfilerActivity.CUDA) records, on the device,
    nothing but kernels whose name holds `kernel`: no memset, no copy, no
    cast. CUPTI may drop records under this script's load (one run saw two
    of three launches, another none), so the profiler shows what ran and
    the counter how often; a session that records nothing is repeated, at
    most ten times (after the training phases K4's first one to three
    sessions of a run record nothing, then one records its three
    launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for sessions in range(1, 11):
        before = wrapper.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launched = wrapper.launches - before
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    other = [n for n in names if kernel not in n]
    log(f"{label}: {calls} calls, {launched} launches counted; the profiler ({sessions} "
        f"session(s)) recorded {len(names) - len(other)} {kernel} and {len(other)} other device "
        f"activities {sorted(set(names))}")
    if launched != calls or other or len(names) == len(other):
        raise AssertionError(f"{label}: want one {kernel} launch per call and nothing else, got "
                             f"{launched} launches, activities {names}")
    return launched // calls


def kernel_device_ms(fn, calls=5):
    """Mean device milliseconds a call of each kernel fn launches, from
    torch.profiler (CUPTI may drop records under load: information only)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            name = ev.key.replace("(anonymous namespace)::", "").replace("void ", "")
            name = name.split("(")[0].split("::")[-1]
            out[name] = us / calls / 1e3
    return out


def check_attention_route(label, route):
    """K2 and K6 took `route` on every launch of the path."""
    from contextual_image_compression_tpu_torch import ops

    routes = {key: counts for key, counts in ops.route_counts().items() if key in ("K2", "K6")}
    for key, counts in routes.items():
        if counts[route] != launch_counts()[key]:
            raise AssertionError(f"{label}: {key} routes {counts}, want {route} only")
    log(f"{label}: attention routes {routes}")
    return routes


def check_cluster_route(label):
    """The mask kernels of a path at 256^2 took the cluster route only."""
    from contextual_image_compression_tpu_torch import ops

    routes = {key: counts for key, counts in ops.route_counts().items() if key in ("K1", "K4")}
    for key, counts in routes.items():
        cluster = sum(n for route, n in counts.items() if route.startswith("cluster"))
        if cluster != sum(counts.values()) or cluster != ops.KERNEL_WRAPPERS[key].launches:
            raise AssertionError(f"{label}: {key} routes {counts}, want the cluster route only")
    log(f"{label}: mask kernel routes {routes}")
    return routes


MASK_DESIGN = ("one launch per call: a thread-block cluster of {cluster} blocks x 512 threads per "
               "image, each block a strip of {rows} rows in {kb:.1f} KB of shared memory, halos "
               "through DSMEM, image maxima over the cluster's slots")


def _route_of(wrapper, call):
    before = dict(wrapper.route_launches)
    out = call()
    moved = [r for r in before if wrapper.route_launches[r] != before[r]]
    if len(moved) != 1:
        raise AssertionError(f"one route per call, moved {moved}")
    return out, moved[0]


def check_k1(dev, rng, B):
    from contextual_image_compression_tpu_torch.measure import (
        device_ms, event_ms, structured_images)
    from contextual_image_compression_tpu_torch.ops import image_ops, saliency
    from contextual_image_compression_tpu_torch.ops.fused_mask import (
        contextual_mask, contextual_mask_plain)

    from contextual_image_compression_tpu_torch.ops.fused_mask import (
        _mask_plan, mask_max_clusters)

    u8 = torch.from_numpy(structured_images(rng, B, 256)).to(dev)
    gray = image_ops.rgb_to_gray(u8.float()).contiguous()
    spec = saliency.spectral_residual_small(gray, 64, 3.0).contiguous()
    got, route = _route_of(contextual_mask, lambda: contextual_mask(gray, spec))
    again = contextual_mask(gray, spec)
    want = contextual_mask_plain(gray, spec)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    same = torch.equal(got, again)
    plan = _mask_plan(256, 256, 6, 4, 31)
    log(f"K1 contextual mask {tuple(gray.shape)}, {route} route ({plan}; the card runs "
        f"{mask_max_clusters(True, 256, 256)} such clusters at once): max |kernel - twin| = "
        f"{err:.3e} (bar 1e-4); two calls bitwise equal: {same}")
    if not (err <= 1e-4 and route == "cluster" and same):
        raise AssertionError(f"K1: {route} route, error {err}, deterministic {same}")
    per_call = one_kernel_per_call("K1", lambda: contextual_mask(gray, spec), contextual_mask,
                                   "mask_cluster_kernel")
    # the tiled route, for images whose strips exceed a cluster's shared memory
    u8t = torch.from_numpy(structured_images(rng, 2, 512)).to(dev)
    gray_t = image_ops.rgb_to_gray(u8t.float()).contiguous()
    spec_t = saliency.spectral_residual_small(gray_t, 64, 3.0).contiguous()
    got_t, route_t = _route_of(contextual_mask, lambda: contextual_mask(gray_t, spec_t))
    err_t = (got_t - contextual_mask_plain(gray_t, spec_t)).abs().max().item()
    tiled_ms = event_ms(lambda: contextual_mask(gray_t, spec_t))
    log(f"K1 tiled route {tuple(gray_t.shape)}: {route_t}, max |kernel - twin| = {err_t:.3e} "
        f"(bar 1e-4), {tiled_ms:.4f} ms")
    if not (err_t <= 1e-4 and route_t == "tiled"):
        raise AssertionError(f"K1 tiled route: {route_t}, error {err_t}")
    ms = event_ms(lambda: contextual_mask(gray, spec))
    dev_ms = device_ms(lambda: contextual_mask(gray, spec))
    plain = event_ms(lambda: contextual_mask_plain(gray, spec), reps=5, warmup=1)
    # Operations the function needs per pixel (not what this kernel spends):
    # per box radius a sliding column and row sum (2 + 2 adds), the mean, the
    # |g - mean| term and its accumulation (4); g = gray / 255, the fine
    # max-normalization and its max (3); the bilinear upsample, the 0.6 / 0.4
    # blend and its max (10); 7 per bilateral tap and its final division; a
    # multiply-add per Gaussian tap in each of the two passes; the last
    # normalization and max (2).
    pixels = gray.numel()
    rmax, ntaps, ksize = 6, 49, 31
    ops_per_px = 8 * rmax + 3 + 10 + (7 * ntaps + 1) + 2 * 2 * ksize + 2
    nbytes = gray.numel() * 4 + spec.numel() * 4 + got.numel() * 4
    b_ms, b_by = bound_ms(nbytes, ops_per_px * pixels, H100_FP32_TFLOPS)
    log(f"K1 times: kernel {ms:.4f} ms (device alone {dev_ms:.4f}), twin {plain:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), library none")
    return dict(name="K1 contextual_mask", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/fused_mask.cu",
                replaces="contextual_image_compression_tpu/ops/fused_mask.py:252",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_ms=dev_ms, mask_route=route,
                design=MASK_DESIGN.format(cluster=plan.cluster, rows=plan.rows,
                                          kb=plan.smem_bytes / 1024),
                launches_per_call=per_call, deterministic=same, tiled_route_ms=tiled_ms,
                tiled_route_max_abs_err=err_t)


def _identical(got, want):
    """Share of elements of got equal to want bit for bit."""
    return (got == want).float().mean().item()


def _three_calls(q, k, v):
    """softmax(q k^T) v in three library calls (a yardstick the port never calls)."""
    return torch.softmax(q @ k.transpose(1, 2), dim=-1) @ v


def check_k2(dev, B):
    import torch.nn.functional as F
    from contextual_image_compression_tpu_torch.measure import device_ms, event_ms
    from contextual_image_compression_tpu_torch.ops.attention import (
        attention_block, attention_block_plain)

    gen = torch.Generator(device=dev).manual_seed(2)
    N, DK, DV = 1024, 32, 256
    q = (torch.randn(B, N, DK, device=dev, generator=gen) * 0.4).to(torch.bfloat16)
    k = (torch.randn(B, N, DK, device=dev, generator=gen) * 0.4).to(torch.bfloat16)
    v = torch.randn(B, N, DV, device=dev, generator=gen).to(torch.bfloat16)
    res = torch.randn(B, N, DV, device=dev, generator=gen).to(torch.bfloat16)
    g = torch.tensor(0.5, device=dev)
    zero = torch.zeros_like(res)
    got = attention_block(q, k, v, res, g)
    want = attention_block_plain(q, k, v, res, g)
    # With the residual at 0 the output is the attention term gamma * ctx
    # alone, so the bf16 bar is relative to that term, not to the ulp of the
    # residual, which at |res| ~ 4 is larger than the term itself.
    att = attention_block(q, k, v, zero, g)
    att_want = attention_block_plain(q, k, v, zero, g)
    f32 = [t.float() for t in (q, k, v, res)]
    got32, route32 = _route_of(attention_block, lambda: attention_block(*f32, g))
    want32 = attention_block_plain(*f32, g)
    if route32 != "tf32x3":
        raise AssertionError(f"K2 float32 took the {route32} route")
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    att_rel = _rel(att, att_want)
    same, att_same = _identical(got, want), _identical(att, att_want)
    err32 = (got32 - want32).abs().max().item()
    log(f"K2 attention block bf16 q,k {tuple(q.shape)} v {tuple(v.shape)}: max |kernel - twin| = "
        f"{err:.3e} ({rel:.2e} of max |out|, bar 2e-2); residual 0: {att_rel:.2e} of max "
        f"|gamma ctx| = {att_want.float().abs().max().item():.3e} (bar 2e-2); float32 {err32:.3e} "
        f"(bar 1e-5); bit-identical to the twin: {same:.4f} of outputs, residual 0: {att_same:.4f}")
    if not (rel <= 2e-2 and att_rel <= 2e-2 and err32 <= 1e-5):
        raise AssertionError(f"K2 disagrees with its twin: bf16 {rel}, residual 0 {att_rel}, "
                             f"f32 {err32}")
    ms = event_ms(lambda: attention_block(q, k, v, res, g))
    ms32 = event_ms(lambda: attention_block(*f32, g))
    plain = event_ms(lambda: attention_block_plain(q, k, v, res, g), reps=5, warmup=1)
    # yardsticks the port never calls, both without the gamma-residual epilogue:
    # softmax(q k^T) v in three cuBLAS-backed calls (bf16; float32 with TF32
    # off), and one SDPA call
    lib = event_ms(lambda: _three_calls(q, k, v))
    lib32 = event_ms(lambda: _three_calls(*f32[:3]))
    sdpa = event_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
    sdpa32 = event_ms(lambda: F.scaled_dot_product_attention(*f32[:3], scale=1.0))
    # the same calls on the device alone, the host's launch kept out
    dev_ms = device_ms(lambda: attention_block(q, k, v, res, g))
    lib_dev = device_ms(lambda: _three_calls(q, k, v))
    sdpa_dev = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
    dev32, lib32_dev, sdpa32_dev = _float32_device_times(
        lambda: attention_block(*f32, g), f32[:3])
    parts32 = kernel_device_ms(lambda: attention_block(*f32, g))
    log(f"K2 float32 kernels a call (torch.profiler, device ms): {json.dumps(parts32)}")
    flops = 2.0 * B * N * N * (DK + DV)
    nbytes = (q.numel() + k.numel() + v.numel() + res.numel() + got.numel()) * 2
    b_ms, b_by = bound_ms(nbytes, flops, H100_BF16_TFLOPS)
    # float32: three TF32 passes of every product, 4-byte elements
    b32_ms, b32_by = bound_ms(2 * nbytes, 3 * flops, H100_TF32_TFLOPS)
    log(f"K2 times (host launch inside): kernel bf16 {ms:.4f} ms (device alone {dev_ms:.4f}; "
        f"float32 {ms32:.4f}, device alone {dev32:.4f}), twin {plain:.4f} ms, bound bf16 "
        f"{b_ms:.4f} ms ({b_by}), float32 {b32_ms:.4f} ms ({b32_by}; "
        f"{flops / H100_FP32_TFLOPS * 1e3:.4f} ms at the CUDA cores' rate), library "
        f"softmax(q k^T) v in three calls {lib:.4f} ms (device alone {lib_dev:.4f}; float32, "
        f"TF32 off, {lib32:.4f}, device alone {lib32_dev:.4f}), scaled_dot_product_attention"
        f"(scale=1) bf16 {sdpa:.4f} ms (device alone {sdpa_dev:.4f}; float32 {sdpa32:.4f}, "
        f"device alone {sdpa32_dev:.4f})")
    return dict(name="K2 attention_block", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/attention.cu",
                replaces="contextual_image_compression_tpu/ops/attention.py:174",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=sdpa, library_device_ms=sdpa_dev, library_float32_ms=sdpa32,
                yardstick_ms=lib, yardstick_device_ms=lib_dev, yardstick_float32_ms=lib32,
                float32_ms=ms32, device_ms=dev_ms, identical_share=same,
                float32_kernels_device_ms=parts32,
                **_float32_fields(err32, dev32, lib32_dev, sdpa32_dev, b32_ms, b32_by, flops))


def _float32_device_times(call, qkv):
    """Device-alone times of a float32 K2 / K6 call and of its yardsticks,
    the three library calls (with TF32 off, which main() sets) and SDPA."""
    import torch.nn.functional as F
    from contextual_image_compression_tpu_torch.measure import device_ms

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the float32 yardsticks are timed with TF32 off")
    return (device_ms(call), device_ms(lambda: _three_calls(*qkv)),
            device_ms(lambda: F.scaled_dot_product_attention(*qkv, scale=1.0)))


def _float32_fields(err32, dev32, lib32_dev, sdpa32_dev, b32_ms, b32_by, flops):
    """The float32 route's entries of K2's and K6's records."""
    return dict(design="wgmma", route_bfloat16="wgmma", route_float32="tf32x3",
                design_float32="three TF32 passes a_hi b_hi + a_hi b_lo + a_lo b_hi on wgmma "
                               "(cvt.rna splits; a pre-pass writes q, k and V^T as hi / lo)",
                max_abs_err_float32=err32, float32_device_ms=dev32,
                yardstick_float32_device_ms=lib32_dev, yardstick_float32_tf32="off",
                library_float32_device_ms=sdpa32_dev, float32_bound_ms=b32_ms, float32_bound_by=b32_by,
                float32_cuda_core_bound_ms=flops / H100_FP32_TFLOPS * 1e3)


def check_k3(dev, B):
    from contextual_image_compression_tpu_torch.config import QuantizerConfig
    from contextual_image_compression_tpu_torch.measure import device_ms, event_ms
    from contextual_image_compression_tpu_torch.ops.quantize import (
        adaptive_quantize, adaptive_quantize_plain)

    gen = torch.Generator(device=dev).manual_seed(3)
    cfg = QuantizerConfig(grad_mode="reference")
    cases = []
    for d in (1024, 512):  # the HQ and LQ latents of one pipeline call
        z = (torch.randn(B, d, device=dev, generator=gen) * 2).to(torch.bfloat16)
        s = torch.rand(B, 1, device=dev, generator=gen).to(torch.bfloat16)
        qs = (torch.rand(B, 1, device=dev, generator=gen) * 0.9).to(torch.bfloat16)
        cases.append((z, s, qs))
    err, same = 0.0, 1.0
    with torch.no_grad():  # as serving calls it: no autograd Function
        for z, s, qs in cases:
            for dt in (torch.bfloat16, torch.float32):
                args = (z.to(dt), s.to(dt), qs.to(dt))
                got = adaptive_quantize(*args, cfg)
                if got.grad_fn is not None:
                    raise AssertionError("K3 under no_grad went through autograd")
                want = adaptive_quantize_plain(*args).float()
                err = max(err, (got.float() - want).abs().max().item())
                same = min(same, (got.float() == want).float().mean().item())
    torch.cuda.synchronize()
    log(f"K3 quantizer (16,1024)+(16,512), bf16 and float32, under no_grad: max |kernel - twin| = "
        f"{err:.3e}, bitwise equal share {same:.5f} (bar >= 0.999)")
    if not same >= 0.999:
        raise AssertionError(f"K3 disagrees with its twin: {same}")

    def pair(fn):
        def run():
            with torch.no_grad():
                return [fn(z, s, qs) for z, s, qs in cases]
        return run

    z, s, qs = cases[0]
    with torch.no_grad():
        per_call = one_kernel_per_call("K3", lambda: adaptive_quantize(z, s, qs, cfg),
                                       adaptive_quantize, "quant_fwd_kernel")

    ms = event_ms(pair(lambda z, s, qs: adaptive_quantize(z, s, qs, cfg)))
    dev_ms = device_ms(pair(lambda z, s, qs: adaptive_quantize(z, s, qs, cfg)))
    plain = event_ms(pair(adaptive_quantize_plain))
    nbytes = sum(z.numel() * 2 * 2 + B * 4 * 2 for z, _, _ in cases)
    ops = sum(z.numel() * 3 for z, _, _ in cases)
    b_ms, b_by = bound_ms(nbytes, ops, H100_FP32_TFLOPS)
    log(f"K3 times (two launches of one call): kernel {ms:.4f} ms (device alone {dev_ms:.4f}), "
        f"twin {plain:.4f} ms, bound {b_ms:.6f} ms ({b_by}), library none")
    return dict(name="K3 adaptive_quantize", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/quantize.cu",
                replaces="contextual_image_compression_tpu/ops/quantize.py:152",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_ms=dev_ms, launches_per_call=per_call,
                identical_share=same)


def w8a8_pipeline(pipe, state_dict):
    """The serving pipeline `pipe` with its codec rebuilt for W8A8
    (`ModelConfig(dtype='bfloat16', dense_int8=True)`): the float32 weights
    of `state_dict` in a codec built with dense_int8 and without dense_w8
    (which wins over dense_int8 in both packages' KDense, so the serving
    configuration's dense_w8 would hide it), cast to bf16 as serving casts
    them. Everything else of the pipeline's call is its own."""
    import dataclasses

    from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec
    from contextual_image_compression_tpu_torch.models.layers import cast_floats

    mcfg = dataclasses.replace(pipe.mcfg, dense_w8=False, dense_int8=True)
    with torch.device(pipe.device):
        codec = AdaptiveCodec(mcfg)
    codec.load_state_dict(state_dict)
    cast_floats(codec, mcfg.compute_dtype())
    out = copy.copy(pipe)
    out.mcfg, out.codec, out._seen_batches = mcfg, codec.eval().requires_grad_(False), set()
    return out


def check_small_pipeline_against_cpu(dev, w8a8=False):
    """The same weights and images through the pipeline on the card (kernels)
    and on the CPU (twins): mask <= 1e-4, decoded PSNR >= 40 dB, symbols
    within +-1 and >= 95% identical. w8a8: the pipeline with the W8A8
    latent / fc projections (w8a8_pipeline) on both."""
    from contextual_image_compression_tpu_torch.config import ModelConfig
    from contextual_image_compression_tpu_torch.measure import randomize_stats, structured_images
    from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    cfg = ModelConfig(img_size=(64, 64), base_latent_dim=64, generator_base_hw=4)
    ref = AdaptiveCodec(cfg)
    ref.reset_parameters(5)
    randomize_stats(ref, 5)
    sd = ref.state_dict()
    u8 = structured_images(np.random.RandomState(6), 4, 64)
    outs = {}
    for name in ("cuda", "cpu"):
        pipe = CompressionPipeline(state_dict=sd, model_config=cfg, device=name)
        if w8a8:
            pipe = w8a8_pipeline(pipe, sd)
        dec, info = pipe(u8, target_bpp=1.0)
        outs[name] = (dec, {k: v.float().cpu().numpy() for k, v in info.items()})
    (dg, ig), (dc, ic) = outs["cuda"], outs["cpu"]
    mask_err = float(np.abs(ig["mask"] - ic["mask"]).max())
    mse = float(np.mean((dg.astype(np.float64) - dc.astype(np.float64)) ** 2))
    psnr = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
    sym_same = min(float(np.mean(ig[k] == ic[k])) for k in ("hq_symbols", "lq_symbols"))
    sym_max = max(float(np.abs(ig[k] - ic[k]).max()) for k in ("hq_symbols", "lq_symbols"))
    log(f"small {'W8A8 ' if w8a8 else ''}pipeline card vs CPU: mask {mask_err:.3e} (bar 1e-4), "
        f"decoded PSNR {psnr:.2f} dB "
        f"(bar 40), symbols identical {sym_same:.4f} (bar 0.95), max |diff| {sym_max} (bar 1)")
    if not (mask_err <= 1e-4 and psnr >= 40.0 and sym_same >= 0.95 and sym_max <= 1.0):
        raise AssertionError("the pipeline on the card disagrees with the CPU pipeline")


def run_full_pipeline(dev, card):
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import ModelConfig
    from contextual_image_compression_tpu_torch.measure import randomize_stats, structured_images
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline
    from contextual_image_compression_tpu_torch.utils.tree import param_count

    t0 = time.time()
    pipe = CompressionPipeline(model_config=ModelConfig(), device=dev, seed=0)
    randomize_stats(pipe.codec, 0)
    n_params = param_count(pipe.codec)
    log(f"full-width pipeline built in {time.time() - t0:.1f} s: {n_params / 1e6:.1f}M parameters "
        f"(int8 latent/fc rows counted), bf16, w8, folded int8 tail")
    B = 16
    u8 = structured_images(np.random.RandomState(1), B, 256)
    pipe(u8, target_bpp=1.0)  # first call: cuDNN autotuning, allocator warm-up
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    times = []
    for i in range(3):
        before = launch_counts()
        t = time.perf_counter()
        dec, info = pipe(u8, target_bpp=1.0)  # ends in a device->host copy
        times.append(time.perf_counter() - t)
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        if delta != expect(K1=1, K2=1, K3=2):
            raise AssertionError(f"call {i}: kernel launches {delta}, want K1 1, K2 1, K3 2, "
                                 "and no other")
        if dec.shape != (B, 256, 256, 3) or dec.dtype != np.uint8:
            raise AssertionError(f"decoded {dec.shape} {dec.dtype}")
        for key, shape in (("hq_symbols", (B, 1024)), ("lq_symbols", (B, 512)),
                           ("mask", (B, 256, 256)), ("bit_allocation", (B, 256, 256))):
            val = info[key]
            if tuple(val.shape) != shape or not bool(torch.isfinite(val).all()):
                raise AssertionError(f"{key}: shape {tuple(val.shape)} or non-finite values")
        if info["hq_symbols"].dtype != torch.float32:
            raise AssertionError("symbols must be float32")
    counts = launch_counts()
    check_cluster_route("serving")
    check_attention_route("serving", "wgmma")
    med = float(np.median(times))
    log(f"full-width pipeline B={B}, 256x256: 3 calls, median {med * 1e3:.2f} ms/call, "
        f"{B / med:.1f} img/s on {card}; launches {counts}")
    log(f"decoded mean {dec.mean():.2f}, std {dec.std():.2f}; |hq symbols| mean "
        f"{info['hq_symbols'].abs().mean().item():.3f}; mask mean {info['mask'].mean().item():.4f}")
    return counts, med


def run_w8a8_serving(dev, card):
    """A full-width W8A8 serving call: the pipeline at ModelConfig() with its
    latent / fc projections in W8A8 (w8a8_pipeline; activations quantized
    per row, int32 products through torch._int_mm) on B = 16 structured
    images, three calls after a warm-up, each K1 +1, K2 +1, K3 +2 and no
    other, with finite symbols; timed beside the dense_w8 pipeline on the
    same weights, calls alternating. Returns the path's launch counts."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import ModelConfig
    from contextual_image_compression_tpu_torch.measure import randomize_stats, structured_images
    from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    with torch.device(dev):
        ref = AdaptiveCodec(ModelConfig())
    ref.reset_parameters(0)
    randomize_stats(ref, 0)
    sd = ref.state_dict()
    del ref
    w8 = CompressionPipeline(state_dict=sd, model_config=ModelConfig(), device=dev)
    w8a8 = w8a8_pipeline(w8, sd)
    del sd
    B = 16
    u8 = structured_images(np.random.RandomState(1), B, 256)
    for pipe in (w8, w8a8):
        pipe(u8, target_bpp=1.0)  # warm-up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    times = {"w8": [], "w8a8": []}
    counts = expect()  # the W8A8 calls' launches
    for name in ("w8a8", "w8", "w8", "w8a8", "w8a8", "w8"):
        pipe = w8a8 if name == "w8a8" else w8
        before = launch_counts()
        t = time.perf_counter()
        dec, info = pipe(u8, target_bpp=1.0)
        times[name].append(time.perf_counter() - t)
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        if delta != expect(K1=1, K2=1, K3=2):
            raise AssertionError(f"{name} call: kernel launches {delta}")
        if name == "w8a8":
            counts = {k: counts[k] + delta[k] for k in counts}
            for key, shape in (("hq_symbols", (B, 1024)), ("lq_symbols", (B, 512))):
                if tuple(info[key].shape) != shape or not bool(torch.isfinite(info[key]).all()):
                    raise AssertionError(f"W8A8 {key}: shape or non-finite values")
            if dec.shape != (B, 256, 256, 3) or dec.dtype != np.uint8:
                raise AssertionError(f"W8A8 decoded {dec.shape} {dec.dtype}")
            w8a8_sym = info["hq_symbols"].abs().mean().item()
    check_cluster_route("W8A8 serving")
    check_attention_route("W8A8 serving", "wgmma")
    m8a8, m8 = float(np.median(times["w8a8"])), float(np.median(times["w8"]))
    log(f"full-width W8A8 serving (dense_int8, bf16) B={B}: median {m8a8 * 1e3:.2f} ms/call "
        f"({B / m8a8:.1f} img/s) beside dense_w8 {m8 * 1e3:.2f} ms/call ({B / m8:.1f} img/s) on "
        f"{card}, 3 calls each, alternating; |hq symbols| mean {w8a8_sym:.3f}; launches of the "
        f"W8A8 calls {counts}")
    return counts


def run_fft_core_masks(dev, card):
    """The masks with the FFT spectral core (SaliencyConfig(
    spectral_dft_matmul=False), torch.fft: cuFFT on the card) of 16
    structured images at 256^2: 'combined' smooth through K1,
    'spectral_residual' smooth through K4, and the binary 'combined' mask;
    the first 4 against the port on the CPU: smooth masks within 1e-4,
    thresholds equal, binary masks equal on >= 99.9% of pixels. Returns the
    path's launch counts."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import SaliencyConfig
    from contextual_image_compression_tpu_torch.measure import structured_images
    from contextual_image_compression_tpu_torch.ops import image_ops, masks, saliency

    u8 = structured_images(np.random.RandomState(3), 16, 256)
    n_cpu = 4
    cases = {"combined": SaliencyConfig(spectral_dft_matmul=False),
             "spectral_residual": SaliencyConfig(method="spectral_residual",
                                                 spectral_dft_matmul=False),
             "combined binary": SaliencyConfig(spectral_dft_matmul=False, mask_smooth=False)}
    x = torch.from_numpy(u8).to(dev)
    ops.reset_launch_counts()
    got = {name: masks.compute_contextual_mask(x, cfg) for name, cfg in cases.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != expect(K1=1, K4=1):
        raise AssertionError(f"FFT-core mask launches {counts}, want K1 1, K4 1")
    check_cluster_route("FFT-core masks")
    res = {}
    for name, cfg in cases.items():
        cpu = masks.compute_contextual_mask(torch.from_numpy(u8[:n_cpu]), cfg).numpy()
        card_out = got[name][:n_cpu].cpu().numpy()
        if not np.all(np.isfinite(card_out)):
            raise AssertionError(f"FFT-core {name} mask: non-finite values")
        res[name] = (float(np.abs(card_out - cpu).max()) if cfg.mask_smooth
                     else float(np.mean(card_out == cpu)))
    gray = image_ops.rgb_to_gray(x[:n_cpu].float())
    cfg = cases["combined binary"]
    t_card = masks.adaptive_threshold(saliency.compute_saliency_map(gray, "combined", cfg), cfg)
    gray_cpu = image_ops.rgb_to_gray(torch.from_numpy(u8[:n_cpu]).float())
    t_cpu = masks.adaptive_threshold(
        saliency.compute_saliency_map(gray_cpu, "combined", cfg), cfg)
    same_t = float(np.mean(t_card.cpu().numpy() == t_cpu.numpy()))
    log(f"FFT-core masks (spectral_dft_matmul=False, cuFFT) of 16 images at 256^2 on {card}; "
        f"card vs CPU port on {n_cpu}: combined (K1) {res['combined']:.3e}, spectral_residual "
        f"(K4) {res['spectral_residual']:.3e} (bar 1e-4); binary combined: thresholds equal "
        f"{same_t:.3f} (bar 1.0), pixels equal {res['combined binary']:.6f} (bar 0.999); "
        f"launches {counts}")
    if not (res["combined"] <= 1e-4 and res["spectral_residual"] <= 1e-4 and same_t == 1.0
            and res["combined binary"] >= 0.999):
        raise AssertionError("the FFT-core masks on the card disagree with the CPU port")
    return counts


def check_k3b(dev, B):
    from contextual_image_compression_tpu_torch.measure import device_ms, event_ms
    from contextual_image_compression_tpu_torch.ops.quantize import (
        adaptive_quantize_bwd, adaptive_quantize_bwd_plain)

    gen = torch.Generator(device=dev).manual_seed(4)
    cases = []
    for d in (1024, 512):  # the HQ and LQ latents of one training step
        z = torch.randn(B, d, device=dev, generator=gen) * 2
        g = torch.randn(B, d, device=dev, generator=gen) * 1e-3
        s = torch.rand(B, 1, device=dev, generator=gen)
        q = torch.rand(B, 1, device=dev, generator=gen) * 0.9
        cases.append((z, s, q, g))
    err, worst32, worst16 = 0.0, 0.0, 0.0
    for z, s, q, g in cases:
        scale = torch.exp(3.0 * (q * (1.0 - s)))
        # |dsigma| and |dq| bars: the row's sum of |term| times the chain
        # factor, term = g * rint(z * s) / s^2, chain = 3 s q or 3 s (1 - sigma)
        mag = (g * torch.round(z * scale)).abs().sum(1, keepdim=True) / scale * 3.0
        for dt in (torch.float32, torch.bfloat16):
            zd, gd = z.to(dt), g.to(dt)
            got = adaptive_quantize_bwd(zd, s, q, gd)
            want = adaptive_quantize_bwd_plain(zd, s, q, gd)
            for x, y, chain in zip(got, want, (q, 1.0 - s)):
                diff = (x - y).abs()
                err = max(err, diff.max().item())
                if dt == torch.float32:
                    worst32 = max(worst32, (diff / (mag * chain.abs())).max().item())
                else:
                    worst16 = max(worst16, (diff / y.abs().clamp(min=1e-30)).max().item())
    torch.cuda.synchronize()
    log(f"K3b quantizer backward (16,1024)+(16,512): max |kernel - twin| = {err:.3e}; float32 "
        f"{worst32:.2e} of sum |term| x chain (bar 1e-5), bf16 {worst16:.2e} relative (bar 1e-2)")
    if not (worst32 <= 1e-5 and worst16 <= 1e-2):
        raise AssertionError(f"K3b disagrees with its twin: float32 {worst32}, bf16 {worst16}")

    def pair(fn):
        return lambda: [fn(z, s, q, g) for z, s, q, g in cases]

    z, s, q, g = cases[0]
    per_call = one_kernel_per_call("K3b", lambda: adaptive_quantize_bwd(z, s, q, g),
                                   adaptive_quantize_bwd, "quant_bwd_kernel")
    ms = event_ms(pair(adaptive_quantize_bwd))
    dev_ms = device_ms(pair(adaptive_quantize_bwd))
    plain = event_ms(pair(adaptive_quantize_bwd_plain))
    # float32 training path: z and g read once, sigma and q read, dsigma and
    # dq written; ~6 operations per element (z s, rint, divide, negate,
    # multiply by g, add)
    nbytes = sum(z.numel() * 4 * 2 + B * 4 * 4 for z, _, _, _ in cases)
    ops = sum(z.numel() * 6 for z, _, _, _ in cases)
    b_ms, b_by = bound_ms(nbytes, ops, H100_FP32_TFLOPS)
    log(f"K3b times (two launches of one step, float32): kernel {ms:.4f} ms (device alone "
        f"{dev_ms:.4f}), twin {plain:.4f} ms, bound {b_ms:.6f} ms ({b_by}), library none")
    return dict(name="K3b adaptive_quantize_bwd", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/quantize.cu",
                replaces="contextual_image_compression_tpu/ops/quantize.py:127",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_ms=dev_ms, launches_per_call=per_call)


# The tiny codec of the CPU training tests, with 64 channels at the attention
# stage (K2's value tiles are 64 wide; narrower widths are zero-padded).
TINY_TRAIN = dict(img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 64, 32),
                  generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32)


# The tiny codec of the JAX-trained checkpoint in tests/fixtures/jax_tiny_gan
# (24 channels at the attention stage: Dk 3, Dv 24, N 16).
JAX_TINY = dict(img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 24, 32),
                generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32)


def _component_grads(codec):
    from contextual_image_compression_tpu_torch.models.adaptive import ALL_CODEC_COMPONENTS

    return {n: torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in getattr(codec, n).parameters()]).double().cpu()
            for n in ALL_CODEC_COMPONENTS}


def _train_snapshot(state):
    """Weights, BatchNorm statistics, optimizer states and step of a train state."""
    opts = (state.g_opt, state.ls_opt, state.rd_opt, state.d_opt)
    return dict(codec={k: v.detach().cpu().clone() for k, v in state.codec.state_dict().items()},
                disc={k: v.detach().cpu().clone() for k, v in state.disc.state_dict().items()},
                opts=[copy.deepcopy(o.adam.state_dict()) for o in opts], step=state.step)


def _train_restore(state, snap):
    state.codec.load_state_dict(snap["codec"])
    state.disc.load_state_dict(snap["disc"])
    for o, sd in zip((state.g_opt, state.ls_opt, state.rd_opt, state.d_opt), snap["opts"]):
        o.adam.load_state_dict(copy.deepcopy(sd))
    state.step = snap["step"]


class _PinnedVggDecisions:
    """Within the block, VGG19's ReLU masks and max-pool positions on the
    card are those of the CPU step just before it: each CPU call records
    its decisions in order, and the card's matching call replays them. The
    card's VGG19 still computes every value; only which elements pass a
    ReLU or win a pool comes from the CPU. Without this, a pre-activation
    within ~1e-6 of zero falls on the other side of a ReLU when the card's
    blended image differs from the CPU's by float32 rounding, and one such
    flip moves the step's codec gradients by ~1e-4 relative L2 whatever the
    port's kernels compute: K2's twin, run on the card in place of its
    kernel, moved them by 1.21e-4, and with the decisions pinned the step
    agrees to ~3e-6 (cuDNN convolutions included)."""

    def __enter__(self):
        import collections
        import types

        import torch.nn.functional as F
        from contextual_image_compression_tpu_torch.models import vgg

        queue = collections.deque()

        def replay(x):
            if not queue:
                raise AssertionError("the card's VGG19 made a call the CPU step did not")
            return queue.popleft().to(x.device)

        def relu(x):
            if x.device.type == "cpu":
                queue.append(x > 0)
                return F.relu(x)
            mask = replay(x)
            if mask.shape != x.shape:
                raise AssertionError(f"VGG19 ReLU {tuple(x.shape)} against {tuple(mask.shape)}")
            return x * mask

        def max_pool2d(x, kernel_size, stride=None):
            if x.device.type == "cpu":
                out, idx = F.max_pool2d(x, kernel_size, stride, return_indices=True)
                queue.append(idx)
                return out
            idx = replay(x)
            return x.flatten(2).gather(2, idx.flatten(2)).view(idx.shape)

        self.queue, self.vgg, self.saved = queue, vgg, vgg.F
        vgg.F = types.SimpleNamespace(relu=relu, max_pool2d=max_pool2d)
        return self

    def drained(self):
        if self.queue:
            raise AssertionError(f"{len(self.queue)} VGG19 decisions of the CPU step unused")

    def __exit__(self, *exc):
        self.vgg.F = self.saved


def _small_train_step_agreement(dev, label):
    """Two steps (with D, then without) of a tiny codec (TINY_TRAIN) on the
    CPU (twins), with seeded weights, batch and random VGG19 in bn_mode
    'train'; the card (kernels) runs each step from the CPU's state before
    it. Bars, as the CPU tests against JAX state them: losses within 1e-4
    relative, each component's gradient within 1e-4 relative L2, the
    parameters after the step within 1e-6 on >= 99.9% of elements and 2 lr
    everywhere (Adam's first steps move a parameter by ~lr whatever the size
    of its gradient, so gradients at rounding level, such as those of a bias
    feeding a batch-statistics BatchNorm, flip), BatchNorm statistics within
    1e-6. VGG19's ReLU and max-pool decisions on the card are the CPU's
    (_PinnedVggDecisions). Returns (loss, gradient, share, worst,
    statistics) errors."""
    from contextual_image_compression_tpu_torch.config import (
        ModelConfig, QuantizerConfig, TrainConfig)
    from contextual_image_compression_tpu_torch.measure import randomize_stats
    from contextual_image_compression_tpu_torch.models.vgg import load_vgg19_features
    from contextual_image_compression_tpu_torch.train.gan_trainer import Batch, GANStepBuilder

    mcfg = ModelConfig(**TINY_TRAIN, quantizer=QuantizerConfig(grad_mode="reference"))
    cfg = TrainConfig(model=mcfg, batch_size=4, vgg_weights_path="random:0")
    rng = np.random.RandomState(7)
    arrays = (rng.rand(4, 3, 32, 32).astype(np.float32) * 2 - 1,
              rng.rand(4, 1, 32, 32).astype(np.float32),
              np.array([[0.1], [1.0], [2.0], [1.0]], np.float32))
    cpu_vgg = load_vgg19_features(cfg.vgg_weights_path, device="cpu")
    sides = []
    for d in (torch.device("cpu"), dev):
        vgg = load_vgg19_features(cfg.vgg_weights_path, device=d)
        vgg.load_state_dict(cpu_vgg.state_dict())
        builder = GANStepBuilder(cfg, vgg=vgg, bn_mode="train", device=d)
        sides.append((builder, builder.init_state(0),
                      Batch(*(torch.from_numpy(a).to(d) for a in arrays))))
    randomize_stats(sides[0][1].codec, 3)

    def step(side, do_d):
        builder, state, batch = side
        out = builder.codec_forward(state, batch)
        m = {"d_loss": builder.d_phase(state, batch, out)} if do_d else {}
        m.update(builder.g_backward(state, batch, out))
        grads = _component_grads(state.codec)
        builder.g_update(state)
        sd = {**{f"codec.{k}": v for k, v in state.codec.state_dict().items()},
              **{f"disc.{k}": v for k, v in state.disc.state_dict().items()}}
        return ({k: v.item() for k, v in m.items()}, grads,
                {k: v.double().cpu() for k, v in sd.items()})

    loss_rel = grad_rel = stat_err = worst = 0.0
    share = 1.0
    for do_d in (True, False):
        _train_restore(sides[1][1], _train_snapshot(sides[0][1]))
        with _PinnedVggDecisions() as pinned:
            (mc, gc, pc), (mg, gg, pg) = step(sides[0], do_d), step(sides[1], do_d)
            pinned.drained()
        loss_rel = max([loss_rel] + [abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-12) for k in mc])
        rels = {n: float((gg[n] - gc[n]).norm() / gc[n].norm().clamp(min=1e-30)) for n in gc}
        log(f"  step {'with' if do_d else 'without'} D, gradients relative L2: "
            + ", ".join(f"{n} {r:.1e}" for n, r in rels.items()))
        grad_rel = max([grad_rel] + list(rels.values()))
        stats = [k for k in pc if k.endswith(("running_mean", "running_var"))]
        perr = torch.cat([(pg[k] - pc[k]).abs().reshape(-1) for k in pc if k not in stats])
        share = min(share, float((perr <= 1e-6).double().mean()))
        worst = max(worst, float(perr.max()))
        stat_err = max([stat_err] + [float((pg[k] - pc[k]).abs().max()) for k in stats])
    log(f"small train step card vs CPU ({label}; 32^2, with and without D, bn train, "
        f"perceptual on): losses {loss_rel:.2e} relative, gradients {grad_rel:.2e} relative L2, "
        f"params within 1e-6 on {share:.5f}, max {worst:.2e}, BN statistics {stat_err:.2e}")
    return loss_rel, grad_rel, share, worst, stat_err


def check_small_train_step_against_cpu(dev):
    """The tiny train step on the card against the CPU, at the bars of
    _small_train_step_agreement, with convolutions outside cuDNN. The run
    with cuDNN's float32 convolution algorithms (TF32 off) is printed for
    information; without cuDNN the card's convolutions are float32 GEMMs and
    the step is held to 1e-4; K2, K3 and K3b launch in both runs."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        _small_train_step_agreement(dev, "cuDNN convolutions, information only")
    with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
        loss_rel, grad_rel, share, worst, stat_err = _small_train_step_agreement(
            dev, "convolutions without cuDNN")
    from contextual_image_compression_tpu_torch.config import TrainConfig

    lr = TrainConfig().learning_rate
    log(f"  bars: losses 1e-4, gradients 1e-4, params 0.999 within 1e-6 and {2 * lr:.0e} "
        f"everywhere, BN statistics 1e-6")
    if not (loss_rel <= 1e-4 and grad_rel <= 1e-4 and share >= 0.999 and worst <= 2 * lr
            and stat_err <= 1e-6):
        raise AssertionError("the training step on the card disagrees with the CPU step")


def check_small_mixed_step_against_cpu(dev):
    """Two mixed-precision steps (with D, then without) of the tiny codec
    (TINY_TRAIN with dtype bfloat16, param_dtype float32) on the CPU and on
    the card, each card step from the CPU's state before it, VGG19's
    decisions pinned to the CPU's, bn_mode 'train'. bf16 rounds differently
    on the two (cuDNN's and the CPU's bf16 convolutions accumulate in other
    orders) and the bars are bf16's: metrics within 1% or 2e-4; each
    component's gradient within 0.1 relative L2; the parameter updates'
    signs equal on >= 98% and the updates within 0.1 lr on >= 97% and
    within 2.01 lr everywhere (one Adam step each from one start, opposite
    signs part by 2 lr); the encoders' batch statistics within 2% (means,
    of the channel's RMS) and 5% (variances), the generators' within 10%
    and 25% (tests/test_torch_mixed_precision.py's bars against JAX, where
    quantizer symbols flip); parameters, BN statistics and Adam moments
    float32 on the card; on the card each step launches K2 once on
    "wgmma", K3 twice and K3b twice. (Measured on an NVIDIA H100 80GB HBM3
    at 700 W: metrics within 1.2e-7, gradients 1.3e-2, signs 99.75%,
    within 0.1 lr 99.45%, max 1.992 lr.)"""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import (
        ModelConfig, QuantizerConfig, TrainConfig)
    from contextual_image_compression_tpu_torch.measure import randomize_stats
    from contextual_image_compression_tpu_torch.models.layers import KBatchNorm
    from contextual_image_compression_tpu_torch.models.vgg import load_vgg19_features
    from contextual_image_compression_tpu_torch.train.gan_trainer import Batch, GANStepBuilder

    mcfg = ModelConfig(**TINY_TRAIN, **MIXED, quantizer=QuantizerConfig(grad_mode="reference"))
    cfg = TrainConfig(model=mcfg, batch_size=4, vgg_weights_path="random:0")
    lr = cfg.learning_rate
    rng = np.random.RandomState(7)
    arrays = (rng.rand(4, 3, 32, 32).astype(np.float32) * 2 - 1,
              rng.rand(4, 1, 32, 32).astype(np.float32),
              np.array([[0.1], [1.0], [2.0], [1.0]], np.float32))
    cpu_vgg = load_vgg19_features(cfg.vgg_weights_path, device="cpu")
    sides = []
    for d in (torch.device("cpu"), dev):
        vgg = load_vgg19_features(cfg.vgg_weights_path, device=d)
        vgg.load_state_dict(cpu_vgg.state_dict())
        builder = GANStepBuilder(cfg, vgg=vgg, bn_mode="train", device=d)
        sides.append((builder, builder.init_state(0),
                      Batch(*(torch.from_numpy(a).to(d) for a in arrays))))
    randomize_stats(sides[0][1].codec, 3)

    def step(side, do_d):
        builder, state, batch = side
        start = {k: p.detach().double().cpu() for k, p in state.codec.named_parameters()}
        out = builder.codec_forward(state, batch)
        m = {"d_loss": builder.d_phase(state, batch, out)} if do_d else {}
        m.update(builder.g_backward(state, batch, out))
        grads = _component_grads(state.codec)
        stats = {n: [t.double().cpu() for t in mod.pending]
                 for n, mod in state.codec.named_modules() if isinstance(mod, KBatchNorm)}
        builder.g_update(state)
        upd = {k: p.detach().double().cpu() - start[k] for k, p in state.codec.named_parameters()}
        return {k: v.item() for k, v in m.items()}, grads, stats, upd

    loss_err, grad_rel, sign, within, worst, stat_err = {}, 0.0, 1.0, 1.0, 0.0, 0.0
    for do_d in (True, False):
        _train_restore(sides[1][1], _train_snapshot(sides[0][1]))
        before = launch_counts()
        with _PinnedVggDecisions() as pinned:
            (mc, gc, sc, uc), (mg, gg, sg, ug) = step(sides[0], do_d), step(sides[1], do_d)
            pinned.drained()
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        if delta != expect(K2=1, K3=2, K3b=2):
            raise AssertionError(f"tiny mixed step on the card launched {delta}")
        for k in mc:
            err = abs(mg[k] - mc[k])
            loss_err[k] = err if err <= 2e-4 else err / max(abs(mc[k]), 1e-30)
        if any(e > 1e-2 and e > 2e-4 for e in loss_err.values()):
            raise AssertionError(f"tiny mixed step metrics card vs CPU: {loss_err}")
        rels = {n: float((gg[n] - gc[n]).norm() / gc[n].norm().clamp(min=1e-30)) for n in gc}
        grad_rel = max([grad_rel] + list(rels.values()))
        u_c = torch.cat([uc[k].reshape(-1) for k in uc])
        u_g = torch.cat([ug[k].reshape(-1) for k in uc])
        sign = min(sign, float((torch.sign(u_c) == torch.sign(u_g)).double().mean()))
        within = min(within, float(((u_g - u_c).abs() <= 0.1 * lr).double().mean()))
        worst = max(worst, float((u_g - u_c).abs().max()))
        for n, (mean_c, var_c) in sc.items():
            mean_g, var_g = sg[n]
            rms = (var_c + mean_c ** 2).sqrt() + 1e-6
            bars = (2e-2, 5e-2) if "encoder" in n else (1e-1, 2.5e-1)
            e_m = float(((mean_g - mean_c).abs() / rms).max())
            e_v = float(((var_g - var_c).abs() / (var_c + 1e-6)).max())
            stat_err = max(stat_err, e_m / bars[0], e_v / bars[1])
        log(f"  mixed step {'with' if do_d else 'without'} D, gradients relative L2: "
            + ", ".join(f"{n} {r:.1e}" for n, r in rels.items()))
    dtypes = _float_dtypes(sides[1][1])
    worst_loss = max(loss_err, key=loss_err.get)
    log(f"small mixed train step card vs CPU (32^2, bf16 activations, float32 parameters, with "
        f"and without D, bn train, perceptual on): worst metric {worst_loss} "
        f"{loss_err[worst_loss]:.2e} (bar 1e-2 relative or 2e-4), gradients {grad_rel:.2e} "
        f"relative L2 (bar 0.1), update signs equal {sign:.4f} (bar 0.98), updates within "
        f"0.1 lr {within:.4f} (bar 0.97), max {worst / lr:.3f} lr (bar 2.01), BN batch "
        f"statistics at {stat_err:.2e} of their bars; card state {sorted(map(str, dtypes))}")
    if not (grad_rel <= 0.1 and sign >= 0.98 and within >= 0.97 and worst <= 2.01 * lr
            and stat_err <= 1.0 and dtypes == {torch.float32}):
        raise AssertionError("the mixed training step on the card disagrees with the CPU step")


def run_full_training(dev, card, model_dir):
    """The training main path at full width, its fit writing the 'final'
    checkpoint into model_dir; then the save timed on its own and the
    resume check (check_full_resume). Returns the path's launch counts."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import TrainConfig
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.data.pipeline import (
        CompressionDataset, prepare_masks)
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer
    from contextual_image_compression_tpu_torch.utils.tree import param_bytes

    cfg = TrainConfig(vgg_weights_path="random:0", model_dir=model_dir)
    imgs = synthetic_images(32, cfg.model.img_size, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    masks = prepare_masks(imgs, cfg.saliency, device=dev)
    t_mask = time.perf_counter() - t0
    ds = CompressionDataset(imgs, masks, batch_size=cfg.batch_size, seed=cfg.seed,
                            device_resident=True, device=dev)
    trainer = GANTrainer(cfg, device=dev, log_fn=log)
    state = trainer.init_state(resume=False)
    n_params = sum(p.numel() for m in (state.codec, state.disc) for p in m.parameters())
    comps = ("hq_encoder", "hq_generator", "lq_encoder", "lq_generator", "latent_saliency_hq",
             "latent_saliency_lq", "rd_optimizer")
    before = {n: [p.detach().clone() for p in getattr(state.codec, n).parameters()]
              for n in comps}
    before["discriminator"] = [p.detach().clone() for p in state.disc.parameters()]
    stats_before = state.codec.hq_generator.bn0.running_mean.clone()
    t0 = time.perf_counter()
    trainer.builder.train_step(state, next(ds.epoch()), True)  # warm-up: cuDNN autotuning
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    state_bytes = param_bytes(state.codec) + param_bytes(state.disc) + 2 * 4 * n_params
    free = shutil.disk_usage(model_dir).free
    if free < 2 * state_bytes:
        raise AssertionError(f"the train-state checkpoint needs ~{state_bytes / 1e9:.2f} GB and room "
                             f"to rewrite it; {model_dir} has {free / 1e9:.2f} GB free")
    hist = trainer.fit(ds, epochs=1, steps_per_epoch=4, artifacts=False)  # saves 'final'
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    probe = trainer.rate_control_probe(ds.first_samples())
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = expect(K1=1, K2=5 + 3, K3=2 * 5 + 2 * 3, K3b=2 * 5)
    if counts != want:
        raise AssertionError(f"training launches {counts}, want {want}")
    check_cluster_route("training")
    check_attention_route("training", "tf32x3")
    bad = [k for k, v in hist.items() if not all(math.isfinite(x) for x in v)]
    bad += [f"probe {b}" for b, r, g in probe if not (math.isfinite(r) and math.isfinite(g))]
    if bad:
        raise AssertionError(f"non-finite training metrics: {bad}")
    params = dict(state.codec.named_children())
    params["discriminator"] = state.disc
    still = [n for n, ps in before.items()
             if all(torch.equal(a, b) for a, b in zip(ps, params[n].parameters()))]
    if still:
        raise AssertionError(f"parameters did not move: {still}")
    if torch.equal(stats_before, state.codec.hq_generator.bn0.running_mean):
        raise AssertionError("BatchNorm running statistics did not move in bn_mode 'train'")
    if state.step != 5:
        raise AssertionError(f"step counter {state.step}, want 5")
    check_full_resume(trainer, ds, card)

    # step times outside the counted main path, alternating D / no D
    md, mnd = _step_ms(trainer, ds)
    bsz = cfg.batch_size
    log(f"full-width GAN training on {card} (TrainConfig() defaults, float32, TF32 off, "
        f"random VGG19 perceptual): {n_params / 1e6:.1f}M trainable parameters; masks of "
        f"{len(imgs)} images {t_mask * 1e3:.1f} ms; warm-up step {t_warm:.2f} s; fit 4 steps {t_fit:.3f} s")
    log(f"step with D {md * 1e3:.2f} ms, without D {mnd * 1e3:.2f} ms (median of 3 each, "
        f"CUDA-synchronized host clock); {2 * bsz / (md + mnd):.1f} img/s on the alternating "
        f"schedule; peak memory {peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated); "
        f"launches {counts}")
    log(f"history {json.dumps(hist)}; probe {probe}")
    return counts, (md, mnd)


MIXED = dict(dtype="bfloat16", param_dtype="float32")


def _float_dtypes(state):
    """The dtypes of a train state's parameters, floating buffers and Adam
    moments, in one set."""
    tensors = [t for m in (state.codec, state.disc)
               for t in list(m.parameters()) + list(m.buffers())
               if t is not None and t.is_floating_point()]
    tensors += [v for o in (state.g_opt, state.ls_opt, state.rd_opt, state.d_opt)
                for st in o.adam.state.values() for k, v in st.items() if k != "step"]
    return {t.dtype for t in tensors}


def _step_ms(trainer, ds, steps=6):
    """Median ms of steps with and without D, alternating, on the
    CUDA-synchronized host clock."""
    t_d, t_nd = [], []
    it = ds.epoch()
    for i in range(steps):
        batch = next(it, None)
        if batch is None:
            it = ds.epoch()
            batch = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.builder.train_step(trainer.state, batch, i % 2 == 0)
        torch.cuda.synchronize()
        (t_d if i % 2 == 0 else t_nd).append(time.perf_counter() - t0)
    return float(np.median(t_d)), float(np.median(t_nd))


def run_mixed_training(dev, card, model_dir, f32_times):
    """Mixed-precision training at full width: TrainConfig() with
    ModelConfig(dtype='bfloat16', param_dtype='float32') and random VGG19
    (which stays float32, as in JAX's recipe): masks of 32 images through
    K1, one warm-up step, fit for 4 steps (writing 'final' into model_dir),
    the rate-control probe, and a fresh trainer's resume of that checkpoint,
    bitwise. Fails unless every metric is finite, parameters, BatchNorm
    statistics and Adam moments are float32 and moved, and the launches are
    K1 +1, per step K2 +1 (route "wgmma"), K3 +2 and K3b +2, per probe
    point K2 +1 and K3 +2. Then times 3 steps each with and without D and
    prints them beside the float32 phase's. Returns the path's launch
    counts."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import ModelConfig, TrainConfig
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.data.pipeline import (
        CompressionDataset, prepare_masks)
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer

    cfg = TrainConfig(model=ModelConfig(**MIXED), vgg_weights_path="random:0",
                      model_dir=model_dir)
    imgs = synthetic_images(32, cfg.model.img_size, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    masks = prepare_masks(imgs, cfg.saliency, device=dev)
    ds = CompressionDataset(imgs, masks, batch_size=cfg.batch_size, seed=cfg.seed,
                            device_resident=True, device=dev)
    trainer = GANTrainer(cfg, device=dev, log_fn=log)
    state = trainer.init_state(resume=False)
    if _float_dtypes(state) != {torch.float32}:
        raise AssertionError(f"mixed train state dtypes {_float_dtypes(state)}, want float32")
    before = [p.detach().clone() for m in (state.codec, state.disc) for p in m.parameters()]
    stats_before = state.codec.hq_generator.bn0.running_mean.clone()
    t0 = time.perf_counter()
    trainer.builder.train_step(state, next(ds.epoch()), True)  # warm-up: cuDNN autotuning
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    hist = trainer.fit(ds, epochs=1, steps_per_epoch=4, artifacts=False)  # saves 'final'
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    probe = trainer.rate_control_probe(ds.first_samples())
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = expect(K1=1, K2=5 + 3, K3=2 * 5 + 2 * 3, K3b=2 * 5)
    if counts != want:
        raise AssertionError(f"mixed training launches {counts}, want {want}")
    check_cluster_route("mixed training")
    check_attention_route("mixed training", "wgmma")
    bad = [k for k, v in hist.items() if not all(math.isfinite(x) for x in v)]
    bad += [f"probe {b}" for b, r, g in probe if not (math.isfinite(r) and math.isfinite(g))]
    if bad:
        raise AssertionError(f"non-finite mixed training metrics: {bad}")
    dtypes = _float_dtypes(state)
    after = [p for m in (state.codec, state.disc) for p in m.parameters()]
    still = sum(torch.equal(a, b) for a, b in zip(before, after))
    if dtypes != {torch.float32} or still > 0.1 * len(after):
        raise AssertionError(f"mixed train state: dtypes {dtypes}, {still} of {len(after)} "
                             "parameter tensors did not move")
    if torch.equal(stats_before, state.codec.hq_generator.bn0.running_mean):
        raise AssertionError("BatchNorm running statistics did not move in mixed training")
    t0 = time.perf_counter()
    restored = GANTrainer(cfg, device=dev, log_fn=lambda msg: None).init_state(resume=True)
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    differ = _states_equal(state, restored)
    if differ:
        raise AssertionError(f"the resumed mixed train state differs: {differ[:10]}")
    del restored
    md, mnd = _step_ms(trainer, ds)
    bsz = cfg.batch_size
    f_d, f_nd = f32_times
    log(f"mixed-precision GAN training on {card} (TrainConfig() with ModelConfig(dtype="
        f"'bfloat16', param_dtype='float32'), random VGG19 in float32): warm-up step "
        f"{t_warm:.2f} s; fit 4 steps {t_fit:.3f} s; parameters, BN statistics and Adam moments "
        f"{sorted(str(d) for d in dtypes)}; 'final' resumed bitwise in {t_resume:.2f} s")
    log(f"mixed step with D {md * 1e3:.2f} ms, without D {mnd * 1e3:.2f} ms (median of 3 each, "
        f"CUDA-synchronized host clock); {2 * bsz / (md + mnd):.1f} img/s on the alternating "
        f"schedule; peak memory {peak / 2 ** 30:.2f} GiB; float32 in this run: with D "
        f"{f_d * 1e3:.2f} ms, without D {f_nd * 1e3:.2f} ms, {2 * bsz / (f_d + f_nd):.1f} img/s; "
        f"launches {counts}")
    log(f"mixed history {json.dumps(hist)}; probe {probe}")
    return counts


def _states_equal(a, b):
    """Names of the tensors or values in which two GAN train states differ
    bit for bit: parameters, buffers, Adam exp_avg / exp_avg_sq / step, the
    step counter."""
    bad = []
    for name in ("codec", "disc"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        if list(sa) != list(sb):
            bad.append(f"{name} keys")
        bad += [f"{name}.{k}" for k in sa if k in sb and not torch.equal(sa[k], sb[k])]
    for opt in ("g_opt", "ls_opt", "rd_opt", "d_opt"):
        oa, ob = getattr(a, opt), getattr(b, opt)
        for i, (pa, pb) in enumerate(zip(oa.params, ob.params)):
            ta, tb = oa.adam.state.get(pa, {}), ob.adam.state.get(pb, {})
            if set(ta) != set(tb):
                bad.append(f"{opt}[{i}] state keys")
                continue
            for key in ta:
                if not torch.equal(ta[key].cpu(), tb[key].cpu()):
                    bad.append(f"{opt}[{i}].{key}")
    if a.step != b.step:
        bad.append("step")
    return bad


def check_full_resume(trainer, ds, card):
    """Phase (c) at full width: the 'final' checkpoint that fit wrote in
    background mode (saved once more here to time it alone: the blocking
    part, the clone on the card, and the whole, written), restored by a
    fresh GANTrainer(...).init_state(resume=True) on the card; every
    parameter, BN statistic, Adam moment and step, and the step counter
    bitwise equal, the history equal; then one step with D from each on the
    same batch, losses within 1e-5 relative (cuDNN's backward may use
    atomics)."""
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.save("final")
    t_block = time.perf_counter() - t0
    trainer._join_saver()
    t_whole = time.perf_counter() - t0
    model_dir = trainer.cfg.model_dir
    nbytes = sum(os.path.getsize(os.path.join(model_dir, f)) for f in os.listdir(model_dir)
                 if f.endswith("_final.msgpack"))
    t0 = time.perf_counter()
    fresh = GANTrainer(trainer.cfg, device=trainer.device, log_fn=lambda msg: None)
    restored = fresh.init_state(resume=True)
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    bad = _states_equal(trainer.state, restored)
    log(f"train-state checkpoint at full width on {card}: {nbytes / 1e9:.3f} GB in 9 files; "
        f"background save: blocking part (clone on the card) {t_block:.3f} s, whole (converted, "
        f"written) {t_whole:.2f} s, {nbytes / 1e9 / t_whole:.2f} GB/s; resume (build, read, "
        f"convert, load on the card) {t_resume:.2f} s, {nbytes / 1e9 / t_resume:.2f} GB/s; "
        f"tensors differing bitwise: {len(bad)}; history equal: {fresh.history == trainer.history}")
    if bad or fresh.history != trainer.history or fresh.start_epoch != 1:
        raise AssertionError(f"the resumed train state differs: {bad[:10]}, history "
                             f"{fresh.history == trainer.history}, epoch {fresh.start_epoch}")
    batch = next(ds.epoch())
    _, m_a = trainer.builder.train_step(trainer.state, batch, True)
    _, m_b = fresh.builder.train_step(restored, batch, True)
    rel = max(abs(m_b[k].item() - m_a[k].item()) / max(abs(m_a[k].item()), 1e-30) for k in m_a)
    log(f"one step with D from the writer's state and from the resumed one: losses within {rel:.2e} "
        f"relative (bar 1e-5)")
    if not rel <= 1e-5:
        raise AssertionError(f"the resumed state steps differently: {rel}")
    del fresh, restored


def check_small_checkpoint_modes(dev):
    """At the tiny config on the card: a 'host' mode save of a trained state,
    the same state saved in 'background' mode into another directory,
    byte-identical files, resumed bitwise; and nan_guard's FloatingPointError
    on a NaN put into one parameter."""
    from contextual_image_compression_tpu_torch.checkpoint import CheckpointStore
    from contextual_image_compression_tpu_torch.config import (
        ModelConfig, QuantizerConfig, TrainConfig)
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.data.pipeline import CompressionDataset
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer

    mcfg = ModelConfig(**JAX_TINY, quantizer=QuantizerConfig(grad_mode="reference"))
    imgs = synthetic_images(8, (32, 32), seed=90)
    masks = np.random.RandomState(90).rand(8, 32, 32, 1).astype(np.float32)
    ds = CompressionDataset(imgs, masks, batch_size=4, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        host_dir, bg_dir = os.path.join(tmp, "host"), os.path.join(tmp, "background")
        cfg = TrainConfig(model=mcfg, batch_size=4, use_perceptual=False, model_dir=host_dir)
        trainer = GANTrainer(cfg, device=dev, log_fn=lambda msg: None, save_mode="host")
        trainer.init_state(resume=False)
        trainer.fit(ds, epochs=1, steps_per_epoch=2, artifacts=False)  # 'final', host mode
        trainer.save_mode, trainer.store = "background", CheckpointStore(bg_dir)
        trainer.save("final")
        trainer._join_saver()
        names = sorted(os.listdir(host_dir))
        differ = [n for n in names if pathlib.Path(host_dir, n).read_bytes()
                  != pathlib.Path(bg_dir, n).read_bytes()]
        fresh = GANTrainer(cfg, device=dev, log_fn=lambda msg: None)
        bad = _states_equal(trainer.state, fresh.init_state(resume=True))
        guard = GANTrainer(TrainConfig(model=mcfg, batch_size=4, use_perceptual=False,
                                       model_dir=os.path.join(tmp, "guard")),
                           device=dev, log_fn=lambda msg: None, nan_guard=True)
        state = guard.init_state(resume=False)
        with torch.no_grad():
            state.codec.lq_generator.deconv2.weight[0, 0, 1, 1] = float("nan")
        try:
            guard.fit(ds, epochs=1, steps_per_epoch=1, artifacts=False)
            raised = ""
        except FloatingPointError as exc:
            raised = str(exc)
    log(f"tiny config on the card: 'host' and 'background' saves of one state, {len(names)} files, "
        f"{len(differ)} differ; resumed from the 'host' files, {len(bad)} tensors differ; "
        f"nan_guard raised FloatingPointError: {bool(raised)} ({raised[:90]}...)")
    if differ or bad or len(names) != 10 or "lq_generator.deconv2.weight" not in raised:
        raise AssertionError(f"checkpoint modes: differ {differ}, resumed {bad[:5]}, "
                             f"guard {raised[:200]!r}")


def run_jax_trained_serving(dev, card):
    """Phase (a): the committed JAX-trained tiny GAN served on the card from
    its model_dir: provenance all 'final'; against the JAX pipeline's
    committed outputs and against the port's CPU pipeline on the same
    files, decoded PSNR >= 40 dB and symbols within +-1 and >= 95% identical
    (the mask, too, within 1e-4 of the CPU's). Returns the launch counts of
    the call."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import ModelConfig
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    fixture = pathlib.Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_tiny_gan"
    ref = np.load(fixture / "outputs.npz")
    u8, bpp = ref["images"], float(ref["target_bpp"])
    cfg = ModelConfig(**JAX_TINY)
    pipe = CompressionPipeline(model_dir=str(fixture), model_config=cfg, device=dev)
    if sorted(pipe.provenance.values()) != ["final"] * 7:
        raise AssertionError(f"provenance {pipe.provenance}")
    pipe(u8, target_bpp=bpp)  # warm-up of the batch shape
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    dec, info = pipe(u8, target_bpp=bpp)
    counts = launch_counts()
    if counts != expect(K1=1, K2=1, K3=2):
        raise AssertionError(f"JAX-trained serving launches {counts}, want K1 1, K2 1, K3 2")
    check_cluster_route("JAX-trained serving")
    check_attention_route("JAX-trained serving", "wgmma")
    cpu_dec, cpu_info = CompressionPipeline(model_dir=str(fixture), model_config=cfg,
                                            device="cpu")(u8, target_bpp=bpp)

    def psnr(a, b):
        mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
        return 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))

    sym = {k: info[k].float().cpu().numpy() for k in ("hq_symbols", "lq_symbols")}
    rows = {}
    for name, (d, s) in {"JAX's outputs": (ref["decoded"], ref),
                         "the CPU port": (cpu_dec, {k: cpu_info[k].float().numpy() for k in sym})
                         }.items():
        rows[name] = (psnr(dec, d), min(float(np.mean(sym[k] == s[k])) for k in sym),
                      max(float(np.abs(sym[k] - s[k]).max()) for k in sym))
    mask_err = float((info["mask"].float().cpu() - cpu_info["mask"].float()).abs().max())
    nonzero = float(np.mean(np.concatenate([v.ravel() for v in sym.values()]) != 0))
    log(f"JAX-trained tiny GAN (tests/fixtures/jax_tiny_gan, 32^2, B = {len(u8)}) served on {card} "
        f"from model_dir, provenance all 'final': " + "; ".join(
            f"vs {n}: decoded PSNR {p:.2f} dB, symbols identical {same:.4f}, max |diff| {mx}"
            for n, (p, same, mx) in rows.items())
        + f"; mask vs the CPU port {mask_err:.3e} (bars 40 dB, 0.95, 1, 1e-4); nonzero symbols "
          f"{nonzero:.4f} (four steps of training leave the latents below half a quantizer step)")
    if not (all(p >= 40.0 and same >= 0.95 and mx <= 1.0 for p, same, mx in rows.values())
            and mask_err <= 1e-4):
        raise AssertionError(f"JAX-trained serving disagrees: {rows}, mask {mask_err}")
    return counts


def run_checkpoint_serving(dev, card):
    """Phase (b): the seeded full-width codec's float32 state carried to
    JAX's layout and saved by the store into a temporary directory (1.67
    GB), then CompressionPipeline(model_dir=...) against the pipeline built
    from the same state dict at B = 16: decoded images and symbols bitwise
    equal (cuDNN's deterministic algorithms in both). Returns the launch
    counts of the checkpoint pipeline's call."""
    from contextual_image_compression_tpu_torch import convert, ops
    from contextual_image_compression_tpu_torch.checkpoint import CheckpointStore
    from contextual_image_compression_tpu_torch.measure import structured_images
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline
    from contextual_image_compression_tpu_torch.utils.tree import param_bytes

    codec = _full_width_codec(dev)
    sd = {k: v.clone() for k, v in codec.state_dict().items()}
    B = 16
    u8 = structured_images(np.random.RandomState(21), B, 256)
    with tempfile.TemporaryDirectory() as tmp:
        need = param_bytes(sd)
        free = shutil.disk_usage(tmp).free
        if free < 2 * need:
            raise AssertionError(f"the codec checkpoint needs {need / 1e9:.2f} GB; {tmp} has "
                                 f"{free / 1e9:.2f} GB free")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CheckpointStore(tmp).save_components(convert.codec_variables(codec), "final")
        t_write = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp))
        del codec
        t0 = time.perf_counter()
        pipe = CompressionPipeline(model_dir=tmp, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    if sorted(pipe.provenance.values()) != ["final"] * 7:
        raise AssertionError(f"provenance {pipe.provenance}")
    direct = CompressionPipeline(state_dict=sd, device=dev)
    del sd
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
        pipe(u8, target_bpp=1.0)  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        dec, info = pipe(u8, target_bpp=1.0)
        counts = launch_counts()
        if counts != expect(K1=1, K2=1, K3=2):
            raise AssertionError(f"checkpoint serving launches {counts}, want K1 1, K2 1, K3 2")
        check_cluster_route("checkpoint serving")
        check_attention_route("checkpoint serving", "wgmma")
        want_dec, want_info = direct(u8, target_bpp=1.0)
    same = [k for k in ("hq_symbols", "lq_symbols", "mask", "bit_allocation")
            if torch.equal(info[k], want_info[k])]
    log(f"full-width serving from a checkpoint on {card}: {nbytes / 1e9:.3f} GB in 7 files; write "
        f"(convert to JAX's layout, copy to the host, write) {t_write:.2f} s, "
        f"{nbytes / 1e9 / t_write:.2f} GB/s; load (seeded build, read, convert, load, w8 and bf16 "
        f"on the card) {t_load:.2f} s, {nbytes / 1e9 / t_load:.2f} GB/s; against the pipeline "
        f"from the state dict at B = {B}: decoded bitwise equal {np.array_equal(dec, want_dec)}, "
        f"bitwise equal {same}")
    if not (np.array_equal(dec, want_dec) and len(same) == 4):
        raise AssertionError("serving from the checkpoint differs from serving the state dict")
    return counts


def run_autoencoder(dev, card):
    """Phase (d): the trained autoencoder of runs/ae_ref on the card:
    reconstructions of 64 seeded synthetic 128^2 images within 1e-5 of the
    CPU port (TF32 off), ae_metrics and images per second; `fit` for 2
    epochs at B = 16 on 128 images (losses finite, the second below the
    first); a save / load round trip bitwise. No kernel of the port runs."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.ops.metrics import ae_metrics
    from contextual_image_compression_tpu_torch.train.ae_trainer import AETrainer

    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the autoencoder is held to the CPU with TF32 off")
    ae_dir = str(pathlib.Path(__file__).resolve().parent / "runs" / "ae_ref" / "model")
    imgs = ((synthetic_images(64, (128, 128), seed=80) + 1.0) / 2.0).astype(np.float32)
    ops.reset_launch_counts()
    card_ae = AETrainer(device=dev, log_fn=log)
    card_ae.load(ae_dir)
    got = card_ae.reconstruct(imgs)
    cpu_ae = AETrainer(device="cpu", log_fn=lambda msg: None)
    cpu_ae.load(ae_dir)
    err = float(np.abs(got - cpu_ae.reconstruct(imgs)).max())
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_ae.reconstruct(imgs)
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))

    def u8(x):
        return torch.from_numpy(np.round(np.clip(x, 0, 1) * 255).astype(np.uint8))

    m = {k: float(v.mean()) for k, v in ae_metrics(u8(imgs), u8(got)).items()}
    train = ((synthetic_images(128, (128, 128), seed=81) + 1.0) / 2.0).astype(np.float32)
    fresh = AETrainer(device=dev, log_fn=log)
    fresh.init(seed=42)
    t0 = time.perf_counter()
    hist = fresh.fit(train, epochs=2, batch_size=16)
    t_fit = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        fresh.save(tmp)
        back = AETrainer(device=dev, log_fn=lambda msg: None)
        back.init(seed=7)
        back.load(tmp)
    same = all(torch.equal(a, b) for a, b in zip(fresh.model.state_dict().values(),
                                                  back.model.state_dict().values()))
    counts = launch_counts()
    log(f"autoencoder from runs/ae_ref on {card}: 64 images 128^2, card vs CPU port max |diff| "
        f"{err:.3e} (bar 1e-5); ae_metrics mean psnr {m['psnr']:.3f} dB, ssim {m['ssim']:.4f}, "
        f"mse {m['mse']:.3f}; reconstruct {med * 1e3:.2f} ms, {64 / med:.1f} img/s (host clock, "
        f"numpy in / out, median of 5); fit 2 epochs at B = 16 on 128 images {t_fit:.2f} s, "
        f"losses {hist['loss']}, val {hist['val_loss']}; save / load bitwise {same}; kernel "
        f"launches {counts}")
    losses = hist["loss"] + hist["val_loss"]
    if not (err <= 1e-5 and all(math.isfinite(x) for x in losses)
            and hist["loss"][1] < hist["loss"][0] and same and counts == expect()):
        raise AssertionError(f"autoencoder: err {err}, history {hist}, round trip {same}, "
                             f"launches {counts}")


MASK_METHODS = ("spectral_residual", "fine_grained")


def check_k4(dev, B):
    from contextual_image_compression_tpu_torch.data.images import rich_synthetic_images
    from contextual_image_compression_tpu_torch.measure import device_ms, event_ms
    from contextual_image_compression_tpu_torch.ops import image_ops, saliency
    from contextual_image_compression_tpu_torch.ops.fused_mask import (
        smooth_mask, smooth_mask_plain)

    from contextual_image_compression_tpu_torch.ops.fused_mask import (
        _mask_plan, mask_max_clusters)

    imgs = torch.from_numpy(rich_synthetic_images(B, (256, 256), seed=40)).to(dev)
    err, maps, routes = 0.0, {}, set()
    for method in MASK_METHODS:
        sal = saliency.compute_saliency_map(imgs, method).contiguous()
        got, route = _route_of(smooth_mask, lambda: smooth_mask(sal))
        want = smooth_mask_plain(sal)
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item())
        maps[method] = sal
        routes.add(route)
    plan = _mask_plan(256, 256, 0, 4, 31)
    log(f"K4 smooth mask {tuple(sal.shape)}, maps of {' and '.join(MASK_METHODS)}, routes "
        f"{routes} ({plan}; {mask_max_clusters(False, 256, 256)} clusters at once): "
        f"max |kernel - twin| = {err:.3e} (bar 1e-5)")
    if not (err <= 1e-5 and routes == {"cluster"}):
        raise AssertionError(f"K4: routes {routes}, error {err}")
    sal = maps["fine_grained"]
    same = torch.equal(smooth_mask(sal), smooth_mask(sal))
    per_call = one_kernel_per_call("K4", lambda: smooth_mask(sal), smooth_mask, "mask_cluster_kernel")
    sal_t = torch.from_numpy(rich_synthetic_images(2, (512, 512), seed=41)).to(dev)
    sal_t = saliency.compute_saliency_map(sal_t, "fine_grained").contiguous()
    got_t, route_t = _route_of(smooth_mask, lambda: smooth_mask(sal_t))
    err_t = (got_t - smooth_mask_plain(sal_t)).abs().max().item()
    tiled_ms = event_ms(lambda: smooth_mask(sal_t))
    log(f"K4 tiled route {tuple(sal_t.shape)}: {route_t}, max |kernel - twin| = {err_t:.3e} "
        f"(bar 1e-5), {tiled_ms:.4f} ms; cluster route bitwise repeatable: {same}")
    if not (err_t <= 1e-5 and route_t == "tiled" and same):
        raise AssertionError(f"K4 tiled route: {route_t}, error {err_t}; repeatable {same}")
    ms = event_ms(lambda: smooth_mask(sal))
    dev_ms = device_ms(lambda: smooth_mask(sal))
    plain = event_ms(lambda: smooth_mask_plain(sal), reps=5, warmup=1)
    # Operations the function needs per pixel: 7 per bilateral tap (the
    # difference, its square, the weight, two accumulations) and the final
    # division; a multiply-add per Gaussian tap in each of the two passes;
    # the normalization and its max.
    ntaps = len(image_ops.bilateral_taps(9, 75.0, 75.0))
    ops_per_px = 7 * ntaps + 1 + 2 * 2 * 31 + 2
    nbytes = sal.numel() * 4 * 2
    b_ms, b_by = bound_ms(nbytes, ops_per_px * sal.numel(), H100_FP32_TFLOPS)
    log(f"K4 times: kernel {ms:.4f} ms (device alone {dev_ms:.4f}), twin {plain:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), library none")
    return dict(name="K4 smooth_mask", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/fused_mask.cu",
                replaces="contextual_image_compression_tpu/ops/fused_mask.py:324",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_ms=dev_ms, mask_route="cluster",
                design=MASK_DESIGN.format(cluster=plan.cluster, rows=plan.rows,
                                          kb=plan.smem_bytes / 1024),
                launches_per_call=per_call, deterministic=same, tiled_route_ms=tiled_ms,
                tiled_route_max_abs_err=err_t)


def run_mask_path(dev, card):
    """prepare_masks at full width for both methods, and a batch of binary
    masks; the first images are checked against the port on the CPU.
    Returns the launch counts of the path."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import SaliencyConfig
    from contextual_image_compression_tpu_torch.data.images import rich_synthetic_images
    from contextual_image_compression_tpu_torch.data.pipeline import prepare_masks
    from contextual_image_compression_tpu_torch.ops import masks, saliency

    n, batch, n_cpu = 128, 64, 4
    imgs = rich_synthetic_images(n, (256, 256), seed=60)
    for method in MASK_METHODS:  # warm-up of the batch shapes, outside the counted run
        prepare_masks(imgs[:batch], SaliencyConfig(method=method), device_batch=batch, device=dev)
    ops.reset_launch_counts()
    results = {}
    for method in MASK_METHODS:
        cfg = SaliencyConfig(method=method)
        t0 = time.perf_counter()
        out = prepare_masks(imgs, cfg, device_batch=batch, device=dev)  # ends in a D2H copy
        results[method] = (time.perf_counter() - t0, out)
    x = torch.from_numpy(imgs[:batch]).to(dev)
    sal = saliency.compute_saliency_map(x, "fine_grained")
    binary = masks.create_saliency_mask(sal, smooth=False)
    thresholds = masks.adaptive_threshold(sal)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = expect(K4=2 * (n // batch))
    if counts != want:
        raise AssertionError(f"mask path launches {counts}, want {want}")
    check_cluster_route("mask path")
    for method, (secs, out) in results.items():
        if out.shape != (n, 256, 256, 1) or not np.all(np.isfinite(out)):
            raise AssertionError(f"{method} masks: shape {out.shape} or non-finite values")
        if not (out.min() >= 0.0 and abs(float(out.reshape(n, -1).max(1).min()) - 1.0) <= 1e-5):
            raise AssertionError(f"{method} masks are not max-normalized maps in [0, 1]")
        cpu = prepare_masks(imgs[:n_cpu], SaliencyConfig(method=method), device="cpu")
        err = float(np.abs(out[:n_cpu] - cpu).max())
        log(f"mask path {method}: {n} images in batches of {batch}, {secs * 1e3:.2f} ms, "
            f"{secs * 1e3 / n:.4f} ms/image (host clock, [-1, 1] float numpy in, masks copied "
            f"out) on {card}; card vs CPU port on {n_cpu} images {err:.3e} (bar 1e-4)")
        if not err <= 1e-4:
            raise AssertionError(f"{method} masks on the card disagree with the CPU port: {err}")
    sal_cpu = saliency.compute_saliency_map(torch.from_numpy(imgs[:n_cpu]), "fine_grained")
    bin_cpu = masks.create_saliency_mask(sal_cpu, smooth=False).numpy()
    t_cpu = masks.adaptive_threshold(sal_cpu).numpy()
    same_t = float(np.mean(thresholds[:n_cpu].cpu().numpy() == t_cpu))
    same_b = float(np.mean(binary[:n_cpu].cpu().numpy() == bin_cpu))
    log(f"binary masks (fine_grained, adaptive threshold) of {batch} images: mean threshold "
        f"{thresholds.mean().item():.4f}, foreground {binary.mean().item():.4f}; card vs CPU "
        f"port on {n_cpu} images: thresholds equal {same_t:.3f}, masks equal {same_b:.6f} "
        "(bars 1.0, 0.999)")
    if not (same_t == 1.0 and same_b >= 0.999 and set(binary.unique().tolist()) <= {0.0, 1.0}):
        raise AssertionError("binary masks on the card disagree with the CPU port")
    log(f"mask path launches {counts}")

    # where one batch's time goes (CUDA events, outside the counted run)
    from contextual_image_compression_tpu_torch.measure import event_ms
    from contextual_image_compression_tpu_torch.ops.fused_mask import smooth_mask

    host = np.ascontiguousarray(imgs[:batch])
    stages = {"upload (pageable numpy -> card)": lambda: torch.from_numpy(host).to(dev)}
    for method in MASK_METHODS:
        sal = saliency.compute_saliency_map(x, method).contiguous()
        stages[f"{method} saliency map"] = lambda m=method: saliency.compute_saliency_map(x, m)
    stages["K4 smooth mask"] = lambda: smooth_mask(sal)
    stages["download of the masks"] = lambda: sal[..., None].cpu()
    log(f"mask path stages for B={batch} (CUDA events, median): " + "; ".join(
        f"{name} {event_ms(fn, reps=10, warmup=2):.3f} ms" for name, fn in stages.items()))
    return counts


def _planes_of(imgs):
    from contextual_image_compression_tpu_torch.ops.dct import rgb_to_ycbcr

    return (rgb_to_ycbcr((imgs + 1.0) * 127.5) - 128.0).permute(0, 3, 1, 2).contiguous()


def check_k5(dev, B):
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.measure import device_ms, event_ms
    from contextual_image_compression_tpu_torch.ops.dct import (
        _dct_matrix, dct_strips, dct_strips_plain, quality_tables)

    imgs = torch.from_numpy(synthetic_images(B, (256, 256), seed=50)).to(dev)
    planes = _planes_of(imgs)
    tables = torch.from_numpy(quality_tables(75)).to(dev)
    rec, sym = dct_strips(planes, tables)
    rec_p, sym_p = dct_strips_plain(planes, tables)
    torch.cuda.synchronize()
    b, c, h, w = planes.shape
    same = (sym == sym_p).float().mean().item()
    sym_err = (sym - sym_p).abs().max().item()
    agree = (sym == sym_p).reshape(b, c, h // 8, 8, w // 8, 8).all(5).all(3)
    blk = (rec - rec_p).abs().reshape(b, c, h // 8, 8, w // 8, 8).amax((3, 5))
    rec_err = blk[agree].max().item()
    log(f"K5 DCT strips {tuple(planes.shape)} quality 75: symbols identical {same:.7f} "
        f"(bar 0.9999), max |diff| {sym_err} (bar 1); rec on agreeing blocks {rec_err:.3e} "
        f"(bar 1e-4), over all blocks {blk.max().item():.3e}")
    if not (same >= 0.9999 and sym_err <= 1.0 and rec_err <= 1e-4):
        raise AssertionError(f"K5 disagrees with its twin: {same}, {sym_err}, {rec_err}")

    d = torch.from_numpy(_dct_matrix()).to(dev)
    qt = tables[None, :, None, None]

    def cublas():  # a yardstick the port never calls: batched 8x8 products + round
        t = planes.reshape(b, c, h // 8, 8, w // 8, 8).permute(0, 1, 2, 4, 3, 5)
        s = torch.round((d @ t @ d.T) / qt)
        return d.T @ (s * qt) @ d, s

    ms = event_ms(lambda: dct_strips(planes, tables))
    dev_ms = device_ms(lambda: dct_strips(planes, tables))
    plain = event_ms(lambda: dct_strips_plain(planes, tables), reps=5, warmup=1)
    lib = event_ms(cublas)
    # four 8-term products per coefficient (2 x 8 x 4 operations), the divide,
    # the rounding and the dequantize
    ops_per_px = 2 * 8 * 4 + 3
    nbytes = planes.numel() * 4 * 3
    b_ms, b_by = bound_ms(nbytes, ops_per_px * planes.numel(), H100_FP32_TFLOPS)
    log(f"K5 times: kernel {ms:.4f} ms (device alone {dev_ms:.4f}, {b_ms / dev_ms:.1%} of the "
        f"bound), twin {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library none; cuBLAS "
        f"yardstick (batched 8x8 products + round) {lib:.4f} ms")
    return dict(name="K5 dct_strips", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/dct.cu",
                replaces="contextual_image_compression_tpu/ops/dct.py:152",
                max_abs_err=rec_err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, cublas_yardstick_ms=lib, symbols_identical=same,
                device_ms=dev_ms, design="persistent grid (2 blocks of 256 threads an SM), 4 "
                "tiles a warp, 16-byte loads and streaming stores, D in registers, per-warp "
                "shared transposes under __syncwarp")


def run_dct_path(dev, card):
    """The DCT baseline at full width, as the codec shootout runs it;
    returns the launch counts of the path."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import DCTCodecConfig
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.ops.dct import DCTCodec
    from contextual_image_compression_tpu_torch.ops.metrics import gan_metrics

    n, size, n_streams = 128, (256, 256), 4
    imgs = synthetic_images(n, size, seed=70)
    x = torch.from_numpy(imgs).to(dev)
    DCTCodec(DCTCodecConfig(), device=dev).evaluate(x)  # warm-up, outside the counted run
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rows = []
    for q in (10, 20, 30, 50, 75, 90):
        codec = DCTCodec(DCTCodecConfig(quality=q), device=dev)
        ev = codec.evaluate(x)
        m = gan_metrics(x, ev["reconstruction"])
        sym = ev["symbols"][:n_streams].cpu().numpy()
        measured = float(np.mean([codec.measured_bpp(sym[i], size) for i in range(n_streams)]))
        row = dict(quality=q, bpp_entropy=ev["bpp"].mean().item(), bpp_measured=measured,
                   psnr=m["psnr"].mean().item(), ssim=m["ssim"].mean().item())
        if not all(math.isfinite(v) for v in row.values()) or not 0 < measured < 24:
            raise AssertionError(f"DCT quality {q}: {row}")
        rows.append(row)
        log(f"dct {json.dumps(row)}")
    psnrs = [r["psnr"] for r in rows]
    if not all(a < b for a, b in zip(psnrs, psnrs[1:])):
        raise AssertionError(f"PSNR does not rise with quality: {psnrs}")

    card_codec = DCTCodec(DCTCodecConfig(), device=dev)
    cpu_codec = DCTCodec(DCTCodecConfig(), device="cpu")
    dec_err = 0.0
    same_bytes = 0
    for i in range(2):
        on_card = card_codec.encode_stream(x[i])
        on_cpu = cpu_codec.encode_stream(imgs[i])
        same_bytes += on_card == on_cpu
        for stream in (on_card, on_cpu):
            a = card_codec.decode_stream(stream).cpu()
            b = cpu_codec.decode_stream(stream)
            dec_err = max(dec_err, (a - b).abs().max().item())
    log(f"DCT streams: encoded on the card and on the CPU port, each decoded on both: max "
        f"|card - CPU| {dec_err:.3e} (bar 1e-5); streams byte-identical {same_bytes}/2")
    if not dec_err <= 1e-5:
        raise AssertionError(f"DCT streams decode differently on the card and the CPU: {dec_err}")

    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card_codec.roundtrip(x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    counts = launch_counts()
    want = expect(K5=6 + 2 + 5)
    if counts != want:
        raise AssertionError(f"DCT path launches {counts}, want {want}")
    log(f"DCT round trip B={n}, 256x256, quality 75: median of 5 {med * 1e3:.3f} ms/call, "
        f"{n / med:.1f} img/s (CUDA-synchronized host clock) on {card}; launches {counts}")

    # where the round trip's time goes (CUDA events, outside the counted run)
    from contextual_image_compression_tpu_torch.measure import event_ms
    from contextual_image_compression_tpu_torch.ops.dct import (
        _entropy_bits_per_symbol, dct_strips, quality_tables, ycbcr_to_rgb)

    planes = _planes_of(x)
    tables = torch.from_numpy(quality_tables(75)).to(dev)
    rec_planes, sym = dct_strips(planes, tables)
    stages = {
        "RGB -> level-shifted YCbCr planes": lambda: _planes_of(x),
        "K5": lambda: dct_strips(planes, tables),
        "planes -> RGB in [-1, 1]": lambda: torch.clamp(
            ycbcr_to_rgb(rec_planes.permute(0, 2, 3, 1) + 128.0) / 127.5 - 1.0, -1.0, 1.0),
        "entropy bpp (evaluate only)": lambda: _entropy_bits_per_symbol(sym.reshape(n, -1)),
    }
    log(f"DCT stages for B={n} (CUDA events, median): " + "; ".join(
        f"{name} {event_ms(fn, reps=10, warmup=2):.3f} ms" for name, fn in stages.items()))
    return counts


def _full_width_codec(dev):
    """A full-width AdaptiveCodec(ModelConfig()) in float32 with seeded
    weights, SAGAN gamma 0.5 and random BatchNorm statistics."""
    from contextual_image_compression_tpu_torch.config import ModelConfig
    from contextual_image_compression_tpu_torch.measure import randomize_stats
    from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec

    with torch.device(dev):
        codec = AdaptiveCodec(ModelConfig())
    codec.reset_parameters(0)
    randomize_stats(codec, 0)
    return codec.eval().requires_grad_(False)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def check_k6(dev, B):
    """K6 at K2's shapes (B, 1024, 32) / (B, 1024, 256), bf16 and float32."""
    import torch.nn.functional as F
    from contextual_image_compression_tpu_torch.measure import device_ms, event_ms
    from contextual_image_compression_tpu_torch.ops.attention import (
        attention_core, attention_core_plain)

    gen = torch.Generator(device=dev).manual_seed(6)
    N, DK, DV = 1024, 32, 256
    q = (torch.randn(B, N, DK, device=dev, generator=gen) * 0.4).to(torch.bfloat16)
    k = (torch.randn(B, N, DK, device=dev, generator=gen) * 0.4).to(torch.bfloat16)
    v = torch.randn(B, N, DV, device=dev, generator=gen).to(torch.bfloat16)
    got, want = attention_core(q, k, v), attention_core_plain(q, k, v)
    f32 = [t.float() for t in (q, k, v)]
    got32, route32 = _route_of(attention_core, lambda: attention_core(*f32))
    want32 = attention_core_plain(*f32)
    if route32 != "tf32x3":
        raise AssertionError(f"K6 float32 took the {route32} route")
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rel = _rel(got, want)
    same = _identical(got, want)
    err32 = (got32 - want32).abs().max().item()
    log(f"K6 attention core bf16 q,k {tuple(q.shape)} v {tuple(v.shape)}: max |kernel - twin| = "
        f"{err:.3e} ({rel:.2e} of max |out|, bar 2e-2); float32 {err32:.3e} (bar 1e-5); "
        f"bit-identical to the twin: {same:.4f} of outputs")
    if not (rel <= 2e-2 and err32 <= 1e-5):
        raise AssertionError(f"K6 disagrees with its twin: bf16 {rel}, f32 {err32}")
    ms = event_ms(lambda: attention_core(q, k, v))
    ms32 = event_ms(lambda: attention_core(*f32))
    plain = event_ms(lambda: attention_core_plain(q, k, v), reps=5, warmup=1)
    lib = event_ms(lambda: _three_calls(q, k, v))
    lib32 = event_ms(lambda: _three_calls(*f32))
    sdpa = event_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
    sdpa32 = event_ms(lambda: F.scaled_dot_product_attention(*f32, scale=1.0))
    dev_ms = device_ms(lambda: attention_core(q, k, v))
    lib_dev = device_ms(lambda: _three_calls(q, k, v))
    sdpa_dev = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
    dev32, lib32_dev, sdpa32_dev = _float32_device_times(lambda: attention_core(*f32), f32)
    flops = 2.0 * B * N * N * (DK + DV)
    nbytes = (q.numel() + k.numel() + v.numel() + got.numel()) * 2
    b_ms, b_by = bound_ms(nbytes, flops, H100_BF16_TFLOPS)
    b32_ms, b32_by = bound_ms(2 * nbytes, 3 * flops, H100_TF32_TFLOPS)
    log(f"K6 times (host launch inside): kernel bf16 {ms:.4f} ms (device alone {dev_ms:.4f}; "
        f"float32 {ms32:.4f}, device alone {dev32:.4f}), twin {plain:.4f} ms, bound bf16 "
        f"{b_ms:.4f} ms ({b_by}), float32 {b32_ms:.4f} ms ({b32_by}), softmax(q k^T) v in "
        f"three calls {lib:.4f} ms (device alone {lib_dev:.4f}; float32, TF32 off, "
        f"{lib32:.4f}, device alone {lib32_dev:.4f}), scaled_dot_product_attention(scale=1) "
        f"bf16 {sdpa:.4f} ms (device alone {sdpa_dev:.4f}; float32 {sdpa32:.4f}, device alone "
        f"{sdpa32_dev:.4f})")
    return dict(name="K6 attention_core", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/attention.cu",
                replaces="contextual_image_compression_tpu/ops/attention.py:156",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=sdpa, library_device_ms=sdpa_dev, library_float32_ms=sdpa32,
                yardstick_ms=lib, yardstick_device_ms=lib_dev, yardstick_float32_ms=lib32,
                float32_ms=ms32, device_ms=dev_ms, identical_share=same,
                **_float32_fields(err32, dev32, lib32_dev, sdpa32_dev, b32_ms, b32_by, flops))


def _sagan_weights(attn, dt):
    """(wq, bq, wk, bk, wv, bv, gamma) of a SelfAttention module in the ops'
    (in, out) layout."""
    out = []
    for conv in (attn.query_conv, attn.key_conv, attn.value_conv):
        w = conv.weight
        out += [w.reshape(w.shape[0], w.shape[1]).t().contiguous().to(dt), conv.bias.float()]
    return (*out, attn.gamma.float()[0])


def check_k7(dev, B, codec):
    """K7a on the (B, N, C) activation and K7b on the encoder's NCHW
    activation seen as (B, H, W, C), with the HQ encoder's SelfAttention
    weights of a full-width codec (gamma 0.5), against their twin and
    against the module's own forward (projections by F.linear, then K2)."""
    from contextual_image_compression_tpu_torch.measure import device_ms, event_ms
    from contextual_image_compression_tpu_torch.ops.attention import (
        sagan_block, sagan_block_plain, sagan_block_spatial)

    attn = codec.hq_encoder.attention
    C, H = 256, 32
    N = H * H
    gen = torch.Generator(device=dev).manual_seed(7)
    x32 = torch.randn(B, C, H, H, device=dev, generator=gen) * 0.5
    res = {}
    for dt in (torch.bfloat16, torch.float32):
        x = x32.to(dt)
        view = x.permute(0, 2, 3, 1)  # the NCHW activation, read in place
        xf = view.reshape(B, N, C)    # (B, N, C) in place: positions 1 apart
        w = _sagan_weights(attn, dt)
        route = "wgmma" if dt == torch.bfloat16 else "tf32x3"
        got_a, route_a = _route_of(sagan_block, lambda: sagan_block(xf, *w))
        got_b, route_b = _route_of(sagan_block_spatial, lambda: sagan_block_spatial(view, *w))
        if (route_a, route_b) != (route, route):
            raise AssertionError(f"K7 {dt} took the {route_a} / {route_b} route, not {route}")
        want_a = sagan_block_plain(xf, *w)
        want_b = want_a.reshape(B, H, H, C)
        module = attn(x).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
        if got_b.stride() != view.stride():
            raise AssertionError(f"K7b wrote {got_b.stride()}, not the input's layout {view.stride()}")
        res[dt] = ((got_a.float() - want_a.float()).abs().max().item(), _rel(got_a, want_a),
                   (got_b.float() - want_b.float()).abs().max().item(), _rel(got_b, want_b),
                   (got_b.float() - module.float()).abs().max().item(), _rel(got_b, module))
    (ea16, ra16, eb16, rb16, em16, rm16), (ea32, _, eb32, _, em32, _) = res.values()
    log(f"K7a SAGAN block (B, N, C) = {(B, N, C)}: max |kernel - twin| bf16 {ea16:.3e} ({ra16:.2e} "
        f"of max |out|, bar 2e-2), float32 {ea32:.3e} (bar 1e-5)")
    log(f"K7b on the NCHW activation viewed (B, H, W, C): max |kernel - twin| bf16 {eb16:.3e} "
        f"({rb16:.2e}, bar 2e-2), float32 {eb32:.3e} (bar 1e-5); against SelfAttention.forward "
        f"(F.linear projections + K2): bf16 {em16:.3e} ({rm16:.2e}, bar 2e-2; the module adds the "
        f"bias in bf16), float32 {em32:.3e} (bar 1e-4)")
    if not (ra16 <= 2e-2 and ea32 <= 1e-5 and rb16 <= 2e-2 and eb32 <= 1e-5
            and rm16 <= 2e-2 and em32 <= 1e-4):
        raise AssertionError(f"K7 disagrees: {res}")

    x = x32.to(torch.bfloat16)
    view = x.permute(0, 2, 3, 1)
    xf = view.reshape(B, N, C)
    w = _sagan_weights(attn, torch.bfloat16)
    wq, bq, wk, bk, wv, bv, g = w

    def composed():  # a yardstick the port never calls
        q = torch.nn.functional.linear(xf, wq.t()) + bq.to(torch.bfloat16)
        k = torch.nn.functional.linear(xf, wk.t()) + bk.to(torch.bfloat16)
        v = torch.nn.functional.linear(xf, wv.t()) + bv.to(torch.bfloat16)
        return g * (torch.softmax(q @ k.transpose(1, 2), dim=-1) @ v) + xf

    x32v = x32.permute(0, 2, 3, 1)
    xf32 = x32v.reshape(B, N, C)
    w32 = _sagan_weights(attn, torch.float32)
    ms_a = event_ms(lambda: sagan_block(xf, *w))
    ms_b = event_ms(lambda: sagan_block_spatial(view, *w))
    dev_a = device_ms(lambda: sagan_block(xf, *w))
    dev_b = device_ms(lambda: sagan_block_spatial(view, *w))
    ms32_a = event_ms(lambda: sagan_block(xf32, *w32))
    ms32_b = event_ms(lambda: sagan_block_spatial(x32v, *w32))
    plain = event_ms(lambda: sagan_block_plain(xf, *w), reps=5, warmup=1)
    yard = event_ms(composed)
    yard_dev = device_ms(composed)
    mod = event_ms(lambda: attn(x))
    inner = wq.shape[1]
    flops = 2.0 * B * N * C * (2 * inner + C) + 2.0 * B * N * N * (inner + C)
    nbytes = 2 * x.numel() * 2 + (2 * C * inner + C * C) * 2 + (2 * inner + C) * 4
    b_ms, b_by = bound_ms(nbytes, flops, H100_BF16_TFLOPS)
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the float32 library calls are timed with TF32 off")
    wq32, bq32, wk32, bk32, wv32, bv32, g32 = w32

    def composed32():  # the yardstick in float32, TF32 off: library calls only
        q = torch.nn.functional.linear(xf32, wq32.t()) + bq32
        k = torch.nn.functional.linear(xf32, wk32.t()) + bk32
        v = torch.nn.functional.linear(xf32, wv32.t()) + bv32
        return g32 * (torch.softmax(q @ k.transpose(1, 2), dim=-1) @ v) + xf32

    x32c = x32.contiguous()
    lib32 = event_ms(composed32)
    lib32_dev = device_ms(composed32)
    mod32 = event_ms(lambda: attn(x32c))  # SelfAttention.forward: F.linear + K2 "tf32x3"
    mod32_dev = device_ms(lambda: attn(x32c))
    dev32_a = device_ms(lambda: sagan_block(xf32, *w32))
    dev32_b = device_ms(lambda: sagan_block_spatial(x32v, *w32))
    parts32 = kernel_device_ms(lambda: sagan_block_spatial(x32v, *w32))
    # float32: every product as three TF32 passes; x read once, the output
    # written once in 4-byte elements
    b32_ms, b32_by = bound_ms(2 * x.numel() * 4 + (2 * C * inner + C * C) * 4, 3 * flops,
                              H100_TF32_TFLOPS)
    cc32_ms = flops / H100_FP32_TFLOPS * 1e3
    log(f"K7 float32 (\"tf32x3\": a three-pass TF32 QKV GEMM, then K2's float32 kernel) K7a "
        f"{ms32_a:.4f} ms (device alone {dev32_a:.4f}), K7b {ms32_b:.4f} (device alone "
        f"{dev32_b:.4f}); K7b's kernels (torch.profiler, device ms) {json.dumps(parts32)}; "
        f"float32 with TF32 off, the same run: three F.linear + softmax(q k^T) v in three calls "
        f"+ epilogue {lib32:.4f} ms (device alone {lib32_dev:.4f}); SelfAttention.forward "
        f"(F.linear + K2 on \"tf32x3\") {mod32:.4f} ms (device alone {mod32_dev:.4f}); bound "
        f"three TF32 passes {b32_ms:.4f} ms ({b32_by}), CUDA-core float32 {cc32_ms:.4f} ms")
    log(f"K7 times bf16 (wgmma QKV GEMM + K2's tensor-core kernel): K7a {ms_a:.4f} ms (device "
        f"alone {dev_a:.4f}), K7b (NCHW view) {ms_b:.4f} ms (device alone {dev_b:.4f}); float32 "
        f"K7a {ms32_a:.4f}, K7b {ms32_b:.4f} ms; twin {plain:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}); yardsticks: three F.linear + softmax(q k^T) v in three calls + epilogue "
        f"{yard:.4f} ms (device alone {yard_dev:.4f}), SelfAttention.forward (F.linear + K2) "
        f"{mod:.4f} ms")
    common = dict(route="cuda", source="contextual_image_compression_tpu_torch/csrc/sagan_block.cu",
                  plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                  yardstick_ms=yard, yardstick_device_ms=yard_dev, module_k2_ms=mod,
                  library_float32_ms=lib32, library_float32_device_ms=lib32_dev,
                  library_float32_tf32="off", module_k2_float32_ms=mod32,
                  module_k2_float32_device_ms=mod32_dev, design="wgmma",
                  route_float32="tf32x3", float32_kernels_device_ms=parts32,
                  float32_bound_ms=b32_ms, float32_bound_by=b32_by,
                  float32_cuda_core_bound_ms=cc32_ms, max_abs_err_float32=max(ea32, eb32))
    return (dict(name="K7a sagan_block", replaces="contextual_image_compression_tpu/ops/attention.py:336",
                 max_abs_err=ea16, ms=ms_a, device_ms=dev_a, float32_ms=ms32_a,
                 float32_device_ms=dev32_a, **common),
            dict(name="K7b sagan_block_spatial",
                 replaces="contextual_image_compression_tpu/ops/attention.py:371",
                 max_abs_err=eb16, ms=ms_b, device_ms=dev_b, float32_ms=ms32_b,
                 float32_device_ms=dev32_b, **common))


def _tail_args(gen_module, dt):
    from contextual_image_compression_tpu_torch.models.packed_tail import fold_tail_bn

    bn = gen_module.bn4
    folded, shift = fold_tail_bn(gen_module.deconv4.weight, gen_module.deconv4.bias, bn.weight,
                                 bn.bias, bn.running_mean, bn.running_var, dt, bn.eps)
    return (folded, shift.to(dt), gen_module.out_conv.weight.to(dt),
            gen_module.out_conv.bias.float())


def _tail_forward(gen_module, x, use_pallas):
    from contextual_image_compression_tpu_torch.models.packed_tail import packed_tail_forward

    bn = gen_module.bn4
    return packed_tail_forward(
        x, gen_module.deconv4.weight, gen_module.deconv4.bias, bn.weight, bn.bias,
        bn.running_mean, bn.running_var, gen_module.out_conv.weight, gen_module.out_conv.bias,
        bn_eps=bn.eps, use_pallas=use_pallas)


def check_k8(dev, B, codec):
    """K8 with the HQ generator's tail (deconv4, bn4 with random statistics,
    out_conv) of a full-width codec on a (B, 128, 128, 128) input."""
    from contextual_image_compression_tpu_torch.measure import device_ms, event_ms
    from contextual_image_compression_tpu_torch.ops.generator_tail import (
        fused_tail, fused_tail_plain)

    gm = codec.hq_generator
    gen = torch.Generator(device=dev).manual_seed(8)
    x32 = torch.randn(B, 128, 128, 128, device=dev, generator=gen) * 0.5
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        x = x32.to(dt)
        args = _tail_args(gm, dt)
        got, route = _route_of(fused_tail, lambda: fused_tail(x, *args))
        if route != ("wgmma" if dt == torch.bfloat16 else "tf32x3"):
            raise AssertionError(f"K8 {dt} took the {route} route")
        want = fused_tail_plain(x, *args)
        cudnn = _tail_forward(gm, x, use_pallas=False)
        torch.cuda.synchronize()
        d_twin = (got.float() - want.float()).abs()
        d_cudnn = (got.float() - cudnn.float()).abs()
        out[dt] = (d_twin.max().item(), (d_twin == 0).float().mean().item(),
                   d_cudnn.max().item(), d_cudnn.mean().item())
    (t16, same16, c16, cm16), (t32, _, c32, _) = out.values()
    log(f"K8 generator tail x {(B, 128, 128, 128)} -> {(B, 3, 256, 256)}: max |kernel - twin| bf16 "
        f"{t16:.3e} (bar 1.6e-2, identical on {same16:.5f}, bar 0.99), float32 {t32:.3e} (bar 2e-5); "
        f"against use_pallas=False (cuDNN, one rounding of the deconv): bf16 max {c16:.3e} mean "
        f"{cm16:.2e} (bars 6.25e-2, 4e-3), float32 {c32:.3e} (bar 2e-4, JAX's)")
    if not (t16 <= 1.6e-2 and same16 >= 0.99 and t32 <= 2e-5 and c16 <= 6.25e-2 and cm16 <= 4e-3
            and c32 <= 2e-4):
        raise AssertionError(f"K8 disagrees: {out}")
    x = x32.to(torch.bfloat16)
    args = _tail_args(gm, torch.bfloat16)
    args32 = _tail_args(gm, torch.float32)
    ms = event_ms(lambda: fused_tail(x, *args), reps=10)
    dev = device_ms(lambda: fused_tail(x, *args), reps=10)
    ms32 = event_ms(lambda: fused_tail(x32, *args32), reps=10)
    dev32 = device_ms(lambda: fused_tail(x32, *args32), reps=10)
    plain = event_ms(lambda: fused_tail_plain(x, *args), reps=5, warmup=1)
    yard = event_ms(lambda: _tail_forward(gm, x, use_pallas=False))
    yard_dev = device_ms(lambda: _tail_forward(gm, x, use_pallas=False))
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("the float32 library calls are timed with TF32 off")
    yard32 = event_ms(lambda: _tail_forward(gm, x32, use_pallas=False), reps=10)
    yard32_dev = device_ms(lambda: _tail_forward(gm, x32, use_pallas=False), reps=10)
    # useful products: the deconv (4 taps of Cin per output pixel and channel)
    # and the 4x4 out-conv; x read once, the output written once
    px = B * 256 * 256
    flops = 2.0 * px * 32 * 4 * 128 + 2.0 * px * 3 * 16 * 32
    nbytes = x.numel() * 2 + px * 3 * 2
    b_ms, b_by = bound_ms(nbytes, flops, H100_BF16_TFLOPS)
    # float32: three TF32 passes of every product, 4-byte elements
    b32_ms, b32_by = bound_ms(2 * nbytes, 3 * flops, H100_TF32_TFLOPS)
    cc32_ms = flops / H100_FP32_TFLOPS * 1e3
    log(f"K8 times: kernel bf16 (wgmma) {ms:.4f} ms (device alone {dev:.4f}), float32 "
        f"(\"tf32x3\") {ms32:.4f} ms (device alone {dev32:.4f}), twin {plain:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), float32 three TF32 passes {b32_ms:.4f} ms ({b32_by}), CUDA-core "
        f"float32 {cc32_ms:.4f} ms; yardstick packed_tail_forward(use_pallas=False) (cuDNN) "
        f"{yard:.4f} ms (device alone {yard_dev:.4f}), in float32 with TF32 off, the same run, "
        f"{yard32:.4f} ms (device alone {yard32_dev:.4f})")
    return dict(name="K8 fused_tail", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/packed_tail.cu",
                replaces="contextual_image_compression_tpu/models/packed_tail.py:207",
                max_abs_err=t16, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, yardstick_ms=yard, yardstick_device_ms=yard_dev,
                library_float32_ms=yard32, library_float32_device_ms=yard32_dev,
                library_float32_tf32="off", device_ms=dev, float32_ms=ms32,
                float32_device_ms=dev32, design="wgmma", route_float32="tf32x3",
                float32_bound_ms=b32_ms, float32_bound_by=b32_by, float32_cuda_core_bound_ms=cc32_ms,
                max_abs_err_float32=t32)


def run_entry_points(dev, B, codec):
    """The main path of K6, K7a, K7b and K8: each public entry point that
    reaches one of them, called once at full width in bf16 (the serving
    dtype); returns the launch counts of the run."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.ops.attention import (
        attention_core, sagan_block, sagan_block_spatial)

    gen = torch.Generator(device=dev).manual_seed(9)
    bf = torch.bfloat16
    q, k = ((torch.randn(B, 1024, 32, device=dev, generator=gen) * 0.4).to(bf) for _ in range(2))
    v = torch.randn(B, 1024, 256, device=dev, generator=gen).to(bf)
    act = (torch.randn(B, 256, 32, 32, device=dev, generator=gen) * 0.5).to(bf)
    tail_in = (torch.randn(B, 128, 128, 128, device=dev, generator=gen) * 0.5).to(bf)
    w = _sagan_weights(codec.hq_encoder.attention, bf)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs = {
        "attention_core": attention_core(q, k, v),
        "sagan_block": sagan_block(act.permute(0, 2, 3, 1).reshape(B, 1024, 256), *w),
        "sagan_block_spatial": sagan_block_spatial(act.permute(0, 2, 3, 1), *w),
        "packed_tail_forward(use_pallas=True)": _tail_forward(codec.hq_generator, tail_in, True),
    }
    torch.cuda.synchronize()
    counts = launch_counts()
    want = expect(K6=1, K7a=1, K7b=1, K8=1)
    if counts != want:
        raise AssertionError(f"entry-point launches {counts}, want {want}")
    check_attention_route("entry points", "wgmma")
    shapes = {"attention_core": (B, 1024, 256), "sagan_block": (B, 1024, 256),
              "sagan_block_spatial": (B, 32, 32, 256),
              "packed_tail_forward(use_pallas=True)": (B, 3, 256, 256)}
    for name, t in outs.items():
        if tuple(t.shape) != shapes[name] or t.dtype != bf or not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: {tuple(t.shape)} {t.dtype} or non-finite values")
    log(f"entry points at full width, bf16: {', '.join(outs)}; launches {counts}")
    return counts


def check_small_codec_against_cpu(dev):
    """The storable codec at the small config on the card and on the CPU with
    the same weights: containers made on either decode on both, to decoded
    images within 40 dB PSNR of each other; the latents the two sides store
    agree within one quantizer step on >= 95% of entries."""
    from contextual_image_compression_tpu_torch.config import ModelConfig
    from contextual_image_compression_tpu_torch.measure import randomize_stats, structured_images
    from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec
    from contextual_image_compression_tpu_torch.ops import bitstream as bs
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    cfg = ModelConfig(img_size=(64, 64), base_latent_dim=64, generator_base_hw=4, skip_mode="zero")
    ref = AdaptiveCodec(cfg)
    ref.reset_parameters(11)
    randomize_stats(ref, 11)
    sd = ref.state_dict()
    u8 = structured_images(np.random.RandomState(12), 4, 64)
    pipes = {name: CompressionPipeline(state_dict=sd, model_config=cfg, device=name)
             for name in ("cuda", "cpu")}
    streams = {name: p.encode_to_bitstream(u8, target_bpp=1.0) for name, p in pipes.items()}
    worst = 100.0
    for made_on, s in streams.items():
        a = pipes["cuda"].decode_from_bitstream(s)
        b = pipes["cpu"].decode_from_bitstream(s)
        mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
        worst = min(worst, 10 * math.log10(255.0 ** 2 / max(mse, 1e-12)))
    same = []
    for sg, sc in zip(streams["cuda"], streams["cpu"]):
        pg, pc = bs.unpack_container(sg), bs.unpack_container(sc)
        for key, scale in (("hq_latent", "hq_scale"), ("lq_latent", "lq_scale")):
            same.append(np.mean(np.round(pg[key] * pg[scale]) == np.round(pc[key] * pc[scale])))
    share = float(np.min(same))
    log(f"small storable codec card vs CPU: containers from each side decode on both within "
        f"{worst:.2f} dB PSNR (bar 40); stored symbols identical on {share:.4f} (bar 0.95)")
    if not (worst >= 40.0 and share >= 0.95):
        raise AssertionError("the storable codec on the card disagrees with the CPU")


def run_codec_path(dev, card):
    """The storable codec at full width: encode_to_bitstream then
    decode_from_bitstream of 16 structured images with
    ModelConfig(skip_mode='zero'); returns the launch counts of the path."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import ModelConfig
    from contextual_image_compression_tpu_torch.measure import randomize_stats, structured_images
    from contextual_image_compression_tpu_torch.ops import bitstream as bs
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    B = 16
    pipe = CompressionPipeline(model_config=ModelConfig(skip_mode="zero"), device=dev, seed=0)
    randomize_stats(pipe.codec, 0)
    u8 = structured_images(np.random.RandomState(13), B, 256)
    pipe.decode_from_bitstream(pipe.encode_to_bitstream(u8))  # warm-up: cuDNN autotuning
    direct, info = pipe(u8, target_bpp=1.0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    streams = pipe.encode_to_bitstream(u8, target_bpp=1.0)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    decoded = pipe.decode_from_bitstream(streams)  # ends in a device->host copy
    t_dec = time.perf_counter() - t0
    counts = launch_counts()
    want = expect(K1=1, K2=1, K3=2)
    if counts != want:
        raise AssertionError(f"storable codec launches {counts}, want {want}")
    check_cluster_route("storable codec")
    check_attention_route("storable codec", "wgmma")
    t0 = time.perf_counter()
    latent_streams, bpp = pipe.serialize_latents(info)
    t_coder = time.perf_counter() - t0
    if decoded.shape != (B, 256, 256, 3) or decoded.dtype != np.uint8:
        raise AssertionError(f"decoded {decoded.shape} {decoded.dtype}")
    diff = np.abs(decoded.astype(np.int32) - direct.astype(np.int32))
    one = pipe.decode_from_bitstream(pipe.encode_to_bitstream(u8[:1], 1.0, mask_downsample=1))
    diff1 = np.abs(one.astype(np.int32) - direct[:1].astype(np.int32))
    total_bpp = np.array([8.0 * len(s) / (256 * 256) for s in streams])
    log(f"storable codec B={B}, 256x256 on {card}: encode_to_bitstream {t_enc * 1e3:.2f} ms, "
        f"decode_from_bitstream {t_dec * 1e3:.2f} ms (host clock, numpy in / out); host range coder "
        f"of the latents {t_coder * 1e3:.2f} ms; measured bpp: latents {float(bpp.mean()):.4f}, "
        f"whole containers {float(total_bpp.mean()):.4f}; launches {counts}")
    log(f"decoded vs the direct call: mean |diff| {diff.mean():.3f} (bar 4) at mask downsample 8; "
        f"downsample 1 on one image mean {diff1.mean():.3f} (bar 1), max {diff1.max()} (bar 16)")
    if not (diff.mean() < 4.0 and diff1.mean() < 1.0 and diff1.max() <= 16):
        raise AssertionError("the storable codec's decode disagrees with the direct call")
    if [bs.unpack_container(s)["img_hw"] for s in streams[:1]] != [(256, 256)]:
        raise AssertionError("container header")
    return counts


# What the card's machine has, as evaluation phase (a) printed it on the first chip run
# of the evaluation slice ("NVIDIA H100 80GB HBM3, 700.00 W"): cv2 and PIL
# import, matplotlib does not, and libjpeg's and libpng's headers and shared
# libraries are missing, so native/image_loader.cpp does not build there.
# Evaluation phases (c) and (d) take their routes from this record, not from a try at
# run time: images decoded with cv2 (load_folder_gan(use_native=False)), no
# figures (save_artifacts=False; metrics.txt and the CSV are written by
# hand), JPEGs written with cv2.
CARD_LIBRARIES = {"cv2": True, "PIL": True, "matplotlib": False, "jpeglib.h": False,
                  "png.h": False, "libjpeg.so": False, "libpng.so": False}
CARD_DECODER = "cv2" if CARD_LIBRARIES["cv2"] else ("pil" if CARD_LIBRARIES["PIL"] else None)
CARD_NATIVE_LOADER = all(CARD_LIBRARIES[k] for k in ("jpeglib.h", "png.h", "libjpeg.so",
                                                      "libpng.so"))
CARD_FIGURES = CARD_DECODER is not None and CARD_LIBRARIES["matplotlib"]
EVAL_IMAGES = pathlib.Path(__file__).resolve().parent / "runs" / "ae_ref" / "compressed_outputs"
# card vs CPU port per image, the bars of tests/test_torch_eval.py (port vs JAX)
EVAL_BARS = {"psnr": 1e-4, "ssim": 1e-5, "mse": 1e-6, "compression_ratio": 1e-4,
             "actual_bpp": 1e-6, "measured_bpp": 0.0, "hq_ratio": 1e-5}


def probe_libraries():
    """Evaluation phase (a): which image and plot libraries the machine has, beside
    CARD_LIBRARIES; then the native image loader's build, which must succeed
    exactly where the record says the headers and libraries are."""
    import ctypes
    import ctypes.util
    import importlib.util

    from contextual_image_compression_tpu_torch import native

    def header(name):
        return any(os.path.exists(os.path.join(d, name))
                   for d in ("/usr/include", "/usr/local/include", "/usr/include/x86_64-linux-gnu"))

    found = {"cv2": importlib.util.find_spec("cv2") is not None,
             "PIL": importlib.util.find_spec("PIL") is not None,
             "matplotlib": importlib.util.find_spec("matplotlib") is not None,
             "jpeglib.h": header("jpeglib.h"), "png.h": header("png.h"),
             "libjpeg.so": ctypes.util.find_library("jpeg") is not None,
             "libpng.so": (ctypes.util.find_library("png16") or ctypes.util.find_library("png"))
             is not None}
    log(f"libraries: {json.dumps(found)}; recorded for the card's machine: "
        f"{json.dumps(CARD_LIBRARIES)}{'' if found == CARD_LIBRARIES else ' (THEY DIFFER)'}")
    t0 = time.time()
    # built anew into an empty directory, so that no earlier build decides
    with tempfile.TemporaryDirectory() as tmp:
        try:
            why = str(native.build_loader(pathlib.Path(tmp)))
            ctypes.CDLL(why)
            built = True
        except (RuntimeError, OSError) as e:
            built, why = False, str(e).splitlines()[-3:]
    log(f"native image loader: {'built' if built else 'does not build'} in "
        f"{time.time() - t0:.1f} s ({why}); recorded: "
        f"{'builds' if CARD_NATIVE_LOADER else 'does not build'}")
    if built != CARD_NATIVE_LOADER:
        raise AssertionError("the native image loader's build disagrees with CARD_LIBRARIES")


def check_k1_bf16(dev, rng, B):
    """Evaluation phase (b): K1's bf16 route against its bf16 twin on the card at B = 16,
    256^2 (bit for bit), against the float32 kernel (JAX's 5e-2 bar), one
    kernel per call, its tiled route at (2, 512, 512), and its times beside
    the float32 route's."""
    from contextual_image_compression_tpu_torch.measure import (
        device_ms, event_ms, structured_images)
    from contextual_image_compression_tpu_torch.ops import image_ops, saliency
    from contextual_image_compression_tpu_torch.ops.fused_mask import (
        contextual_mask, contextual_mask_plain)

    bf = torch.bfloat16
    u8 = torch.from_numpy(structured_images(rng, B, 256)).to(dev)
    gray = image_ops.rgb_to_gray(u8.float()).contiguous()
    spec = saliency.spectral_residual_small(gray, 64, 3.0).contiguous()
    got, route = _route_of(contextual_mask, lambda: contextual_mask(gray, spec, compute_dtype=bf))
    again = contextual_mask(gray, spec, compute_dtype=bf)
    want = contextual_mask_plain(gray, spec, compute_dtype=bf)
    f32 = contextual_mask(gray, spec)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    same = float((got == want).float().mean())
    err32 = (got - f32).abs().max().item()
    log(f"K1 bf16 route {tuple(gray.shape)}, {route}: max |kernel - bf16 twin| = {err:.3e}, "
        f"bit-identical share {same:.6f} (bar: bit-identical); max |bf16 - float32 kernel| = "
        f"{err32:.3e} (bar 5e-2); two calls bitwise equal: {torch.equal(got, again)}")
    if not (err == 0.0 and route == "cluster_bf16" and torch.equal(got, again)
            and err32 <= 5e-2):
        raise AssertionError(f"K1 bf16: {route} route, error {err}, vs float32 {err32}")
    per_call = one_kernel_per_call("K1 bf16", lambda: contextual_mask(gray, spec, compute_dtype=bf),
                                   contextual_mask, "mask_cluster_kernel")
    u8t = torch.from_numpy(structured_images(rng, 2, 512)).to(dev)
    gray_t = image_ops.rgb_to_gray(u8t.float()).contiguous()
    spec_t = saliency.spectral_residual_small(gray_t, 64, 3.0).contiguous()
    got_t, route_t = _route_of(contextual_mask,
                               lambda: contextual_mask(gray_t, spec_t, compute_dtype=bf))
    err_t = (got_t - contextual_mask_plain(gray_t, spec_t, compute_dtype=bf)).abs().max().item()
    tiled_ms = event_ms(lambda: contextual_mask(gray_t, spec_t, compute_dtype=bf))
    log(f"K1 bf16 tiled route {tuple(gray_t.shape)}: {route_t}, max |kernel - twin| = "
        f"{err_t:.3e} (bar: bit-identical), {tiled_ms:.4f} ms")
    if not (err_t == 0.0 and route_t == "tiled_bf16"):
        raise AssertionError(f"K1 bf16 tiled route: {route_t}, error {err_t}")
    ms = event_ms(lambda: contextual_mask(gray, spec, compute_dtype=bf))
    dev_ms = device_ms(lambda: contextual_mask(gray, spec, compute_dtype=bf))
    ms32 = event_ms(lambda: contextual_mask(gray, spec))
    dev_ms32 = device_ms(lambda: contextual_mask(gray, spec))
    plain = event_ms(lambda: contextual_mask_plain(gray, spec, compute_dtype=bf), reps=5, warmup=1)
    # the float32 row's count of the operations the function needs, split by
    # type: the box sums, the bilateral taps and the Gaussian are bf16 work
    # (the card's CUDA-core bf16 peak, 134 TFLOP/s), the entry scale, the
    # normalizations, the upsample and blend and the bilateral's division
    # float32 (67 TFLOP/s). This kernel issues scalar bf16 instructions,
    # which reach half the bf16 peak at most; the bound is the card's.
    pixels = gray.numel()
    rmax, ntaps, ksize = 6, 49, 31
    bf16_per_px = 8 * rmax + 7 * ntaps + 2 * 2 * ksize
    f32_per_px = 3 + 10 + 1 + 2
    nbytes = gray.numel() * 4 + spec.numel() * 4 + got.numel() * 4
    b_ms, b_by = bound_ms(nbytes, (bf16_per_px * pixels, f32_per_px * pixels),
                          (H100_BF16_CUDA_CORE_TFLOPS, H100_FP32_TFLOPS))
    scalar_ms = (bf16_per_px + f32_per_px) * pixels / H100_FP32_TFLOPS * 1e3
    log(f"K1 bf16 times: kernel {ms:.4f} ms (device alone {dev_ms:.4f}); float32 route "
        f"{ms32:.4f} ms (device alone {dev_ms32:.4f}); bf16 twin {plain:.4f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}: {bf16_per_px} bf16 operations a pixel at 134 TFLOP/s, "
        f"{f32_per_px} float32 at 67; {scalar_ms:.4f} ms with scalar bf16 instructions), "
        f"library none")
    return dict(name="K1 contextual_mask, bf16 route", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/fused_mask.cu",
                replaces="contextual_image_compression_tpu/ops/fused_mask.py:252",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_ms=dev_ms, float32_ms=ms32, float32_device_ms=dev_ms32,
                identical_share=same, max_abs_err_vs_float32=err32, mask_route=route,
                launches_per_call=per_call, tiled_route_ms=tiled_ms,
                tiled_route_max_abs_err=err_t,
                bound_peak="bf16 work at the CUDA-core bf16 peak (134 TFLOP/s), float32 at 67",
                scalar_bf16_bound_ms=scalar_ms)


def _eval_rows(results, bpps):
    return {bpp: {k: np.array(v) for k, v in results["by_bpp"][bpp].items()} for bpp in bpps}


def run_evaluation(dev, card):
    """Evaluation phase (c): the evaluation entry point at full width. The seeded
    full-width codec written in JAX's layout to a temporary model_dir;
    CodecEvaluator(EvalConfig(saliency=SaliencyConfig(mask_engine_dtype=
    'bfloat16'))) through load_models, prepare_masks (K1's bf16 route),
    test_compression (3 bpps) and test_rate_control (10 bpps, 4 images) over
    the 16 JPEGs of runs/ae_ref/compressed_outputs (decoded as CARD_LIBRARIES
    says), each call timed; the launch counts (K1 bf16 +1, per codec forward
    K2 +1 on "tf32x3" and K3 +2). Then the JAX-trained tiny GAN through the
    same evaluator at 1.0 bpp, card against the CPU port within EVAL_BARS.
    Returns the launch counts of the full-width run."""
    from contextual_image_compression_tpu_torch import convert, ops
    from contextual_image_compression_tpu_torch.checkpoint import CheckpointStore
    from contextual_image_compression_tpu_torch.config import (
        EvalConfig, ModelConfig, SaliencyConfig)
    from contextual_image_compression_tpu_torch.data import images as image_io
    from contextual_image_compression_tpu_torch.data.pipeline import prepare_masks
    from contextual_image_compression_tpu_torch.eval import plots
    from contextual_image_compression_tpu_torch.eval.harness import CodecEvaluator
    from contextual_image_compression_tpu_torch.utils.tree import param_bytes

    bf16_masks = SaliencyConfig(mask_engine_dtype="bfloat16")
    codec = _full_width_codec(dev)
    with tempfile.TemporaryDirectory() as tmp:
        model_dir, results_dir = os.path.join(tmp, "model"), os.path.join(tmp, "results")
        need = param_bytes(codec.state_dict())
        if shutil.disk_usage(tmp).free < 2 * need:
            raise AssertionError(f"the codec checkpoint needs {need / 1e9:.2f} GB")
        CheckpointStore(model_dir).save_components(convert.codec_variables(codec), "final")
        del codec
        cfg = EvalConfig(saliency=bf16_masks, results_dir=results_dir)
        if CARD_DECODER is None:
            from contextual_image_compression_tpu_torch.data.images import rich_synthetic_images

            images = rich_synthetic_images(16, (256, 256), seed=33)
            names, source = [f"synthetic_{i}.png" for i in range(16)], "rich synthetic images"
        else:
            images, names, _ = image_io.load_folder_gan(str(EVAL_IMAGES), cfg.model.img_size,
                                                        use_native=CARD_NATIVE_LOADER)
            route = image_io.load_folder_gan.last_route
            if route != ("native" if CARD_NATIVE_LOADER else CARD_DECODER) or len(images) != 16:
                raise AssertionError(f"read {len(images)} images by the {route} route")
            source = f"the 16 JPEGs of runs/ae_ref/compressed_outputs by the {route} route"
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        times = {}
        t0 = time.perf_counter()
        ev = CodecEvaluator(cfg, device=dev)
        weights, provenance = ev.load_models(model_dir)
        torch.cuda.synchronize()
        times["load_models"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        masks = prepare_masks(images, cfg.saliency, device=dev)
        times["prepare_masks"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = ev.test_compression(weights, images, masks, names, save_artifacts=CARD_FIGURES)
        times["test_compression"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        rc = ev.test_rate_control(weights, images, masks, names, save_artifacts=CARD_FIGURES)
        times["test_rate_control"] = time.perf_counter() - t0
        counts = launch_counts()
        if CARD_FIGURES:
            plots.plot_rate_distortion_curve(results["avg_metrics"], results_dir)
        else:  # the files that need no figure library
            for bpp, avg in results["avg_metrics"].items():
                bpp_dir = os.path.join(results_dir, f"bpp_{bpp}")
                os.makedirs(bpp_dir, exist_ok=True)
                ev._write_metrics_txt(os.path.join(bpp_dir, "metrics.txt"), bpp, avg,
                                      results["by_bpp"][bpp], names)
            plots.write_rate_distortion_csv(results["avg_metrics"], results_dir)
        files = sorted(os.path.relpath(os.path.join(d, f), results_dir)
                       for d, _, fs in os.walk(results_dir) for f in fs)
    forwards = len(cfg.bpp_values) + cfg.rate_control_bpps
    if sorted(provenance.values()) != ["final"] * 7:
        raise AssertionError(f"provenance {provenance}")
    if counts != expect(K1bf16=1, K2=forwards, K3=2 * forwards):
        raise AssertionError(f"evaluation launches {counts}, want K1bf16 1, K2 {forwards}, "
                             f"K3 {2 * forwards}")
    check_cluster_route("evaluation")
    check_attention_route("evaluation", "tf32x3")
    avg = results["avg_metrics"]
    for bpp, m in avg.items():
        log(f"evaluation at {bpp} bpp: PSNR {m['psnr']:.4f} dB, SSIM {m['ssim']:.5f}, "
            f"actual bpp {m['actual_bpp']:.5f}, measured bpp {m['measured_bpp']:.5f}, HQ ratio "
            f"{m['hq_ratio'] * 100:.3f}%")
    log(f"full-width evaluation on {card} (seeded weights, so the quality numbers say nothing "
        f"of a trained codec), 16 images from {source}, bf16 masks: load_models "
        f"{times['load_models']:.3f} s, prepare_masks {times['prepare_masks']:.3f} s, "
        f"test_compression {times['test_compression']:.3f} s, test_rate_control "
        f"{times['test_rate_control']:.3f} s (host clock); figures "
        f"{'written' if CARD_FIGURES else 'not written (no matplotlib)'}; files {files}; "
        f"launches {counts}")
    bpps = sorted(avg)
    ok = (all(math.isfinite(v) for m in avg.values() for v in m.values())
          and all(0.25 - 1e-6 <= m["actual_bpp"] <= 0.5 + 1e-6 for m in avg.values())
          and all(m["measured_bpp"] > 0 for m in avg.values())
          and avg[bpps[-1]]["hq_ratio"] > avg[bpps[0]]["hq_ratio"]
          and len(rc["target_bpp"]) == cfg.rate_control_bpps * 4
          and masks.shape == (16, 256, 256, 1) and 0.0 <= masks.min() and masks.max() <= 1.0
          and "rate_distortion_data.csv" in files
          and all(f"bpp_{b}/metrics.txt" in files for b in bpps))
    if not ok:
        raise AssertionError(f"evaluation results {avg}, files {files}")

    # the JAX-trained tiny GAN through the same evaluator, card vs CPU port
    fixture = pathlib.Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_tiny_gan"
    tiny = EvalConfig(model=ModelConfig(**JAX_TINY), saliency=bf16_masks, bpp_values=(1.0,),
                      batch_size=4)
    from contextual_image_compression_tpu_torch.data.images import synthetic_images

    imgs = synthetic_images(6, (32, 32), seed=2)
    tiny_names = [f"img_{i}.png" for i in range(6)]
    tiny_masks = prepare_masks(imgs, tiny.saliency, device=dev)
    rows = {}
    for side in (dev, "cpu"):
        tev = CodecEvaluator(tiny, device=side)
        w, prov = tev.load_models(str(fixture))
        if sorted(prov.values()) != ["final"] * 7:
            raise AssertionError(f"tiny GAN provenance {prov}")
        rows[str(side)] = _eval_rows(tev.test_compression(w, imgs, tiny_masks, tiny_names,
                                                          save_artifacts=False), (1.0,))[1.0]
    diffs = {k: float(np.abs(rows[str(dev)][k] - rows["cpu"][k]).max()) for k in EVAL_BARS}
    log(f"JAX-trained tiny GAN through CodecEvaluator at 1.0 bpp, 6 images, bf16 masks: card vs "
        f"CPU port max |diff| {diffs} (bars {EVAL_BARS}); card PSNR "
        f"{float(rows[str(dev)]['psnr'].mean()):.4f} dB")
    if not all(diffs[k] <= bar for k, bar in EVAL_BARS.items()):
        raise AssertionError(f"tiny GAN evaluation, card vs CPU: {diffs}")
    return counts


def run_autoencoder_evaluation(dev, card):
    """Evaluation phase (d): evaluate_autoencoder on runs/ae_ref's autoencoder over the
    16 JPEGs of runs/ae_ref/compressed_outputs (read and written as
    CARD_LIBRARIES says), card against the CPU port: MSE / PSNR / SSIM, the
    size reduction and the files written; no kernel launch."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.data import images as image_io
    from contextual_image_compression_tpu_torch.eval.ae_eval import evaluate_autoencoder
    from contextual_image_compression_tpu_torch.train.ae_trainer import AETrainer

    if CARD_DECODER is None:
        log("autoencoder evaluation: not run (CARD_LIBRARIES: no JPEG reader or writer)")
        return
    ae_dir = str(pathlib.Path(__file__).resolve().parent / "runs" / "ae_ref" / "model")
    images, paths = image_io.load_folder_unit(str(EVAL_IMAGES), (128, 128))
    ops.reset_launch_counts()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for side in (dev, "cpu"):
            trainer = AETrainer(device=side, log_fn=lambda msg: None)
            trainer.load(ae_dir)
            t0 = time.perf_counter()
            out[str(side)] = evaluate_autoencoder(trainer, images, paths,
                                                  os.path.join(tmp, str(side)))
            out[str(side)]["seconds"] = time.perf_counter() - t0
            out[str(side)]["files"] = sorted(os.listdir(os.path.join(tmp, str(side))))
    counts = launch_counts()
    got, want = out[str(dev)], out["cpu"]
    log(f"autoencoder evaluation on {card}: {len(images)} JPEGs of runs/ae_ref at 128^2 by "
        f"{CARD_DECODER}: mse {got['mse']:.4f}, psnr {got['psnr']:.4f} dB, ssim "
        f"{got['ssim']:.5f}, size reduction {got['size_reduction']:.3f}% ({got['seconds']:.3f} s, "
        f"host clock); CPU port mse {want['mse']:.4f}, psnr {want['psnr']:.4f}, ssim "
        f"{want['ssim']:.5f}, size reduction {want['size_reduction']:.3f}%; launches {counts}")
    if not (abs(got["psnr"] - want["psnr"]) <= 1e-3 and abs(got["ssim"] - want["ssim"]) <= 1e-3
            and abs(got["mse"] - want["mse"]) <= 1e-3 * want["mse"]
            and abs(got["size_reduction"] - want["size_reduction"]) <= 0.5
            and got["files"] == want["files"] and len(got["files"]) == len(images) == 16
            and counts == expect()):
        raise AssertionError(f"autoencoder evaluation: card {got}, CPU {want}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from contextual_image_compression_tpu_torch.measure import card_name_and_power
        from contextual_image_compression_tpu_torch.ops import cuda_kernels
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_name_and_power()
    log(card)
    dev = torch.device("cuda")
    t0 = time.time()
    lib_path = cuda_kernels.build()
    cuda_kernels.library()
    log(f"kernels built in {time.time() - t0:.1f} s: {lib_path}")
    build_log = (lib_path.parent / "build.log").read_text()
    entry, spills, arrives = "?", "", 0
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "(C7519)" in line:
            arrives += 1  # ptxas's note of a wgmma fence it added (one line each)
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            log(f"  ptxas: {entry[:110]}: {spills}; {line.split(':', 1)[-1].strip()}")
            attn = "attn_tc_kernel" in entry or "attn_tf32_kernel" in entry
            split = attn or "tail_tf32_kernel" in entry
            if attn and not spills.startswith("0 bytes stack frame, 0 bytes spill"):
                raise AssertionError(f"the K2 / K6 tensor-core kernel spills: {entry} {spills}")
            if split and "Used 168 registers" not in line:
                raise AssertionError(f"a setmaxnreg tensor-core kernel does not start at the 168 "
                                     f"registers its split deals out: {entry} {line}")
        elif "error" in line.lower() or "warning" in line.lower():
            log("  ptxas: " + line.strip())
    if arrives:
        log(f"  ptxas: {arrives} notes (C7519) of a warpgroup.arrive injected before a wgmma")
    from contextual_image_compression_tpu_torch import native

    t0 = time.time()
    coder_path = native.build()
    log(f"range coder built in {time.time() - t0:.1f} s: {coder_path}")
    probe_libraries()

    rng = np.random.RandomState(0)
    B = 16
    records = [check_k1(dev, rng, B), check_k2(dev, B), check_k3(dev, B)]
    check_small_pipeline_against_cpu(dev)
    check_small_pipeline_against_cpu(dev, w8a8=True)
    serving, med = run_full_pipeline(dev, card)
    jax_trained = run_jax_trained_serving(dev, card)
    from_checkpoint = run_checkpoint_serving(dev, card)
    w8a8_serving = run_w8a8_serving(dev, card)
    records.append(check_k3b(dev, B))
    check_small_train_step_against_cpu(dev)
    check_small_mixed_step_against_cpu(dev)
    with tempfile.TemporaryDirectory() as model_dir:
        training, f32_times = run_full_training(dev, card, model_dir)
    check_small_checkpoint_modes(dev)
    records.append(check_k4(dev, 64))
    mask_path = run_mask_path(dev, card)
    fft_masks = run_fft_core_masks(dev, card)
    with tempfile.TemporaryDirectory() as model_dir:
        mixed_training = run_mixed_training(dev, card, model_dir, f32_times)
    records.append(check_k5(dev, 128))
    dct_path = run_dct_path(dev, card)
    records.append(check_k6(dev, B))
    codec = _full_width_codec(dev)
    records.extend(check_k7(dev, B, codec))
    records.append(check_k8(dev, B, codec))
    entry_points = run_entry_points(dev, B, codec)
    del codec
    check_small_codec_against_cpu(dev)
    codec_path = run_codec_path(dev, card)
    run_autoencoder(dev, card)
    records.append(check_k1_bf16(dev, rng, B))
    evaluation = run_evaluation(dev, card)
    run_autoencoder_evaluation(dev, card)
    paths = {"serving": serving, "jax_trained_serving": jax_trained,
             "checkpoint_serving": from_checkpoint, "w8a8_serving": w8a8_serving,
             "training": training, "mixed_training": mixed_training, "masks": mask_path,
             "fft_core_masks": fft_masks, "dct": dct_path, "entry_points": entry_points,
             "storable_codec": codec_path, "evaluation": evaluation}
    serving_paths = ("serving", "jax_trained_serving", "checkpoint_serving", "w8a8_serving",
                     "training", "mixed_training", "storable_codec")
    runs_it = {"K1": serving_paths + ("fft_core_masks",), "K2": serving_paths + ("evaluation",),
               "K3": serving_paths + ("evaluation",), "K3b": ("training", "mixed_training"),
               "K4": ("masks", "fft_core_masks"), "K5": ("dct",), "K6": ("entry_points",),
               "K7a": ("entry_points",), "K7b": ("entry_points",), "K8": ("entry_points",),
               "K1bf16": ("evaluation",)}
    keys_in_order = ("K1", "K2", "K3", "K3b", "K4", "K5", "K6", "K7a", "K7b", "K8", "K1bf16")
    if len(records) != len(keys_in_order):
        raise AssertionError("one record per kernel")
    for rec, key in zip(records, keys_in_order):
        for name, counts in paths.items():
            rec[f"launches_{name}"] = counts[key]
        rec["launches"] = sum(counts[key] for counts in paths.values())
        if any(paths[name][key] == 0 for name in runs_it[key]):
            raise AssertionError(f"{key} was not launched on a path that runs it")
        rec["status"] = "ported; within its bar against the twin; launched on the main paths"
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = {"kernels": [{**{k: rec[k] for k in keys}, **rec} for rec in records]}
    log(f"chip_smoke wall time {time.time() - T_START:.1f} s (from the script's start, the "
        f"kernels' build included)")
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
