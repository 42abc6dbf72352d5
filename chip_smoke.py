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
   symbols and that the kernels' launch counters moved by K1 +1, K2 +1,
   K3 +2 and K8int8 +2 (K8's int8 route, the two generators' tails) per
   call;
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
   bounds; then K8's int8 route (the serving tail, folded once) against
   packed_tail_forward(int8_planar=True), the path it replaces, at B = 16
   and 128, both timed the same two ways beside its bound;
16. drives the entry points of K6-K8 once at full width in bf16
   (attention_core, sagan_block, sagan_block_spatial,
   packed_tail_forward(use_pallas=True)): each kernel +1 and no other;
17. runs the storable codec: at the small config, containers made on the
   card and on the CPU decode on both; at full width
   (ModelConfig(skip_mode='zero'), 16 structured images)
   encode_to_bitstream then decode_from_bitstream (K1 +1, K2 +1, K3 +2,
   K8int8 +4),
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
+1, K3 +2, K8int8 +2, timed beside the dense_w8 pipeline on the same weights.

Checkpoints (the JAX package's files, read and written without flax) and
the autoencoder run in four more phases, after step 5, in step 8 and after
step 17:

(a) serves the JAX-trained tiny GAN of tests/fixtures/jax_tiny_gan
   (CompressionPipeline(model_dir=...), provenance all 'final', K1 +1, K2
   +1, K3 +2, K8int8 +2) against the JAX pipeline's committed outputs and the port's
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
   kernel's bf16 compute, two columns a thread as bf16x2) against its bf16
   twin at B = 16, 256^2, bit for bit, and within 5e-2 of the float32
   kernel, one kernel per call, its tiled route at (2, 512, 512) and an odd
   width (2, 255, 255), and times it beside the float32 route;
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

The user entry points add two phases at the end:

(e) the reference training flow at full width (ModelConfig(), B = 16,
   float32, TF32 off, random VGG19) on 32 synthetic images, 2 steps an
   epoch: where figures cannot be written, GANTrainer.fit(artifacts=True)
   and scripts/torch_train_gan.py's main raise naming matplotlib before
   any step; then train_full_reference_flow's calls: fit for 1 epoch with
   profile_dir (a torch.profiler trace of step 1 on), fine_tune_epochs (3)
   epochs at bpp 1.0 and the rate-control probe (figures only where they
   can be written), checking the history (4 epochs), the metadata, the
   'final' files against JAX's set, the probe's ratios (finite,
   non-decreasing) and the trace, with K1 +1, per step K2 +1 ("tf32x3"),
   K3 +2 and K3b +2, per probe point K2 +1 and K3 +2; it prints both fits'
   images per second, a 'final' save's seconds, the peak memory and the
   trace's five longest device kernels;
(f) the codec CLIs on the card: scripts/torch_compress.py encodes the 16
   JPEGs of runs/ae_ref/compressed_outputs at quality 75 (K5 +1 each;
   streams byte-identical to the same CLI on the CPU) and decodes them;
   scripts/torch_eval_bitstream.py (K1 +2, K2 +2 on "wgmma", K3 +4, K8int8
   +6 per bpp) and scripts/torch_codec_shootout.py (K5 +6, K1 +1, K2 +8 on
   "tf32x3", K3 +16) from phase (b)'s full-width model_dir over 16
   images, the shootout with --ae-dir runs/ae_ref/model; their JSON rows
   must be finite, and without matplotlib the shootout's plot raises after
   its JSON is written.

The options slice adds phase (g) after (f), each part's launches counted
from 0 (its columns of the kernels line):

(g1) bf16 parameters: TrainConfig() with ModelConfig(dtype='bfloat16',
   param_dtype='bfloat16'), B = 16, random VGG19: masks of 32 images (K1
   +1), an inference forward, a step with D and one without (K2 +3 on
   "wgmma", K3 +6, K3b +4); parameters and Adam moments bf16, BatchNorm
   statistics float32 (JAX's dtypes), moved and finite; the 'final' save
   resumed bitwise by a fresh trainer; step times;
(g2) dense_w8 in training: TrainConfig() float32 with dense_w8 and
   bn_mode 'frozen' (the JAX codec quantizes the projections at trace time
   outside batch statistics), from the CPU tests' draws of BatchNorm
   statistics, scales, biases and gamma (at the seeded init every quantized
   latent is 0, measured by an inference forward before and after the
   draws), two steps (K1 +1, K2 +4 on "tf32x3", K3 +8, K3b +4 with the two
   forwards); each w8 kernel's gradient only at its rows' arg-max entries,
   and each kernel moved, only there;
(g3) the use_pallas=False routes, each beside its kernel route on the same
   inputs and timed with it: serving at B = 16 with attention_use_pallas and
   QuantizerConfig.use_pallas False (K1 +1 and K8int8 +2 a call, no K2 or
   K3: the generators' int8 tail has no use_pallas flag; decoded
   PSNR >= 40 dB against the kernel route, symbols within +-1 and >= 95%
   identical), masks of 128 images with mask_use_pallas=False for the three
   methods (no K1 or K4; within 1e-4 of K1 / K4) and the DCT round trip at
   B = 128 with use_pallas=False (no K5; symbols within +-1 and >= 99.99%
   identical, reconstruction within 1e-4);
(g4) the slice's CLIs: scripts/torch_profile_codec.py --batch 16 (K1, K2
   on "wgmma" and K3 at exact counts: none in its attention_xla row),
   torch_layer_microbench.py --batch 16 (no kernel of the port),
   torch_compare_rd.py on evaluation phase (c)'s RD CSV against itself
   (deltas +0.00 dB; --plot raises naming matplotlib where it does not
   import) and torch_convert_vgg_weights.py on a synthetic VGG19 state dict
   (the .npz loaded back by load_vgg19_features; an .h5 raises naming h5py
   where it does not import).

The multi-device slice adds phase (h) at the end, at full width
(ModelConfig(), TrainConfig() with a random VGG19, global B = 16), its
launches in the kernels line's `launches_mesh`:

(h1) NCCL at world size 1: a (1, 1) mesh GANTrainer and one without take a
   step with D from the same seeded state (losses within 1e-5 relative),
   and a (1, 1) mesh CompressionPipeline call gives the bytes of the
   pipeline without one (K1, K2, K3 and K3b launched on the mesh's side);
(h2) two ranks that share cuda:0 over gloo (NCCL refuses two ranks on one
   card), started by this script as `chip_smoke.py --mesh-rank R 2 DIR`
   after the kernels are built and the one-device reference has run and
   been freed: __graft_entry__.py's dryrun_multichip lifecycle: four steps
   of the D-every-other schedule on a (1, 2) mesh (the model axis splits
   the four projections, conv4, deconv1 / 2 and D's dense), four on a
   (2, 1) mesh and a rank-0 save, a restore on a fresh (1, 2) mesh and two
   more steps, each step's metrics against the one-device run of the
   schedule (MESH_BARS; the one-device run is also held against itself),
   the two ranks' metrics within MESH_RANK_BAR, the gathered state after
   step 0 against the one-device run's (MESH_PARAM_BAR); then mesh serving
   of a 3-image request (padded to 4, two a rank) and the storable round
   trip, the same bytes, symbols and streams as the one-device pipeline
   (cuDNN deterministic in both). It prints the
   agreement, each rank's peak memory and stage times, the phase's wall
   time (two processes sharing one card through gloo: a cost, not a
   scaling figure) and the ranks' launches; a failing rank fails the run.

(i) K9, HiFiC's ChannelNorm, at the HiFiC cell's seven norm shapes (4
   photos of 2048x1536: C = 60 at 1536 x 2048 down to 960 and 220 at 96 x
   128), bf16, on both routes (NCHW x; its channels_last copy, the served
   layout) against its twin on the card (>= 99.9% identical, the rest
   within one bf16 ulp or 1e-4), each timed host-inclusive, on the device
   alone and beside the twin and its bound (one read and one write, bytes
   at 3.35 TB/s), with the sums over a call's 29 norms; then HiFiC served
   at its published widths (seeded weights) on photos of 192x256 and
   200x300: 29 K9 launches a call, all on the NHWC route, and no other
   kernel.

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
import dataclasses
import itertools
import json
import math
import os
import pathlib
import re
import runpy
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
    wrapper's routes 'cluster_bf16' and 'tiled_bf16'); and K8's int8 route
    (the serving generators' tail) apart as 'K8int8'."""
    from contextual_image_compression_tpu_torch import ops

    counts = ops.launch_counts()
    routes = ops.route_counts()
    counts["K1bf16"] = routes["K1"]["cluster_bf16"] + routes["K1"]["tiled_bf16"]
    counts["K1"] -= counts["K1bf16"]
    counts["K8int8"] = routes["K8"]["int8"]
    counts["K8"] -= counts["K8int8"]
    return counts


def expect(**nonzero):
    """A full launch-count dict (as launch_counts() gives it): the given
    kernels at their counts, every other kernel at 0."""
    from contextual_image_compression_tpu_torch import ops

    keys = (*ops.KERNEL_WRAPPERS, "K1bf16", "K8int8")
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
    configuration's dense_w8 would hide it), in its serving form
    (`prepare_serving`). Everything else of the pipeline's call is its own."""
    import dataclasses

    from contextual_image_compression_tpu_torch.models.adaptive import AdaptiveCodec

    mcfg = dataclasses.replace(pipe.mcfg, dense_w8=False, dense_int8=True)
    with torch.device(pipe.device):
        codec = AdaptiveCodec(mcfg)
    codec.load_state_dict(state_dict)
    out = copy.copy(pipe)
    out.mcfg, out.codec, out._seen_batches = mcfg, codec.prepare_serving(), set()
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
        if delta != expect(K1=1, K2=1, K3=2, K8int8=2):
            raise AssertionError(f"call {i}: kernel launches {delta}, want K1 1, K2 1, K3 2, "
                                 "K8int8 2 (the two generators' tails), and no other")
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
        if delta != expect(K1=1, K2=1, K3=2, K8int8=2):
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
    if counts != expect(K1=1, K2=1, K3=2, K8int8=2):
        raise AssertionError(f"JAX-trained serving launches {counts}, want K1 1, K2 1, K3 2, "
                             "K8int8 2")
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


def run_checkpoint_serving(dev, card, tmp):
    """Phase (b): the seeded full-width codec's float32 state carried to
    JAX's layout and saved by the store into the directory tmp (1.67 GB;
    phase (f) runs the CLIs from it), then CompressionPipeline(model_dir=...)
    against the pipeline built from the same state dict at B = 16: decoded
    images and symbols bitwise equal (cuDNN's deterministic algorithms in
    both). Returns the launch counts of the checkpoint pipeline's call."""
    from contextual_image_compression_tpu_torch import convert, ops
    from contextual_image_compression_tpu_torch.checkpoint import CheckpointStore
    from contextual_image_compression_tpu_torch.measure import structured_images
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline
    from contextual_image_compression_tpu_torch.utils.tree import param_bytes

    codec = _full_width_codec(dev)
    sd = {k: v.clone() for k, v in codec.state_dict().items()}
    B = 16
    u8 = structured_images(np.random.RandomState(21), B, 256)
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
        if counts != expect(K1=1, K2=1, K3=2, K8int8=2):
            raise AssertionError(f"checkpoint serving launches {counts}, want K1 1, K2 1, K3 2, "
                                 "K8int8 2")
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


def check_k8_int8(dev, codec):
    """K8's int8 route (the serving generators' tail) with the HQ generator's
    tail of a full-width codec in bf16, as serving casts it, folded once
    (fold_int8_tail), on (B, 128, 128, 128) inputs at B = 16 and 128: held to
    the path it replaces, packed_tail_forward(int8_planar=True) (cuDNN and
    elementwise passes, its fold on every call), at K8's bf16 bars against
    cuDNN (max 6.25e-2, mean 4e-3, identical on >= 99%); both timed,
    host-inclusive and on the device alone, in the same run, beside the
    bound max(bytes / 3.35 TB/s, operations / 989 TFLOP/s) over x read once
    and the output written once."""
    from contextual_image_compression_tpu_torch.measure import device_ms, event_ms
    from contextual_image_compression_tpu_torch.models.packed_tail import (
        fold_int8_tail, int8_tail_forward, packed_tail_forward)
    from contextual_image_compression_tpu_torch.ops.generator_tail import fused_tail

    gm, bf = codec.hq_generator, torch.bfloat16
    bn = gm.bn4
    w = [t.detach().to(bf) for t in (gm.deconv4.weight, gm.deconv4.bias, bn.weight, bn.bias,
                                     bn.running_mean, bn.running_var, gm.out_conv.weight,
                                     gm.out_conv.bias)]
    ops = fold_int8_tail(*w, bf, bn_eps=bn.eps, pack=True)
    gen = torch.Generator(device=dev).manual_seed(18)
    rec = {}
    for B in (16, 128):
        x = (torch.randn(B, 128, 128, 128, device=dev, generator=gen) * 0.5).to(bf)
        route = lambda: int8_tail_forward(x, ops)  # noqa: E731
        path = lambda: packed_tail_forward(x, *w, bn_eps=bn.eps, int8_planar=True)  # noqa: E731
        got, which = _route_of(fused_tail, route)
        if which != "int8":
            raise AssertionError(f"K8 int8 took the {which} route")
        d = (got.float() - path().float()).abs()
        err = (d.max().item(), d.mean().item(), (d == 0).float().mean().item())
        del got, d
        if not (err[0] <= 6.25e-2 and err[1] <= 4e-3 and err[2] >= 0.99):
            raise AssertionError(f"K8 int8 at B = {B} disagrees with the PyTorch path: {err}")
        px = B * 256 * 256
        flops = 2.0 * px * 32 * 4 * 128 + 2.0 * px * 3 * 16 * 32
        b_ms, b_by = bound_ms(x.numel() * 2 + px * 3 * 2, flops, H100_BF16_TFLOPS)
        t = dict(ms=event_ms(route, reps=10), device_ms=device_ms(route, reps=10),
                 path_ms=event_ms(path, reps=10), path_device_ms=device_ms(path, reps=10),
                 bound_ms=b_ms, bound_by=b_by)
        log(f"K8 int8 x {(B, 128, 128, 128)} -> {(B, 3, 256, 256)} against "
            f"packed_tail_forward(int8_planar=True): max {err[0]:.3e} mean {err[1]:.2e} identical "
            f"{err[2]:.5f} (bars 6.25e-2, 4e-3, 0.99); route {t['ms']:.4f} ms (device alone "
            f"{t['device_ms']:.4f}), the path it replaces {t['path_ms']:.4f} ms (device alone "
            f"{t['path_device_ms']:.4f}), bound {b_ms:.4f} ms ({b_by})")
        rec[B] = (err, t)
        del x
    (err, t), (err128, t128) = rec[16], rec[128]
    return dict(name="K8 int8 int8_tail", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/packed_tail.cu",
                replaces="contextual_image_compression_tpu_torch/models/packed_tail.py "
                         "packed_tail_forward(int8_planar=True)",
                max_abs_err=err[0], mean_abs_err=err[1], identical=err[2], ms=t["ms"],
                plain_ms=t["path_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                library_ms=t["path_ms"], device_ms=t["device_ms"],
                library_device_ms=t["path_device_ms"], design="wgmma, one rounding of the deconv",
                max_abs_err_b128=err128[0], ms_b128=t128["ms"], device_ms_b128=t128["device_ms"],
                library_ms_b128=t128["path_ms"], library_device_ms_b128=t128["path_device_ms"],
                bound_ms_b128=t128["bound_ms"])


# HiFiC's norms in a call of the HiFiC cell (4 photos of 2048x1536): (C,
# relu, H, W, norms of that shape a call). E: 60 to 960 with ReLU; G:
# norm_in (220), the head (960), the blocks' 18 (960, half with ReLU), the
# upsampling's four with ReLU.
HIFIC_NORM_SHAPES = ((60, True, 1536, 2048, 2), (120, True, 768, 1024, 2),
                     (240, True, 384, 512, 2), (480, True, 192, 256, 2),
                     (960, True, 96, 128, 10), (960, False, 96, 128, 10),
                     (220, False, 96, 128, 1))


def check_k9(dev):
    """K9 against its twin (channel_norm_plain on the card) at each of the
    HiFiC cell's norm shapes, B = 4, bf16, alpha in [0.75, 1.25] and beta
    in +-0.1 as the benchmark draws them, on the NCHW route (x contiguous)
    and the NHWC route (its channels_last copy in the served rows: C = 60
    padded to 64 channels, models/hific.py, 220 as it is); each
    host-inclusive and on the device alone, the twin, and the bound: x read
    once and y written once at 3.35 TB/s (about ten float32 operations an
    element, far below the bf16 line). The record's fields are the two
    extremes, C = 960 at 96 x 128 and C = 60 at 1536 x 2048 (`_nhwc` the
    NHWC route's); `call_ms` sums the device times over a call's 29 norms."""
    from contextual_image_compression_tpu_torch.config import HiFiCConfig
    from contextual_image_compression_tpu_torch.measure import device_ms, event_ms
    from contextual_image_compression_tpu_torch.models.hific import ROW_CHANNELS
    from contextual_image_compression_tpu_torch.ops.channel_norm import (
        channel_norm, channel_norm_plain, nhwc_plan, tile_pixels)

    gen = torch.Generator(device=dev).manual_seed(21)
    bf, eps, B = torch.bfloat16, 1e-3, 4
    routes = {"": torch.contiguous_format, "_nhwc": torch.channels_last}
    rows = {}
    call = {f"{k}{r}": 0.0 for k in ("ms", "device_ms", "plain_ms", "bound_ms") for r in routes}
    call["norms"] = 0
    for c, relu, h, w, count in HIFIC_NORM_SHAPES:
        offset = torch.rand(1, c, 1, 1, device=dev, generator=gen) * 2 - 1
        x0 = (torch.randn(B, c, h, w, device=dev, generator=gen) + offset).to(bf)
        alpha = (0.75 + 0.5 * torch.rand(c, device=dev, generator=gen)).to(bf)
        beta = (0.2 * torch.rand(c, device=dev, generator=gen) - 0.1).to(bf)
        # the served row: E's and G's rows padded to a multiple of ROW_CHANNELS,
        # G's first norm on y_hat's 220 channels as they are
        served = c if c == HiFiCConfig().latent_channels else -(-c // ROW_CHANNELS) * ROW_CHANNELS
        row = dict(tile=tile_pixels(c, 2), tile_nhwc=nhwc_plan(served, 2)[0])
        for r, fmt in routes.items():
            x = x0 if not r else torch.nn.functional.pad(
                x0, (0, 0, 0, 0, 0, served - c)).contiguous(memory_format=fmt)
            k9 = lambda: channel_norm(x, alpha, beta, eps, relu)  # noqa: E731
            twin = lambda: channel_norm_plain(x, alpha, beta, eps, relu)  # noqa: E731
            n, n_nhwc = channel_norm.launches, channel_norm.launches_nhwc
            got, want = k9(), twin()
            if (channel_norm.launches, channel_norm.launches_nhwc) != (n + 1, n_nhwc + bool(r)):
                raise AssertionError(f"K9{r}: one launch a call, on the route of x's layout")
            if not got.is_contiguous(memory_format=fmt):
                raise AssertionError(f"K9{r}: the output keeps x's layout")
            d = (got.float() - want.float()).abs()
            ulp = torch.exp2(torch.floor(torch.log2(want.float().abs().clamp_min(1e-30))) - 7)
            same = (d == 0).float().mean().item()
            worst = d.max().item()
            if same < 0.999 or not bool((d <= ulp.clamp_min(1e-4)).all()):
                raise AssertionError(f"K9{r} at C = {c}, {h}x{w}: identical {same:.5f}, largest "
                                     f"difference {worst:.3e}")
            del got, want, d, ulp
            b_ms, b_by = bound_ms(2 * x.numel() * x.element_size(), 10.0 * x.numel(),
                                  H100_FP32_TFLOPS)
            t = dict(ms=event_ms(k9, reps=10), device_ms=device_ms(k9, reps=10),
                     plain_ms=event_ms(twin, reps=5), bound_ms=b_ms)
            row.update({f"{k}{r}": v for k, v in t.items()},
                       **{f"identical{r}": same, f"max_abs_err{r}": worst, "bound_by": b_by})
            for key in t:
                call[f"{key}{r}"] += count * t[key]
            log(f"K9{r} x {tuple(x.shape)} relu {relu} (P = {row['tile' + r]}): identical "
                f"{same:.6f}, max {worst:.3e}; {t['ms']:.4f} ms (device alone "
                f"{t['device_ms']:.4f}), twin {t['plain_ms']:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}), {100 * b_ms / t['device_ms']:.1f}% of it; {count} a call")
            del x
        rows[(c, relu)] = row
        call["norms"] += count
        del x0
    if call["norms"] != 29:
        raise AssertionError("the HiFiC cell's call has 29 norms")
    for r in routes:
        log(f"K9{r} over a HiFiC call's 29 norms: {call['ms' + r]:.3f} ms (device alone "
            f"{call['device_ms' + r]:.3f}), twin {call['plain_ms' + r]:.3f} ms, bound "
            f"{call['bound_ms' + r]:.3f} ms")
    big, small = rows[(960, True)], rows[(60, True)]
    extremes = {f"{k}{r}": big[f"{k}{r}"] for k in ("ms", "device_ms", "plain_ms", "bound_ms")
                for r in routes}
    extremes.update({f"{k}_c60{r}": small[f"{k}{r}"]
                     for k in ("ms", "device_ms", "plain_ms", "bound_ms") for r in routes})
    return dict(name="K9 channel_norm", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/channel_norm.cu",
                replaces="none (the JAX package has no HiFiC): ChannelNorm.forward's eager body",
                max_abs_err=max(r[f"max_abs_err{k}"] for r in rows.values() for k in routes),
                identical=min(r[f"identical{k}"] for r in rows.values() for k in routes),
                bound_by=big["bound_by"], library_ms=None, **extremes,
                **{f"call_{k}": v for k, v in call.items() if k != "norms"},
                design="a tile of P pixels x all channels staged once in shared memory by "
                       "cp.async, three tiles in flight, persistent grid; NCHW: C rows of P "
                       "pixels; NHWC: one span of P x C, a pixel's quads over its lanes")


def run_hific_serving(dev, card):
    """HiFiC at its published widths (seeded weights, bf16) served on two
    photos of 192x256 and on one of 200x300 (padded by reflection to
    256x320): each call launches K9 29 times, all on the NHWC route (the
    served form is channels_last), and no other kernel of the port; returns
    the launch counts."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import HiFiCConfig
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    pipe = CompressionPipeline(model_config=HiFiCConfig(), device=dev, seed=0)
    rng = np.random.RandomState(20)
    batches = [rng.randint(0, 256, (2, 192, 256, 3), dtype=np.uint8),
               rng.randint(0, 256, (1, 200, 300, 3), dtype=np.uint8)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    norm = ops.KERNEL_WRAPPERS["K9"]
    for u8 in batches:
        before, nhwc = launch_counts(), norm.launches_nhwc
        dec, info = pipe(u8)
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        if delta != expect(K9=29) or norm.launches_nhwc - nhwc != 29:
            raise AssertionError(f"HiFiC call: kernel launches {delta}, NHWC "
                                 f"{norm.launches_nhwc - nhwc}; want K9 29, all NHWC, no other")
        if dec.shape != u8.shape or dec.dtype != np.uint8 or not np.isfinite(
                info["bits"].cpu().numpy()).all():
            raise AssertionError(f"HiFiC decoded {dec.shape} {dec.dtype} or non-finite bits")
    counts = launch_counts()
    log(f"HiFiC served at full width on {card}: {len(batches)} calls; launches {counts}")
    return counts


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
    want = expect(K1=1, K2=1, K3=2, K8int8=4)  # the generators' tails: 2 encoding, 2 decoding
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
    # two columns a thread: at an odd width the last pair's right lane is masked
    odd = np.ascontiguousarray(structured_images(rng, 2, 256)[:, :255, :255])
    u8o = torch.from_numpy(odd).to(dev)
    gray_o = image_ops.rgb_to_gray(u8o.float()).contiguous()
    spec_o = saliency.spectral_residual_small(gray_o, 64, 3.0).contiguous()
    got_o, route_o = _route_of(contextual_mask,
                               lambda: contextual_mask(gray_o, spec_o, compute_dtype=bf))
    odd_ok = torch.equal(got_o, contextual_mask_plain(gray_o, spec_o, compute_dtype=bf))
    log(f"K1 bf16 at an odd width {tuple(gray_o.shape)}: {route_o}, bit-identical to the twin: "
        f"{odd_ok}")
    if not (odd_ok and route_o == "cluster_bf16"):
        raise AssertionError(f"K1 bf16 at an odd width: {route_o}, bit-identical {odd_ok}")
    ms = event_ms(lambda: contextual_mask(gray, spec, compute_dtype=bf))
    dev_ms = device_ms(lambda: contextual_mask(gray, spec, compute_dtype=bf))
    ms32 = event_ms(lambda: contextual_mask(gray, spec))
    dev_ms32 = device_ms(lambda: contextual_mask(gray, spec))
    plain = event_ms(lambda: contextual_mask_plain(gray, spec, compute_dtype=bf), reps=5, warmup=1)
    # the float32 row's count of the operations the function needs, split by
    # type: the box sums, the bilateral taps and the Gaussian are bf16 work
    # (the card's CUDA-core bf16 peak with packed bf16x2 instructions, 134
    # TFLOP/s, which this kernel issues), the entry scale, the
    # normalizations, the upsample and blend and the bilateral's division
    # float32 (67 TFLOP/s).
    pixels = gray.numel()
    rmax, ntaps, ksize = 6, 49, 31
    bf16_per_px = 8 * rmax + 7 * ntaps + 2 * 2 * ksize
    f32_per_px = 3 + 10 + 1 + 2
    nbytes = gray.numel() * 4 + spec.numel() * 4 + got.numel() * 4
    b_ms, b_by = bound_ms(nbytes, (bf16_per_px * pixels, f32_per_px * pixels),
                          (H100_BF16_CUDA_CORE_TFLOPS, H100_FP32_TFLOPS))
    log(f"K1 bf16 times: kernel {ms:.4f} ms (device alone {dev_ms:.4f}); float32 route "
        f"{ms32:.4f} ms (device alone {dev_ms32:.4f}); bf16 twin {plain:.4f} ms; bound "
        f"{b_ms:.4f} ms ({b_by}: {bf16_per_px} bf16 operations a pixel at 134 TFLOP/s, "
        f"{f32_per_px} float32 at 67), library none")
    return dict(name="K1 contextual_mask, bf16 route", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/fused_mask.cu",
                replaces="contextual_image_compression_tpu/ops/fused_mask.py:252",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_ms=dev_ms, float32_ms=ms32, float32_device_ms=dev_ms32,
                identical_share=same, max_abs_err_vs_float32=err32, mask_route=route,
                launches_per_call=per_call, tiled_route_ms=tiled_ms,
                tiled_route_max_abs_err=err_t, odd_width_bit_identical=odd_ok,
                bound_peak="bf16 work at the CUDA-core bf16 peak (134 TFLOP/s), float32 at 67")


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
    Returns the launch counts of the full-width run and its RD CSV's text."""
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
        rd_csv = pathlib.Path(results_dir, "rate_distortion_data.csv").read_text()
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
    return counts, rd_csv


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


SCRIPTS = pathlib.Path(__file__).resolve().parent / "scripts"


def _script_main(name):
    """main(argv, device) of scripts/<name>."""
    return runpy.run_path(str(SCRIPTS / name))["main"]


def _longest_kernels(trace_dir, k=5):
    """The k longest device kernels of the Chrome trace in trace_dir:
    [(name, microseconds)]."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    if len(files) != 1:
        raise AssertionError(f"want one trace in {trace_dir}, found {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [(e["name"], float(e["dur"])) for e in events
               if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        raise AssertionError(f"the trace {files[0]} holds no device kernel")
    return sorted(kernels, key=lambda kv: -kv[1])[:k], len(kernels)


def _raises_naming_matplotlib(label, call):
    try:
        call()
    except RuntimeError as exc:
        if "matplotlib" not in str(exc):
            raise
        log(f"{label}: raised {exc}")
        return
    raise AssertionError(f"{label} ran where figures cannot be written")


def run_training_flow(dev, card):
    """Phase (e): train_full_reference_flow's calls at full width (the
    module docstring). Returns the path's launch counts."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import TrainConfig
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.data.pipeline import (
        CompressionDataset, prepare_masks)
    from contextual_image_compression_tpu_torch.models.adaptive import ALL_CODEC_COMPONENTS
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer
    from contextual_image_compression_tpu_torch.utils.tree import param_bytes

    with tempfile.TemporaryDirectory() as root:
        cfg = TrainConfig(vgg_weights_path="random:0", epochs=1,
                          model_dir=os.path.join(root, "ckpt"),
                          results_dir=os.path.join(root, "results"))
        imgs = synthetic_images(32, cfg.model.img_size, seed=1)
        trainer = GANTrainer(cfg, device=dev, log_fn=log)
        state = trainer.init_state(resume=False)
        n_params = sum(p.numel() for m in (state.codec, state.disc) for p in m.parameters())
        state_bytes = param_bytes(state.codec) + param_bytes(state.disc) + 2 * 4 * n_params
        if shutil.disk_usage(root).free < 2 * state_bytes:
            raise AssertionError(f"the train-state checkpoint needs ~{state_bytes / 1e9:.2f} GB "
                                 f"and room to rewrite it")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        masks = prepare_masks(imgs, cfg.saliency, device=dev)
        ds = CompressionDataset(imgs, masks, batch_size=cfg.batch_size, bpp_range=cfg.bpp_range,
                                seed=cfg.seed, device_resident=True, device=dev)
        if not CARD_FIGURES:
            _raises_naming_matplotlib("GANTrainer.fit(artifacts=True), before any step",
                                      lambda: trainer.fit(ds))
            _raises_naming_matplotlib(
                "scripts/torch_train_gan.py main, before any step",
                lambda: _script_main("torch_train_gan.py")(
                    ["--synthetic", "32", "--model-dir", cfg.model_dir, "--results-dir",
                     cfg.results_dir], device="cuda"))
            if state.step != 0 or os.listdir(cfg.model_dir) or os.path.exists(cfg.results_dir):
                raise AssertionError("an entry point trained or wrote files before raising")
        trace_dir = os.path.join(root, "trace")
        fits = []
        for label, data, epochs, kw in (
                ("fit", ds, cfg.epochs, dict(profile_dir=trace_dir, profile_steps=2)),
                ("fine-tune at bpp 1.0", ds.with_target_bpp(1.0), cfg.fine_tune_epochs, {})):
            t0 = time.perf_counter()
            trainer.fit(data, epochs=epochs, artifacts=CARD_FIGURES, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            fits.append((label, epochs * ds.steps_per_epoch * cfg.batch_size / dt, dt))
        probe_png = os.path.join(cfg.results_dir, "rate_control_test.png") if CARD_FIGURES else None
        probe = trainer.rate_control_probe(ds.first_samples(), probe_png)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        steps = (cfg.epochs + cfg.fine_tune_epochs) * ds.steps_per_epoch
        art = (cfg.epochs + cfg.fine_tune_epochs) if CARD_FIGURES else 0  # a forward + a probe
        want = expect(K1=1, K2=steps + 3 + 4 * art, K3=2 * steps + 6 + 8 * art, K3b=2 * steps)
        if counts != want:
            raise AssertionError(f"training flow launches {counts}, want {want}")
        check_cluster_route("training flow")
        check_attention_route("training flow", "tf32x3")
        with open(os.path.join(cfg.model_dir, "metadata_final.json")) as f:
            meta = json.load(f)
        final = sorted(os.listdir(cfg.model_dir))
        want_final = sorted([f"{c}_final.msgpack" for c in ALL_CODEC_COMPONENTS]
                            + ["discriminator_final.msgpack", "optimizers_final.msgpack",
                               "metadata_final.json"])
        ratios = [r for _, r, _ in probe]
        hist = trainer.history
        if not (all(len(v) == 4 and all(math.isfinite(x) for x in v) for v in hist.values())
                and meta["epoch"] == 4 and final == want_final
                and all(math.isfinite(r) and math.isfinite(g) for _, r, g in probe)
                and ratios == sorted(ratios)):
            raise AssertionError(f"training flow: history {hist}, metadata epoch {meta['epoch']}, "
                                 f"files {final}, probe {probe}")
        longest, n_kernels = _longest_kernels(trace_dir)
        t0 = time.perf_counter()
        trainer.save("final", blocking=True)
        t_save = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(os.path.join(cfg.model_dir, f)) for f in final)
    log(f"training flow at full width on {card} (ModelConfig(), B = {cfg.batch_size}, float32, "
        f"TF32 off, random VGG19, {len(imgs)} images, {ds.steps_per_epoch} steps an epoch, "
        f"figures {'on' if CARD_FIGURES else 'off: no matplotlib'}): "
        + "; ".join(f"{label} {ips:.1f} img/s ({dt:.2f} s with its 'final' save)"
                    for label, ips, dt in fits)
        + f"; a 'final' save on its own {t_save:.2f} s ({nbytes / 1e9:.2f} GB); peak memory "
        f"{peak / 2 ** 30:.2f} GiB; launches {counts}; history {json.dumps(hist)}; probe {probe}")
    log(f"training flow trace (torch.profiler, step 1 of the first epoch on): {n_kernels} device "
        f"kernels; the five longest: "
        + "; ".join(f"{name[:90]} {us:.1f} us" for name, us in longest))
    return counts


def _finite_rows(label, rows):
    bad = [r for r in rows for k, v in r.items()
           if not isinstance(v, bool) and isinstance(v, float) and not math.isfinite(v)]
    if not rows or bad:
        raise AssertionError(f"{label}: rows {rows}")


def run_cli_paths(dev, card, model_dir):
    """Phase (f): the codec CLIs on the card (the module docstring).
    Returns each CLI's launch counts."""
    import cv2

    from contextual_image_compression_tpu_torch import ops

    jpegs = sorted(str(p) for p in EVAL_IMAGES.glob("*.jpg"))
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        compress = _script_main("torch_compress.py")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        compress(["encode", *jpegs, "--out-dir", f"{tmp}/card", "--quality", "75"], device="cuda")
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        cics = sorted(str(p) for p in pathlib.Path(tmp, "card").glob("*.cic"))
        t0 = time.perf_counter()
        compress(["decode", *cics, "--out-dir", f"{tmp}/png"], device="cuda")
        t_dec = time.perf_counter() - t0
        paths["compress_cli"] = counts = launch_counts()
        if counts != expect(K5=len(jpegs)):
            raise AssertionError(f"compress CLI launches {counts}, want K5 {len(jpegs)}")
        compress(["encode", *jpegs, "--out-dir", f"{tmp}/cpu", "--quality", "75"], device="cpu")
        same = [pathlib.Path(c).read_bytes() == pathlib.Path(tmp, "cpu", pathlib.Path(c).name)
                .read_bytes() for c in cics]
        pngs = [cv2.imread(str(pathlib.Path(tmp, "png", pathlib.Path(c).stem + ".png"))) for c in cics]
        log(f"torch_compress.py on {card}: {len(jpegs)} JPEGs at quality 75 encoded in "
            f"{t_enc:.2f} s, decoded in {t_dec:.2f} s (host clock, files included); streams "
            f"byte-identical to the CPU's: {sum(same)} of {len(cics)}; launches {counts}")
        if len(cics) != len(jpegs) or not all(same) or any(
                p is None or p.shape != cv2.imread(j).shape for p, j in zip(pngs, jpegs)):
            raise AssertionError("compress CLI: streams or decoded images differ")

        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _script_main("torch_eval_bitstream.py")(
            ["--model-dir", model_dir, "--synthetic", "16", "--out", f"{tmp}/eb.json"],
            device="cuda")
        torch.cuda.synchronize()
        t_eb = time.perf_counter() - t0
        paths["eval_bitstream_cli"] = counts = launch_counts()
        with open(f"{tmp}/eb.json") as f:
            eb = json.load(f)
        nb = len(eb["rows"])
        if counts != expect(K1=2 * nb, K2=2 * nb, K3=4 * nb, K8int8=6 * nb):
            raise AssertionError(f"eval_bitstream CLI launches {counts}")
        check_cluster_route("eval_bitstream CLI")
        check_attention_route("eval_bitstream CLI", "wgmma")
        _finite_rows("eval_bitstream CLI", eb["rows"])
        log(f"torch_eval_bitstream.py on {card} (phase (b)'s full-width model_dir, 16 images, "
            f"{nb} bpps) {t_eb:.2f} s: rows {eb['rows']}; launches {counts}")

        ops.reset_launch_counts()
        shootout = _script_main("torch_codec_shootout.py")
        argv = ["--model-dir", model_dir, "--ae-dir", str(EVAL_IMAGES.parent / "model"),
                "--synthetic", "16", "--out", f"{tmp}/cs.json", "--plot", f"{tmp}/cs.png"]
        t0 = time.perf_counter()
        if CARD_FIGURES:
            shootout(argv, device="cuda")
        else:
            _raises_naming_matplotlib("torch_codec_shootout.py's plot, after its JSON",
                                      lambda: shootout(argv, device="cuda"))
        torch.cuda.synchronize()
        t_cs = time.perf_counter() - t0
        paths["shootout_cli"] = counts = launch_counts()
        if counts != expect(K5=6, K1=1, K2=8, K3=16):
            raise AssertionError(f"codec shootout CLI launches {counts}")
        check_cluster_route("codec shootout CLI")
        check_attention_route("codec shootout CLI", "tf32x3")
        with open(f"{tmp}/cs.json") as f:
            cs = json.load(f)
        for series in ("dct", "gan", "ae"):
            _finite_rows(f"codec shootout {series}", cs[series])
        log(f"torch_codec_shootout.py on {card} (16 images, 256^2) {t_cs:.2f} s: "
            + "; ".join(f"{series} {cs[series]}" for series in ("dct", "gan", "ae"))
            + f"; launches {counts}")
    return paths


# ----------------------------------------------------------------- phase (g)
# The JAX package's options (use_pallas=False, bf16 parameters, dense_w8 in
# training) and the tool CLIs (the module docstring, "The options slice").

BF16_PARAMS = dict(dtype="bfloat16", param_dtype="bfloat16")
W8_LAYERS = ("hq_encoder.latent_dense.weight", "lq_encoder.latent_dense.weight",
             "hq_generator.fc.weight", "lq_generator.fc.weight")


def _two_steps(trainer, ds):
    """A step with D, then one without, on the dataset's first two batches;
    returns their metrics as floats."""
    it = ds.epoch()
    metrics = []
    for do_d in (True, False):
        _, m = trainer.builder.train_step(trainer.state, next(it), do_d)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    return metrics


def _training_data(cfg, dev, seed):
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.data.pipeline import (
        CompressionDataset, prepare_masks)

    imgs = synthetic_images(32, cfg.model.img_size, seed=seed)
    masks = prepare_masks(imgs, cfg.saliency, device=dev)
    return CompressionDataset(imgs, masks, batch_size=cfg.batch_size, seed=cfg.seed,
                              device_resident=True, device=dev)


def run_bf16_param_training(dev, card, model_dir):
    """Phase (g1): ModelConfig(dtype='bfloat16', param_dtype='bfloat16') at
    B = 16 with random VGG19: masks of 32 images through K1, an inference
    forward, a step with D and one without, then a 'final' save resumed
    bitwise by a fresh trainer. Fails unless the parameters and Adam moments
    are bf16 and the BatchNorm statistics float32 (as the JAX trainer keeps
    them), the parameters and statistics moved, every metric is finite, and
    the launches are K1 +1, K2 +3 ("wgmma"), K3 +6, K3b +4. Then times steps
    with and without D. Returns the path's launch counts."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import ModelConfig, TrainConfig
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer
    from contextual_image_compression_tpu_torch.utils.tree import param_bytes

    cfg = TrainConfig(model=ModelConfig(**BF16_PARAMS), vgg_weights_path="random:0",
                      model_dir=model_dir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    ds = _training_data(cfg, dev, seed=4)
    trainer = GANTrainer(cfg, device=dev, log_fn=log)
    state = trainer.init_state(resume=False)
    params = [p for m in (state.codec, state.disc) for p in m.parameters()]
    stats = [b for b in state.codec.buffers() if b.is_floating_point()]
    if {p.dtype for p in params} != {torch.bfloat16} or {b.dtype for b in stats} != {
            torch.float32}:
        raise AssertionError("bf16-parameter codec: parameters or BN statistics of other dtypes")
    before = [p.detach().clone() for p in params]
    stats_before = state.codec.hq_generator.bn0.running_mean.clone()
    batch = next(ds.epoch())
    with torch.no_grad():
        out = state.codec.apply(batch.image.permute(0, 2, 3, 1), batch.mask.permute(0, 2, 3, 1),
                                batch.bpp)
    if out.blended.dtype != torch.bfloat16 or not bool(torch.isfinite(out.blended).all()):
        raise AssertionError("bf16-parameter forward: blended image not finite bf16")
    t0 = time.perf_counter()
    metrics = _two_steps(trainer, ds)
    t_steps = time.perf_counter() - t0
    counts = launch_counts()
    want = expect(K1=1, K2=3, K3=6, K3b=4)
    if counts != want:
        raise AssertionError(f"bf16-parameter training launches {counts}, want {want}")
    check_cluster_route("bf16-parameter training")
    check_attention_route("bf16-parameter training", "wgmma")
    moments = [v for o in (state.g_opt, state.ls_opt, state.rd_opt, state.d_opt)
               for st in o.adam.state.values() for k, v in st.items() if k != "step"]
    moved = sum(not torch.equal(a, p) for a, p in zip(before, params))
    bad = [k for m in metrics for k, v in m.items() if not math.isfinite(v)]
    if ({t.dtype for t in moments} != {torch.bfloat16} or moved < 0.5 * len(params)
            or torch.equal(stats_before, state.codec.hq_generator.bn0.running_mean) or bad
            or not all(bool(torch.isfinite(p).all()) for p in params)):
        raise AssertionError(f"bf16-parameter training: moment dtypes {set(t.dtype for t in moments)}, "
                             f"{moved} of {len(params)} parameter tensors moved, non-finite {bad}")
    need = param_bytes(state.codec) + param_bytes(state.disc) * 3 + 2 * param_bytes(state.codec)
    if shutil.disk_usage(model_dir).free < 2 * need:
        raise AssertionError(f"the bf16 train state needs ~{need / 1e9:.2f} GB")
    t0 = time.perf_counter()
    trainer.save("final", blocking=True)
    t_save = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(os.path.join(model_dir, f)) for f in os.listdir(model_dir))
    t0 = time.perf_counter()
    restored = GANTrainer(cfg, device=dev, log_fn=lambda msg: None).init_state(resume=True)
    torch.cuda.synchronize()
    t_resume = time.perf_counter() - t0
    differ = _states_equal(state, restored)
    if differ:
        raise AssertionError(f"the resumed bf16 train state differs: {differ[:10]}")
    del restored
    peak = torch.cuda.max_memory_allocated()
    md, mnd = _step_ms(trainer, ds, steps=4)
    log(f"bf16-parameter GAN training on {card} (TrainConfig() with ModelConfig(dtype="
        f"'bfloat16', param_dtype='bfloat16'), B = {cfg.batch_size}, random VGG19): parameters "
        f"and Adam moments bf16, BN statistics float32; the two counted steps {t_steps:.2f} s "
        f"(cuDNN's autotuning in the first); 'final' {nbytes / 1e9:.2f} GB saved in {t_save:.2f} "
        f"s and resumed bitwise in {t_resume:.2f} s; step with D {md * 1e3:.2f} ms, without D "
        f"{mnd * 1e3:.2f} ms (median of 2 each, CUDA-synchronized host clock); peak memory "
        f"{peak / 2 ** 30:.2f} GiB; metrics {metrics}; launches {counts}")
    return counts


def _perturb_codec(codec, gen):
    """Draw the codec's BatchNorm statistics and scales, every bias and the
    SAGAN gammas as the CPU tests' `perturb_variables` draws them (means
    0.1 N(0, 1), variances and scales U(0.75, 1.25), biases 0.05 N(0, 1),
    gamma 0.5), in place, so the optimizers keep their parameters."""
    from contextual_image_compression_tpu_torch.models.layers import KBatchNorm

    def draw(t, kind):
        if kind == "normal":
            return torch.randn(t.shape, generator=gen, device=t.device, dtype=t.dtype)
        return torch.rand(t.shape, generator=gen, device=t.device, dtype=t.dtype)

    with torch.no_grad():
        for mod in codec.modules():
            if isinstance(mod, KBatchNorm):
                mod.weight.copy_(draw(mod.weight, "uniform") * 0.5 + 0.75)
                mod.running_mean.copy_(draw(mod.running_mean, "normal") * 0.1)
                mod.running_var.copy_(draw(mod.running_var, "uniform") * 0.5 + 0.75)
        for name, p in codec.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                p.fill_(0.5)
            elif leaf == "bias":
                p.copy_(draw(p, "normal") * 0.05)


def _nonzero_symbols(codec, batch):
    """The share of nonzero quantized latents (HQ, LQ) of an inference
    forward on the batch: where all are 0, the quantizer's scale path gives
    no gradient and the generators' fc layers see a zero input."""
    with torch.no_grad():
        out = codec.apply(batch.image.permute(0, 2, 3, 1), batch.mask.permute(0, 2, 3, 1),
                          batch.bpp)
    return tuple(float((z != 0).float().mean()) for z in (out.hq_latent_q, out.lq_latent_q))


def run_dense_w8_training(dev, card):
    """Phase (g2): TrainConfig() in float32 with dense_w8 and BatchNorm on its
    running statistics (bn_mode 'frozen': the JAX codec quantizes the latent
    and fc projections at trace time only outside batch statistics),
    random VGG19: masks through K1, a step with D and one without. At the
    seeded init every quantized latent is 0 (the share is measured and
    logged, an inference forward before the draws and one after), which
    gives the w8 kernels no gradient, so the codec starts from
    `_perturb_codec`'s draws, as the CPU tests' codecs do. Fails unless
    the launches are K1 +1, K2 +4 ("tf32x3"), K3 +8, K3b +4, every
    metric is finite, some latent is nonzero, in each step each w8 kernel's
    gradient is nonzero only at the arg-max |w| entries of its rows (it
    reaches them through the scale row alone), and every w8 kernel moved,
    only at entries that were a row's arg-max at the start of a step.
    Returns the launch counts of the steps."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import ModelConfig, TrainConfig
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer

    cfg = TrainConfig(model=ModelConfig(dense_w8=True), vgg_weights_path="random:0")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    ds = _training_data(cfg, dev, seed=5)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = GANTrainer(dataclasses.replace(cfg, model_dir=tmp), bn_mode="frozen",
                             device=dev, log_fn=log)
    state = trainer.init_state(resume=False)
    layers = {k: state.codec.get_submodule(k.rsplit(".", 1)[0]) for k in W8_LAYERS}
    batches = list(itertools.islice(ds.epoch(), 2))
    at_init = _nonzero_symbols(state.codec, batches[0])
    _perturb_codec(state.codec, torch.Generator(device=dev).manual_seed(11))
    perturbed = _nonzero_symbols(state.codec, batches[0])
    if not max(perturbed) > 0:
        raise AssertionError(f"dense_w8 training: every latent symbol is 0 after the draws")

    def arg_max(layer):
        w = layer.weight.detach().abs()
        return w == w.amax(dim=1, keepdim=True)

    def support(name, layer, where):
        nonzero = layer.weight.grad != 0
        if bool((nonzero & ~where).any()):
            raise AssertionError(f"{name}: a w8 kernel's gradient off its rows' arg-max entries")
        return int(nonzero.sum()), float(layer.weight.grad.abs().max())

    start = {k: layer.weight.detach().clone() for k, layer in layers.items()}
    allowed = {k: torch.zeros_like(w, dtype=torch.bool) for k, w in start.items()}
    metrics, grads = [], []
    t0 = time.perf_counter()
    for do_d, batch in zip((True, False), batches):
        where = {k: arg_max(layer) for k, layer in layers.items()}
        _, m = trainer.builder.train_step(state, batch, do_d)
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({k.split(".")[0]: support(k, layer, where[k]) for k, layer in layers.items()})
        for k in W8_LAYERS:
            allowed[k] |= where[k]
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    counts = launch_counts()
    want = expect(K1=1, K2=4, K3=8, K3b=4)
    if counts != want:
        raise AssertionError(f"dense_w8 training launches {counts}, want {want}")
    check_cluster_route("dense_w8 training")
    check_attention_route("dense_w8 training", "tf32x3")
    moved = {}
    for k, layer in layers.items():
        changed = layer.weight.detach() != start[k]
        if bool((changed & ~allowed[k]).any()):
            raise AssertionError(f"{k}: a w8 kernel moved off its rows' arg-max entries")
        moved[k.split(".")[0]] = (int(changed.any(dim=1).sum()), int(changed.shape[0]))
    if not all(rows > 0 for rows, _ in moved.values()):
        raise AssertionError(f"dense_w8 training: a w8 kernel did not move: rows moved {moved}, "
                             f"(entries, max |g|) per step {grads}")
    bad = [k for m in metrics for k, v in m.items() if not math.isfinite(v)]
    if bad:
        raise AssertionError(f"dense_w8 training: non-finite metrics {bad}")
    log(f"dense_w8 GAN training on {card} (TrainConfig() float32, dense_w8, bn_mode 'frozen', "
        f"random VGG19): nonzero quantized latents (HQ, LQ) {at_init} at the seeded init, "
        f"{perturbed} from the tests' draws of BN statistics, scales, biases and gamma; two "
        f"steps {t_steps:.2f} s; the w8 kernels' gradients only at their rows' arg-max "
        f"entries, (entries, max |g|) per step {grads}; (rows moved, rows) {moved}, only at "
        f"arg-max entries; metrics {metrics}; launches {counts}")
    return counts


def _psnr_u8(a, b):
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10 * math.log10(255.0 ** 2 / mse)


def run_use_pallas_false(dev, card):
    """Phase (g3): the use_pallas=False routes at full width, each run first
    with the launch counts at 0 (its column of the kernels line), then its
    kernel route on the same inputs for the bars and the times (not
    counted): serving at B = 16 with attention_use_pallas=False and
    QuantizerConfig(use_pallas=False) (K1 +1 a call, no K2 or K3; decoded
    PSNR >= 40 dB against the kernel route, symbols within +-1 and >= 95%
    identical), masks of 128 images with mask_use_pallas=False for the
    three methods (no K1 or K4; within 1e-4 of the kernel routes) and the
    DCT round trip at B = 128 with use_pallas=False (no K5; symbols within
    +-1 and >= 99.99% identical, reconstruction within 1e-4). Returns the
    three routes' launch counts."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import (
        DCTCodecConfig, ModelConfig, QuantizerConfig, SaliencyConfig)
    from contextual_image_compression_tpu_torch.data.images import (
        rich_synthetic_images, synthetic_images)
    from contextual_image_compression_tpu_torch.data.pipeline import prepare_masks
    from contextual_image_compression_tpu_torch.measure import randomize_stats, structured_images
    from contextual_image_compression_tpu_torch.ops.dct import DCTCodec
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    paths = {}
    u8 = structured_images(np.random.RandomState(2), 16, 256)
    routes = {}
    for name, mcfg in (("jnp", ModelConfig(attention_use_pallas=False,
                                           quantizer=QuantizerConfig(use_pallas=False))),
                       ("kernels", ModelConfig())):
        pipe = CompressionPipeline(model_config=mcfg, device=dev, seed=0)
        randomize_stats(pipe.codec, 0)
        pipe(u8, target_bpp=1.0)  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        dec, info = pipe(u8, target_bpp=1.0)
        if name == "jnp":
            paths["no_pallas_serving"] = launch_counts()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            pipe(u8, target_bpp=1.0)
            times.append(time.perf_counter() - t0)
        routes[name] = (dec, info["hq_symbols"].cpu().numpy(), info["lq_symbols"].cpu().numpy(),
                        float(np.median(times)))
        del pipe
    if paths["no_pallas_serving"] != expect(K1=1, K8int8=2):
        raise AssertionError(f"use_pallas=False serving launches {paths['no_pallas_serving']}")
    psnr = _psnr_u8(routes["jnp"][0], routes["kernels"][0])
    sym = [np.abs(routes["jnp"][i] - routes["kernels"][i]) for i in (1, 2)]
    same = float(np.mean(np.concatenate([s.ravel() for s in sym]) == 0))
    log(f"use_pallas=False serving at full width on {card} (B = 16, bf16, w8, int8 tail; the "
        f"attention block and the quantizer by JAX's jnp formulas): {routes['jnp'][3] * 1e3:.2f} "
        f"ms/call against the kernel route's {routes['kernels'][3] * 1e3:.2f} (median of 3, host "
        f"clock, u8 in / out); decoded PSNR against the kernel route {psnr:.2f} dB (bar 40), "
        f"symbols within {max(float(s.max()) for s in sym):.0f} (bar 1), {same * 100:.3f}% "
        f"identical (bar 95%); launches {paths['no_pallas_serving']}")
    if not (psnr >= 40 and max(float(s.max()) for s in sym) <= 1 and same >= 0.95):
        raise AssertionError("use_pallas=False serving misses the kernel route's bars")

    n, batch = 128, 64
    imgs = rich_synthetic_images(n, (256, 256), seed=61)
    mask_counts = {k: 0 for k in expect()}
    for method in ("combined", "spectral_residual", "fine_grained"):
        outs, secs = {}, {}
        for name, flag in (("jnp", False), ("kernels", True)):
            cfg = SaliencyConfig(method=method, mask_use_pallas=flag)
            prepare_masks(imgs[:batch], cfg, device_batch=batch, device=dev)  # warm-up
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            outs[name] = prepare_masks(imgs, cfg, device_batch=batch, device=dev)
            secs[name] = time.perf_counter() - t0
            if name == "jnp":
                mask_counts = {k: mask_counts[k] + v for k, v in launch_counts().items()}
        err = float(np.abs(outs["jnp"] - outs["kernels"]).max())
        log(f"mask_use_pallas=False masks ({method}) of {n} images at 256^2 on {card}: "
            f"{secs['jnp'] * 1e3 / n:.4f} ms/image against the kernel route's "
            f"{secs['kernels'] * 1e3 / n:.4f} (host clock, batches of {batch}, numpy in / out); "
            f"max |jnp - kernel| {err:.3e} (bar 1e-4)")
        if not (err <= 1e-4 and outs["jnp"].shape == (n, 256, 256, 1)):
            raise AssertionError(f"mask_use_pallas=False {method} masks: {err}")
    paths["no_pallas_masks"] = mask_counts
    if mask_counts != expect():
        raise AssertionError(f"mask_use_pallas=False launches {mask_counts}")

    x = torch.from_numpy(synthetic_images(128, (256, 256), seed=71)).to(dev)
    res, secs = {}, {}
    for name, flag in (("jnp", False), ("kernels", True)):
        codec = DCTCodec(DCTCodecConfig(use_pallas=flag), device=dev)
        codec.roundtrip(x)  # warm-up
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        res[name] = codec.roundtrip(x)
        torch.cuda.synchronize()
        if name == "jnp":
            paths["no_pallas_dct"] = launch_counts()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            codec.roundtrip(x)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        secs[name] = float(np.median(times))
    dsym = (res["jnp"][1] - res["kernels"][1]).abs()
    drec = float((res["jnp"][0] - res["kernels"][0]).abs().max())
    same = float((dsym == 0).double().mean())
    log(f"DCTCodecConfig(use_pallas=False) round trip B = 128, 256^2, quality 75 on {card}: "
        f"{secs['jnp'] * 1e3:.3f} ms/call against K5's {secs['kernels'] * 1e3:.3f} (median of 5, "
        f"CUDA-synchronized host clock); symbols within {float(dsym.max()):.0f} (bar 1), "
        f"{same * 100:.4f}% identical (bar 99.99%), reconstruction within {drec:.3e} (bar 1e-4); "
        f"launches {paths['no_pallas_dct']}")
    if paths["no_pallas_dct"] != expect() or not (float(dsym.max()) <= 1 and same >= 0.9999
                                                  and drec <= 1e-4):
        raise AssertionError("DCTCodecConfig(use_pallas=False) misses K5's bars")
    return paths


def run_tool_clis(dev, card, rd_csv):
    """Phase (g4): the four CLIs of the slice on the card.
    torch_profile_codec.py --batch 16 --iters 5 --trace (K1 once a
    saliency_mask call; K2 once a codec_full, encoder_hq and attention_pallas
    call, none in attention_xla's; K3 twice a codec_full and glue call),
    torch_layer_microbench.py --batch 16 --iters 5 (cuDNN and cuBLAS only:
    no kernel of the port), torch_compare_rd.py on evaluation phase (c)'s
    RD CSV against itself (PSNR deltas +0.00 dB; --plot raises naming
    matplotlib where it does not import), torch_convert_vgg_weights.py on a
    synthetic VGG19 state dict (the port's load_vgg19_features reads the
    .npz back; an .h5 raises naming h5py where it does not import). Returns
    each CLI's launch counts."""
    import contextlib
    import io

    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.models.vgg import (
        VGG19_LAYOUT, load_vgg19_features)

    paths = {}
    iters, warmup = 5, 3  # measure.event_ms's warm-up calls
    with tempfile.TemporaryDirectory() as tmp:
        ops.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            _script_main("torch_profile_codec.py")(
                ["--batch", "16", "--iters", str(iters), "--trace", f"{tmp}/trace"], device="cuda")
        torch.cuda.synchronize()
        t_prof = time.perf_counter() - t0
        paths["profile_codec_cli"] = counts = launch_counts()
        calls = iters + warmup
        want = expect(K1=calls, K2=3 * calls + 1 + 5, K3=4 * calls + 10)
        if counts != want:
            raise AssertionError(f"profile_codec CLI launches {counts}, want {want} (K2 in "
                                 "attention_xla would add one a call)")
        check_cluster_route("profile_codec CLI")
        check_attention_route("profile_codec CLI", "wgmma")
        row = json.loads(buf.getvalue().strip().splitlines()[-1])
        traces = os.listdir(f"{tmp}/trace")
        log(f"torch_profile_codec.py --batch 16 on {card} ({t_prof:.2f} s, img/s per row, CUDA "
            f"events): {json.dumps(row)}; trace files {traces}; launches {counts}")
        if len(traces) != 1 or not all(v > 0 for k, v in row.items() if k not in ("batch",
                                                                                  "backend")):
            raise AssertionError(f"profile_codec CLI: {row}, {traces}")

        ops.reset_launch_counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            _script_main("torch_layer_microbench.py")(["--batch", "16", "--iters", str(iters)],
                                                      device="cuda")
        t_layers = time.perf_counter() - t0
        paths["layer_microbench_cli"] = counts = launch_counts()
        layers = json.loads(buf.getvalue().strip().splitlines()[-1])
        log(f"torch_layer_microbench.py --batch 16 on {card} ({t_layers:.2f} s, bf16, CUDA events): "
            f"{json.dumps(layers)}; launches {counts}")
        if counts != expect() or len(layers) != 20:
            raise AssertionError(f"layer_microbench CLI: {len(layers)} rows, launches {counts}")

        ops.reset_launch_counts()
        csv_path = pathlib.Path(tmp, "rate_distortion_data.csv")
        csv_path.write_text(rd_csv)
        compare = _script_main("torch_compare_rd.py")
        runs = [f"card={csv_path}", f"again={csv_path}"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            compare(runs, device="cuda")
        table = buf.getvalue()
        deltas = table.strip().splitlines()[-1]
        if CARD_FIGURES:
            compare(runs + ["--plot", f"{tmp}/rd.png"], device="cuda")
            plotted = "the overlay written"
        else:
            with contextlib.redirect_stdout(io.StringIO()):
                _raises_naming_matplotlib("torch_compare_rd.py --plot", lambda: compare(
                    runs + ["--plot", f"{tmp}/rd.png"], device="cuda"))
            plotted = "no --plot: matplotlib does not import here"
        log(f"torch_compare_rd.py on evaluation phase (c)'s RD CSV against itself: {deltas!r}; "
            f"{plotted}")
        if set(re.findall(r"[+-]\d+\.\d+ dB", deltas)) != {"+0.00 dB"}:
            raise AssertionError(f"compare_rd CLI: {table}")
        paths["compare_rd_cli"] = launch_counts()

        ops.reset_launch_counts()
        gen = torch.Generator().manual_seed(7)
        state, idx, cin = {}, 0, 3
        for width, n_convs in VGG19_LAYOUT:
            for _ in range(n_convs):
                state[f"features.{idx}.weight"] = torch.randn(width, cin, 3, 3, generator=gen) * 0.05
                state[f"features.{idx}.bias"] = torch.randn(width, generator=gen) * 0.01
                cin, idx = width, idx + 2
            idx += 1
        src, npz = os.path.join(tmp, "vgg19_synthetic.pth"), os.path.join(tmp, "vgg19.npz")
        torch.save(state, src)
        convert_vgg = _script_main("torch_convert_vgg_weights.py")
        with contextlib.redirect_stdout(io.StringIO()):
            convert_vgg([src, npz], device="cuda")
        tower = load_vgg19_features(npz, device=dev)
        try:
            import h5py  # noqa: F401
            h5 = "h5py imports here: the .h5 route was not exercised"
        except ImportError:
            pathlib.Path(tmp, "vgg19.h5").write_bytes(b"")
            try:
                convert_vgg([os.path.join(tmp, "vgg19.h5"), os.path.join(tmp, "x.npz")],
                            device="cuda")
            except RuntimeError as exc:
                if "h5py" not in str(exc):
                    raise
                h5 = f"an .h5 raised: {exc}"
            else:
                raise AssertionError("an .h5 converted where h5py does not import")
        paths["convert_vgg_cli"] = counts = launch_counts()
        log(f"torch_convert_vgg_weights.py on a synthetic VGG19 .pth: {os.path.getsize(npz)} "
            f"bytes written, loaded back by load_vgg19_features (fingerprint verified): "
            f"{tower is not None}; {h5}; launches {counts}")
        if tower is None or counts != expect():
            raise AssertionError("convert_vgg_weights CLI: the .npz did not load back")
    return paths


# ----------------------------------------------------------------- phase (h)
# The multi-device slice: the (data, model) mesh over torch.distributed at
# full width (the module docstring, "The multi-device slice").

MESH_BATCH = 16
MESH_SCHEDULE = (True, False) * 3  # D every other step, as dryrun_multichip's
# |mesh - one device| <= a + r |one device|: dryrun_multichip's bar for step 0; after
# an update 1e-3 + 1e-4 |ref|, since Adam's first step moves every parameter by
# +-lr whatever its gradient's size, so a gradient within rounding of zero (cuDNN's
# atomics, 8 against 16 images a call, the row-parallel order of sums) puts its
# parameter 2 lr = 2e-4 from the one-device run's. Measured after an update: up to
# 4.65e-4 from one device, and one device up to 3.5e-4 from itself (PERF.md)
MESH_BARS = ((2e-4, 1e-4),) + ((1e-3, 1e-4),) * 5
# The two ranks' metrics: on (2, 1) equal; on (1, 2) both ranks of the model group
# compute the replicated layers, and cuDNN's per-process choices put their metrics
# up to 6e-8 apart (measured; the parameters stay equal: reduce_gradients
# broadcasts the first rank's gradients of the replicated leaves)
MESH_RANK_BAR = 1e-5
# The parameters and BatchNorm statistics after step 0, gathered from the mesh, against
# the one-device run's. Step 0's metrics are taken before the update, so this is what
# holds the mesh's gradients (their sum over the data group, the synchronized
# BatchNorm's and the perceptual z-scores' backward) to one device's. Adam's first
# step moves an element by lr g / (|g| + eps). Where one device's update is saturated,
# |update| >= 0.99 lr (|g| >= 99 eps), any gradient of the same sign lands within
# 0.01 lr <= 1e-6 of it, whatever its rounding: there at least MESH_PARAM_BAR[1] of
# the elements must lie within 1e-6 (a test of the gradient's sign), and everywhere
# within 2 lr. The share within 1e-6 over all elements (tests/test_torch_sharded_train.py's
# rule on the CPU) is printed, not held: at full width the clip puts most elements of
# the four projections near eps, where the update follows the gradient's rounding, and
# one device lies 99.81-99.95% within 1e-6 of itself (PERF.md).
MESH_PARAM_BAR = (1e-6, 0.9999)
MESH_UPDATE_EDGES = (0.01, 0.4, 0.99)  # buckets of |one device's update| / lr


def _mesh_data(cfg, dev):
    """The global batch of phase (h): 16 synthetic 256^2 images, their masks
    (K1 +1) and seeded bpps; and 3 uint8 images for the ragged serving call."""
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.data.pipeline import (
        CompressionDataset, prepare_masks)

    imgs = synthetic_images(MESH_BATCH, cfg.model.img_size, seed=3)
    masks = prepare_masks(imgs, cfg.saliency, device=dev)
    ds = CompressionDataset(imgs, masks, batch_size=MESH_BATCH, seed=cfg.seed, device=dev)
    u8 = np.clip(np.round((imgs[:3] + 1.0) * 127.5), 0, 255).astype(np.uint8)
    return next(ds.epoch(shuffle=False)), u8


def _mesh_steps(trainer, batch, schedule):
    out = []
    for do_d in schedule:
        _, m = trainer.builder.train_step(trainer.state, trainer.builder.place_batch(batch), do_d)
        out.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    return out


def _full_state(state):
    """The codec's and D's parameters and BatchNorm statistics, whole (the
    split leaves gathered: a collective on a mesh), on the host."""
    from contextual_image_compression_tpu_torch.parallel import sharding

    return {f"{part}.{k}": v.detach().cpu() for part, mod in (("codec", state.codec),
                                                              ("disc", state.disc))
            for k, v in sharding.full_state_dict(mod).items()}


def _step_lr(cfg, name):
    """The learning rate of the optimizer of state entry `name` (the
    trainer's optimizer groups; BatchNorm statistics take the base rate)."""
    from contextual_image_compression_tpu_torch.models.adaptive import (
        LATENT_SALIENCY_COMPONENTS, RD_COMPONENTS)

    comp = name.split(".")[1]
    scale = (cfg.ls_lr_scale if comp in LATENT_SALIENCY_COMPONENTS else
             cfg.rd_lr_scale if comp in RD_COMPONENTS else 1.0)
    return cfg.learning_rate * scale


def _param_agreement(got, want, init, cfg, dev):
    """got / want: states after step 0 from one init. Returns {"share": of
    elements within MESH_PARAM_BAR's 1e-6, "saturated": that share where
    want's update is saturated, "worst": largest |got - want|, "buckets":
    [(elements, within 1e-6, same sign of the update)] by |want - init| /
    lr (MESH_UPDATE_EDGES), "tensors": the 6 with most elements outside
    1e-6 (name, elements, outside)}."""
    edges = torch.tensor((0.0,) + MESH_UPDATE_EDGES + (float("inf"),), device=dev)
    buckets = torch.zeros(len(edges) - 1, 3, dtype=torch.float64, device=dev)
    worst, tensors = 0.0, []
    for k, w in want.items():
        w, g, p0 = (t.to(dev).float().reshape(-1) for t in (w, got[k], init[k]))
        err = (g - w).abs()
        dw, dg = w - p0, g - p0
        which = torch.bucketize(dw.abs() / _step_lr(cfg, k), edges, right=True) - 1
        stats = torch.stack([torch.ones_like(err), (err <= MESH_PARAM_BAR[0]).float(),
                             (torch.sign(dw) == torch.sign(dg)).float()], 1).double()
        buckets.index_add_(0, which, stats)
        worst = max(worst, float(err.max()))
        tensors.append((k, err.numel(), int((err > MESH_PARAM_BAR[0]).sum())))
    b = buckets.cpu().tolist()
    return {"share": sum(r[1] for r in b) / sum(r[0] for r in b),
            "saturated": b[-1][1] / max(b[-1][0], 1), "worst": worst,
            "buckets": [tuple(int(v) for v in r) for r in b],
            "tensors": sorted(tensors, key=lambda t: -t[2])[:6]}


def _mesh_pipeline(dev, mesh=None):
    from contextual_image_compression_tpu_torch.config import ModelConfig
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    return CompressionPipeline(model_config=ModelConfig(skip_mode="zero"), device=dev, seed=0,
                               mesh=mesh)


def _metric_gap(got, want, first=0):
    """The largest |got - want| - bar over the metrics of steps first, ...
    (MESH_BARS; <= 0 passes), and the largest relative difference."""
    gap = max(abs(g[k] - w[k]) - (a + r * abs(w[k]))
              for g, w, (a, r) in zip(got, want, MESH_BARS[first:]) for k in w)
    rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) for g, w in zip(got, want) for k in w)
    return gap, rel


def run_mesh_nccl(dev, card):
    """Phase (h1): NCCL at world size 1. A (1, 1) mesh trainer and one without
    take one step with D from the same seeded full-width state on the same
    batch (losses within 1e-5 relative: cuDNN's backward may use atomics);
    a (1, 1) mesh pipeline gives the bytes of the pipeline without one
    (cuDNN deterministic). Returns the launch counts of the mesh's half."""
    import torch.distributed as dist
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import TrainConfig
    from contextual_image_compression_tpu_torch.parallel import create_mesh, initialize_multihost
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        assert initialize_multihost(f"file://{tmp}/rdzv", 1, 0, local_rank=0,
                                    backend="nccl") == (0, 1)
        mesh = create_mesh(1, device=dev)
        cfg = TrainConfig(vgg_weights_path="random:0", model_dir=tmp)
        batch, u8 = _mesh_data(cfg, dev)
        plain = GANTrainer(cfg, device=dev, log_fn=lambda msg: None)
        plain.init_state(resume=False)
        m_plain = _mesh_steps(plain, batch, (True,))
        del plain
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
            ref, ref_info = _mesh_pipeline(dev)(u8)
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        meshed = GANTrainer(cfg, mesh=mesh, log_fn=lambda msg: None)
        meshed.init_state(resume=False)
        m_mesh = _mesh_steps(meshed, batch, (True,))
        del meshed
        torch.cuda.empty_cache()
        rel = _metric_gap(m_mesh, m_plain)[1]
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
            got, got_info = _mesh_pipeline(dev, mesh)(u8)
        counts = launch_counts()
        dist.destroy_process_group()
    same = np.array_equal(ref, got) and all(torch.equal(ref_info[k], got_info[k])
                                            for k in ref_info)
    log(f"mesh (h1) NCCL world size 1 on {card}: (1, 1) mesh step vs no mesh, losses within "
        f"{rel:.2e} relative (bar 1e-5); (1, 1) mesh pipeline bytes equal to no mesh: {same}; "
        f"launches {counts}; {time.perf_counter() - t_phase:.1f} s")
    if not rel <= 1e-5 or not same:
        raise AssertionError(f"the (1, 1) NCCL mesh differs from one device: {rel}, {same}")
    if not all(counts[k] for k in ("K1", "K2", "K3", "K3b")):
        raise AssertionError(f"phase (h1) launches {counts}")
    return counts


def _mesh_rank_main(rank, world, directory):
    """One rank of phase (h2), on cuda:0 beside the other, over gloo: the
    lifecycle of __graft_entry__.py's dryrun_multichip at full width."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import TrainConfig
    from contextual_image_compression_tpu_torch.parallel import (
        create_mesh, initialize_multihost, sharding)
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer

    directory = pathlib.Path(directory)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_multihost(f"file://{directory}/rdzv", world, rank, local_rank=0, backend="gloo")
    ops.reset_launch_counts()
    cfg = TrainConfig(vgg_weights_path="random:0", model_dir=str(directory / "ckpt"))
    batch, u8 = _mesh_data(cfg, dev)
    times, legs, split, params = {}, {}, {}, {}
    step0_ref = torch.load(directory / "step0_ref.pt", mmap=True)
    init_ref = torch.load(directory / "init_ref.pt", mmap=True)

    def leg(label, model_parallel, resume, first, n, save=False):
        t0 = time.perf_counter()
        mesh = create_mesh(model_parallel, device=dev)
        trainer = GANTrainer(cfg, mesh=mesh, log_fn=lambda msg: None)
        trainer.init_state(resume=resume)
        if trainer.state.step != first:
            raise AssertionError(f"{label}: step {trainer.state.step}, want {first}")
        split[label] = sorted(sharding.sharded_shapes(trainer.state.codec)) + [
            f"disc.{k}" for k in sharding.sharded_shapes(trainer.state.disc)]
        legs[label] = (first, _mesh_steps(trainer, batch, MESH_SCHEDULE[first:first + 1]))
        if first == 0:  # the parameters after step 0 against the one-device run's
            t_cmp = time.perf_counter()
            params[label] = _param_agreement(_full_state(trainer.state), step0_ref, init_ref,
                                             cfg, dev)
            t0 += time.perf_counter() - t_cmp
            times[f"{label}: step-0 gather and comparison"] = time.perf_counter() - t_cmp
        legs[label][1].extend(_mesh_steps(trainer, batch, MESH_SCHEDULE[first + 1:first + n]))
        times[f"{label}: build{', restore' if resume else ''} and {n} steps"] = \
            time.perf_counter() - t0
        if save:
            t0 = time.perf_counter()
            trainer.save("final", blocking=True)
            times["rank-0 save"] = time.perf_counter() - t0
        del trainer
        torch.cuda.empty_cache()
        return mesh

    leg("(1, 2)", 2, False, 0, 4)                   # the model axis splits the big leaves
    mesh = leg("(2, 1)", 1, False, 0, 4, save=True)  # data parallel, B = 8 a rank
    leg("(1, 2) restored", 2, True, 4, 2)            # a fresh mesh of another shape
    train_counts = launch_counts()
    streams = [bytes(s) for s in np.load(directory / "streams_ref.npy", allow_pickle=True)]
    t0 = time.perf_counter()
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
        pipe = _mesh_pipeline(dev, mesh)
        dec3, info3 = pipe(u8, target_bpp=1.0)
        own_streams = pipe.encode_to_bitstream(u8, target_bpp=1.0)
        from_streams = pipe.decode_from_bitstream(streams)
    torch.cuda.synchronize()
    times["serving (ragged call, encode, decode)"] = time.perf_counter() - t0
    torch.save({"legs": legs, "params": params, "split": split, "train_counts": train_counts,
                "counts": launch_counts(), "peak": torch.cuda.max_memory_allocated(),
                "times": times, "dec3": dec3, "symbols": info3["hq_symbols"].cpu().numpy(),
                "own_streams": own_streams, "from_streams": from_streams},
               directory / f"rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _identical_share(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float((a == b).mean()), int(np.abs(a.astype(np.int64) - b.astype(np.int64)).max())


def run_mesh_shared_card(dev, card):
    """Phase (h2): two ranks on cuda:0 over gloo (NCCL refuses two ranks on
    one card). The one-device reference runs first, twice (the run against
    itself), and is freed: six steps of the D-every-other schedule at global
    B = 16, and the ragged serving call with its storable round trip. Then
    the two ranks: four steps on a (1, 2) mesh (the model axis splits the
    projections, conv4, deconv1 / 2 and D's dense), four on a (2, 1) mesh
    and a rank-0 save, a restore on a fresh (1, 2) mesh and steps 5 and 6,
    each step's metrics within MESH_BARS of the reference's and the ranks'
    within MESH_RANK_BAR, the gathered state after step 0 within
    MESH_PARAM_BAR of the reference's; then mesh serving of the 3-image
    request (padded to 4, two a rank) and the storable round trip, the
    same bytes, symbols and streams as one device. Returns the ranks'
    summed launch counts."""
    import subprocess

    from contextual_image_compression_tpu_torch.config import TrainConfig
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainConfig(vgg_weights_path="random:0", model_dir=tmp)
        batch, u8 = _mesh_data(cfg, dev)
        torch.cuda.reset_peak_memory_stats()
        m_refs, step0 = [], []
        for _ in range(2):  # twice: the one-device run against itself
            ref = GANTrainer(cfg, device=dev, log_fn=lambda msg: None)
            ref.init_state(resume=False)
            if not step0:
                init = _full_state(ref.state)
            m_refs.append(_mesh_steps(ref, batch, MESH_SCHEDULE[:1]))
            step0.append(_full_state(ref.state))
            m_refs[-1].extend(_mesh_steps(ref, batch, MESH_SCHEDULE[1:]))
            del ref
            torch.cuda.empty_cache()
        m_ref = m_refs[0]
        params_self = _param_agreement(step0[1], step0[0], init, cfg, dev)
        torch.save(step0[0], os.path.join(tmp, "step0_ref.pt"))
        torch.save(init, os.path.join(tmp, "init_ref.pt"))
        del step0, init
        ref_peak = torch.cuda.max_memory_allocated()
        with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
            pipe = _mesh_pipeline(dev)
            dec3, info3 = pipe(u8, target_bpp=1.0)
            streams = pipe.encode_to_bitstream(u8, target_bpp=1.0)
            from_streams = pipe.decode_from_bitstream(streams)
        del pipe, batch
        np.save(os.path.join(tmp, "streams_ref.npy"), np.array(streams, dtype=object),
                allow_pickle=True)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        t_ranks = time.perf_counter()
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-rank",
                                   str(r), "2", tmp], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(2)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        t_ranks = time.perf_counter() - t_ranks
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"phase (h2) rank {r} failed ({p.returncode}):\n{out[-6000:]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        files = sorted(f for f in os.listdir(os.path.join(tmp, "ckpt")))
    legs = ranks[0]["legs"]
    gap = max(_metric_gap(m, m_ref[first:], first)[0] for first, m in legs.values())
    rank_gaps = {label: max(abs(a[k] - b[k]) for a, b in zip(got, ranks[1]["legs"][label][1])
                            for k in a) for label, (_, got) in legs.items()}
    dec_share, dec_max = _identical_share(ranks[0]["dec3"], dec3)
    sym_share, sym_max = _identical_share(ranks[0]["symbols"], info3["hq_symbols"].cpu().numpy())
    streams_equal = sum(a == b for a, b in zip(ranks[0]["own_streams"], streams))
    rt_share, rt_max = _identical_share(ranks[0]["from_streams"], from_streams)
    counts = {k: sum(r["counts"][k] for r in ranks) for k in ranks[0]["counts"]}
    split = ranks[0]["split"]
    params = ranks[0]["params"]
    params_ok = all(r["params"] == params for r in ranks) and all(
        p["saturated"] >= MESH_PARAM_BAR[1] and p["worst"] <= 2 * cfg.learning_rate
        for p in params.values())
    log(f"mesh (h2) two ranks on one card over gloo, full width, global B = {MESH_BATCH}, "
        f"on {card}: leaves split on (1, 2): {len(split['(1, 2)'])} "
        f"({', '.join(split['(1, 2)'])}), on (2, 1): {len(split['(2, 1)'])}; files of the "
        f"rank-0 save: {len(files)}, {', '.join(files)}")
    for label, (first, got) in legs.items():
        for i, g in enumerate(got, first):
            want, again = m_ref[i], m_refs[1][i]
            worst = max(want, key=lambda k: abs(g[k] - want[k]))
            log(f"  {label} step {i} ({'D' if MESH_SCHEDULE[i] else 'no D'}): largest |mesh - "
                f"one device| {abs(g[worst] - want[worst]):.2e} ({worst} {g[worst]:.7g}), bar "
                f"{MESH_BARS[i][0]:.0e} + {MESH_BARS[i][1]:.0e} |ref|; one device against "
                f"itself {max(abs(again[k] - want[k]) for k in want):.2e}")
    for label, p in [*params.items(), ("one device against itself", params_self)]:
        log(f"  state after step 0, {label}: where one device's update is saturated "
            f"{p['saturated']:.8f} within {MESH_PARAM_BAR[0]:.0e} (bar >= {MESH_PARAM_BAR[1]}), "
            f"all {p['share']:.6f}; largest {p['worst']:.3e} (bar 2 lr = "
            f"{2 * cfg.learning_rate:.0e}); by |one device's update| / lr, edges "
            f"{MESH_UPDATE_EDGES} (elements, within, same sign): {p['buckets']}; most outside: "
            f"{p['tensors']}")
    log(f"  largest excess over the bars {gap:.3e} (<= 0 passes); largest |rank 1 - rank 0| "
        f"of a metric: " + ", ".join(f"{k} {v:.2e}" for k, v in rank_gaps.items())
        + f" (bar {MESH_RANK_BAR:.0e})")
    log(f"  serving, 3 images padded to 4 (two a rank) against one device (cuDNN deterministic "
        f"in both): decoded bytes identical {dec_share:.6f} (max |diff| {dec_max}), HQ symbols "
        f"identical {sym_share:.6f} (max {sym_max}); streams byte-identical {streams_equal} / 3; "
        f"the reference's streams decoded on the mesh: identical {rt_share:.6f} (max {rt_max})")
    for r, rk in enumerate(ranks):
        log(f"  rank {r}: peak memory {rk['peak'] / 2**30:.2f} GiB; "
            + ", ".join(f"{k} {v:.2f} s" for k, v in rk["times"].items())
            + f"; launches training {rk['train_counts']}, whole {rk['counts']}")
    log(f"  one-device reference peak {ref_peak / 2**30:.2f} GiB; phase wall time "
        f"{time.perf_counter() - t_phase:.1f} s (ranks {t_ranks:.1f} s, two processes sharing "
        f"the card through gloo: a cost, not a scaling figure)")
    if gap > 0 or max(rank_gaps.values()) > MESH_RANK_BAR or not params_ok:
        raise AssertionError(f"phase (h2): the mesh steps differ from one device ({gap}, "
                             f"parameters {params}) or between the ranks ({rank_gaps})")
    if not split["(1, 2)"] or split["(2, 1)"] or "optimizers_final.msgpack" not in files:
        raise AssertionError(f"phase (h2): leaves split {split}, files {files}")
    if dec_max or sym_max or rt_max or streams_equal != len(streams):
        raise AssertionError("phase (h2): mesh serving differs from one device")
    if not all(counts[k] for k in ("K1", "K2", "K3", "K3b")):
        raise AssertionError(f"phase (h2) launches {counts}")
    return counts


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
    codec_dir = tempfile.TemporaryDirectory()  # phase (b)'s model_dir, for phase (f)
    from_checkpoint = run_checkpoint_serving(dev, card, codec_dir.name)
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
    records.append(check_k8_int8(dev, codec))
    entry_points = run_entry_points(dev, B, codec)
    del codec
    check_small_codec_against_cpu(dev)
    codec_path = run_codec_path(dev, card)
    run_autoencoder(dev, card)
    records.append(check_k1_bf16(dev, rng, B))
    evaluation, rd_csv = run_evaluation(dev, card)
    run_autoencoder_evaluation(dev, card)
    training_flow = run_training_flow(dev, card)
    with codec_dir:
        clis = run_cli_paths(dev, card, codec_dir.name)
    with tempfile.TemporaryDirectory() as model_dir:
        bf16_params = run_bf16_param_training(dev, card, model_dir)
    dense_w8 = run_dense_w8_training(dev, card)
    no_pallas = run_use_pallas_false(dev, card)
    tools = run_tool_clis(dev, card, rd_csv)
    records.append(check_k9(dev))
    hific_serving = run_hific_serving(dev, card)
    mesh = run_mesh_nccl(dev, card)
    mesh_ranks = run_mesh_shared_card(dev, card)
    mesh = {k: mesh[k] + mesh_ranks[k] for k in mesh}
    paths = {"serving": serving, "jax_trained_serving": jax_trained,
             "checkpoint_serving": from_checkpoint, "w8a8_serving": w8a8_serving,
             "training": training, "mixed_training": mixed_training, "masks": mask_path,
             "fft_core_masks": fft_masks, "dct": dct_path, "entry_points": entry_points,
             "storable_codec": codec_path, "evaluation": evaluation,
             "training_flow": training_flow, **clis, "bf16_param_training": bf16_params,
             "dense_w8_training": dense_w8, **no_pallas, **tools, "hific_serving": hific_serving,
             "mesh": mesh}
    serving_paths = ("serving", "jax_trained_serving", "checkpoint_serving", "w8a8_serving",
                     "training", "mixed_training", "storable_codec", "training_flow",
                     "eval_bitstream_cli", "shootout_cli")
    options = ("bf16_param_training", "dense_w8_training", "profile_codec_cli")
    runs_it = {"K1": serving_paths + ("fft_core_masks", "profile_codec_cli", "mesh"),
               "K2": serving_paths + ("evaluation", "mesh") + options,
               "K3": serving_paths + ("evaluation", "mesh") + options,
               "K3b": ("training", "mixed_training", "training_flow", "mesh") + options[:2],
               "K4": ("masks", "fft_core_masks"), "K5": ("dct", "compress_cli", "shootout_cli"),
               "K6": ("entry_points",), "K7a": ("entry_points",), "K7b": ("entry_points",),
               "K8": ("entry_points",), "K1bf16": ("evaluation",),
               "K8int8": ("serving", "jax_trained_serving", "checkpoint_serving", "w8a8_serving",
                          "storable_codec", "eval_bitstream_cli", "no_pallas_serving", "mesh"),
               "K9": ("hific_serving",)}
    keys_in_order = ("K1", "K2", "K3", "K3b", "K4", "K5", "K6", "K7a", "K7b", "K8", "K8int8",
                     "K1bf16", "K9")
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
    if sys.argv[1:2] == ["--mesh-rank"]:  # a rank of phase (h2), started by the script itself
        _mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
        sys.exit(0)
    sys.exit(main())
