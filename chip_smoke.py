"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

1. prints the card's name and power limit (nvidia-smi);
2. builds the port's CUDA kernels from contextual_image_compression_tpu_torch/csrc
   and its range coder (g++) from contextual_image_compression_tpu_torch/native;
3. holds each kernel (K1 contextual mask, K2 attention block, K3 quantizer)
   against its plain PyTorch twin on the card at the serving path's shapes
   (B = 16, 256^2, D = 512) and times kernel, twin and, where one exists, a
   library call with CUDA events;
4. checks the serving pipeline at a small size on the card against the same
   pipeline on the CPU (where each wrapper runs its twin);
5. runs CompressionPipeline(ModelConfig(), device="cuda") at full width with
   seeded random weights (attention gamma 0.5, random BN statistics) on
   B = 16 structured 256^2 images three times, checking shapes, finite
   symbols and that the kernels' launch counters moved by K1 +1, K2 +1 and
   K3 +2 per call;
6. holds K3b (the quantizer's backward) against its twin at the training
   path's shapes (B = 16, D = 1024 and 512, float32 and bf16) and times it;
7. checks two GAN training steps (with and without D) of a tiny codec on the
   card against the same steps on the CPU: losses, per-component gradients,
   parameters and BatchNorm statistics;
8. trains at full width (TrainConfig() defaults, random VGG19 for the
   perceptual loss): masks of 32 synthetic images through K1, a
   device-resident dataset, GANTrainer.fit for 4 steps after one warm-up
   step, and the rate-control probe, checking finite metrics, moved
   parameters and BatchNorm statistics, and the launch counts (K1 +1; per
   step K2 +1, K3 +2, K3b +2; per probe point K2 +1, K3 +2), then times
   steps with and without D;
9. holds K4 (the smooth mask) against its twin at B = 64, 256^2, on the
   saliency maps of both non-'combined' methods, and times it;
10. runs the mask path at full width: prepare_masks over 128 seeded rich
   synthetic images at 256^2 in device batches of 64 for
   method='spectral_residual' and 'fine_grained' (K4 +1 per batch, K1 0),
   plus one batch of binary masks, checking the masks against the port on
   the CPU on the first images, and times one batch's stages;
11. holds K5 (the DCT transform and quantizer) against its twin at B = 128,
   256^2, quality 75, and times it beside a cuBLAS formulation;
12. runs the DCT baseline at full width on 128 seeded images: evaluate at
   qualities 10..90 with PSNR / SSIM, entropy bpp and the measured bpp of 4
   range-coded streams (the coder is built with g++ first), streams encoded
   on the card and decoded on the CPU and the reverse, and the round trip's
   images per second and stages (K5 +1 per codec call);
13. prints a `kernels` JSON line and, last, {"ok": true, "device": {...}}.

Any failed check raises, so the exit code is non-zero and no result line is
printed. Without CUDA, or without the port package beside it, it exits 1.
"""

import copy
import json
import math
import sys
import time

import numpy as np
import torch

H100_BF16_TFLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_FP32_TFLOPS = 67e12   # CUDA-core float32 peak
H100_HBM_BYTES_S = 3.35e12


def log(msg):
    print(msg, flush=True)


def bound_ms(nbytes, ops, peak_ops):
    t_bytes = nbytes / H100_HBM_BYTES_S
    t_ops = ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_k1(dev, rng, B):
    from contextual_image_compression_tpu_torch.measure import event_ms, structured_images
    from contextual_image_compression_tpu_torch.ops import image_ops, saliency
    from contextual_image_compression_tpu_torch.ops.fused_mask import (
        contextual_mask, contextual_mask_plain)

    u8 = torch.from_numpy(structured_images(rng, B, 256)).to(dev)
    gray = image_ops.rgb_to_gray(u8.float()).contiguous()
    spec = saliency.spectral_residual_small(gray, 64, 3.0).contiguous()
    got = contextual_mask(gray, spec)
    want = contextual_mask_plain(gray, spec)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    log(f"K1 contextual mask {tuple(gray.shape)}: max |kernel - twin| = {err:.3e} (bar 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"K1 disagrees with its twin: {err}")
    ms = event_ms(lambda: contextual_mask(gray, spec))
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
    log(f"K1 times: kernel {ms:.4f} ms, twin {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library none")
    return dict(name="K1 contextual_mask", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/fused_mask.cu",
                replaces="contextual_image_compression_tpu/ops/fused_mask.py:252",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def check_k2(dev, B):
    import torch.nn.functional as F
    from contextual_image_compression_tpu_torch.measure import event_ms
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
    got = attention_block(q, k, v, res, g).float()
    want = attention_block_plain(q, k, v, res, g).float()
    # With the residual at 0 the output is the attention term gamma * ctx
    # alone, so the bf16 bar is relative to that term, not to the ulp of the
    # residual, which at |res| ~ 4 is larger than the term itself.
    att = attention_block(q, k, v, zero, g).float()
    att_want = attention_block_plain(q, k, v, zero, g).float()
    f32 = attention_block(q.float(), k.float(), v.float(), res.float(), g).float()
    f32_want = attention_block_plain(q.float(), k.float(), v.float(), res.float(), g).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel = err / want.abs().max().item()
    att_rel = (att - att_want).abs().max().item() / att_want.abs().max().item()
    err32 = (f32 - f32_want).abs().max().item()
    log(f"K2 attention block bf16 q,k {tuple(q.shape)} v {tuple(v.shape)}: max |kernel - twin| = "
        f"{err:.3e} ({rel:.2e} of max |out|, bar 2e-2); residual 0: {att_rel:.2e} of max "
        f"|gamma ctx| = {att_want.abs().max().item():.3e} (bar 2e-2); float32 {err32:.3e} (bar 1e-5)")
    if not (rel <= 2e-2 and att_rel <= 2e-2 and err32 <= 1e-5):
        raise AssertionError(f"K2 disagrees with its twin: bf16 {rel}, residual 0 {att_rel}, "
                             f"f32 {err32}")
    ms = event_ms(lambda: attention_block(q, k, v, res, g))
    plain = event_ms(lambda: attention_block_plain(q, k, v, res, g), reps=5, warmup=1)
    # yardsticks the port never calls, both without the gamma-residual epilogue:
    # softmax(q k^T) v in three cuBLAS-backed calls, and one SDPA call
    lib = event_ms(lambda: torch.softmax(q @ k.transpose(1, 2), dim=-1) @ v)
    sdpa = event_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0))
    flops = 2.0 * B * N * N * (DK + DV)
    nbytes = (q.numel() + k.numel() + v.numel() + res.numel() + got.numel()) * 2
    b_ms, b_by = bound_ms(nbytes, flops, H100_BF16_TFLOPS)
    log(f"K2 times: kernel {ms:.4f} ms, twin {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"library softmax(q k^T) v in three calls {lib:.4f} ms, "
        f"scaled_dot_product_attention(scale=1) {sdpa:.4f} ms")
    return dict(name="K2 attention_block", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/attention.cu",
                replaces="contextual_image_compression_tpu/ops/attention.py:174",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, sdpa_ms=sdpa)


def check_k3(dev, B):
    from contextual_image_compression_tpu_torch.config import QuantizerConfig
    from contextual_image_compression_tpu_torch.measure import event_ms
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
    for z, s, qs in cases:
        for dt in (torch.bfloat16, torch.float32):
            args = (z.to(dt), s.to(dt), qs.to(dt))
            got = adaptive_quantize(*args, cfg).float()
            want = adaptive_quantize_plain(*args).float()
            err = max(err, (got - want).abs().max().item())
            same = min(same, (got == want).float().mean().item())
    torch.cuda.synchronize()
    log(f"K3 quantizer (16,1024)+(16,512), bf16 and float32: max |kernel - twin| = {err:.3e}, "
        f"bitwise equal share {same:.5f} (bar >= 0.999)")
    if not same >= 0.999:
        raise AssertionError(f"K3 disagrees with its twin: {same}")

    def pair(fn):
        return lambda: [fn(z, s, qs) for z, s, qs in cases]

    ms = event_ms(pair(lambda z, s, qs: adaptive_quantize(z, s, qs, cfg)))
    plain = event_ms(pair(adaptive_quantize_plain))
    nbytes = sum(z.numel() * 2 * 2 + B * 4 * 2 for z, _, _ in cases)
    ops = sum(z.numel() * 3 for z, _, _ in cases)
    b_ms, b_by = bound_ms(nbytes, ops, H100_FP32_TFLOPS)
    log(f"K3 times (two launches of one call): kernel {ms:.4f} ms, twin {plain:.4f} ms, "
        f"bound {b_ms:.6f} ms ({b_by}), library none")
    return dict(name="K3 adaptive_quantize", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/quantize.cu",
                replaces="contextual_image_compression_tpu/ops/quantize.py:152",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def check_small_pipeline_against_cpu(dev):
    """The same weights and images through the pipeline on the card (kernels)
    and on the CPU (twins): mask <= 1e-4, decoded PSNR >= 40 dB, symbols
    within +-1 and >= 95% identical."""
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
        dec, info = pipe(u8, target_bpp=1.0)
        outs[name] = (dec, {k: v.float().cpu().numpy() for k, v in info.items()})
    (dg, ig), (dc, ic) = outs["cuda"], outs["cpu"]
    mask_err = float(np.abs(ig["mask"] - ic["mask"]).max())
    mse = float(np.mean((dg.astype(np.float64) - dc.astype(np.float64)) ** 2))
    psnr = 10 * math.log10(255.0 ** 2 / max(mse, 1e-12))
    sym_same = min(float(np.mean(ig[k] == ic[k])) for k in ("hq_symbols", "lq_symbols"))
    sym_max = max(float(np.abs(ig[k] - ic[k]).max()) for k in ("hq_symbols", "lq_symbols"))
    log(f"small pipeline card vs CPU: mask {mask_err:.3e} (bar 1e-4), decoded PSNR {psnr:.2f} dB "
        f"(bar 40), symbols identical {sym_same:.4f} (bar 0.95), max |diff| {sym_max} (bar 1)")
    if not (mask_err <= 1e-4 and psnr >= 40.0 and sym_same >= 0.95 and sym_max <= 1.0):
        raise AssertionError("the pipeline on the card disagrees with the CPU pipeline")


def run_full_pipeline(dev, card):
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import ModelConfig
    from contextual_image_compression_tpu_torch.measure import randomize_stats, structured_images
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    t0 = time.time()
    pipe = CompressionPipeline(model_config=ModelConfig(), device=dev, seed=0)
    randomize_stats(pipe.codec, 0)
    n_params = sum(t.numel() for t in pipe.codec.state_dict().values())
    log(f"full-width pipeline built in {time.time() - t0:.1f} s: {n_params / 1e6:.1f}M parameters "
        f"(int8 latent/fc rows counted), bf16, w8, folded int8 tail")
    B = 16
    u8 = structured_images(np.random.RandomState(1), B, 256)
    pipe(u8, target_bpp=1.0)  # first call: cuDNN autotuning, allocator warm-up
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    times = []
    for i in range(3):
        before = ops.launch_counts()
        t = time.perf_counter()
        dec, info = pipe(u8, target_bpp=1.0)  # ends in a device->host copy
        times.append(time.perf_counter() - t)
        after = ops.launch_counts()
        delta = {k: after[k] - before[k] for k in after}
        if delta != {"K1": 1, "K2": 1, "K3": 2, "K3b": 0, "K4": 0, "K5": 0}:
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
    counts = ops.launch_counts()
    med = float(np.median(times))
    log(f"full-width pipeline B={B}, 256x256: 3 calls, median {med * 1e3:.2f} ms/call, "
        f"{B / med:.1f} img/s on {card}; launches {counts}")
    log(f"decoded mean {dec.mean():.2f}, std {dec.std():.2f}; |hq symbols| mean "
        f"{info['hq_symbols'].abs().mean().item():.3f}; mask mean {info['mask'].mean().item():.4f}")
    return counts, med


def check_k3b(dev, B):
    from contextual_image_compression_tpu_torch.measure import event_ms
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

    ms = event_ms(pair(adaptive_quantize_bwd))
    plain = event_ms(pair(adaptive_quantize_bwd_plain))
    # float32 training path: z and g read once, sigma and q read, dsigma and
    # dq written; ~6 operations per element (z s, rint, divide, negate,
    # multiply by g, add)
    nbytes = sum(z.numel() * 4 * 2 + B * 4 * 4 for z, _, _, _ in cases)
    ops = sum(z.numel() * 6 for z, _, _, _ in cases)
    b_ms, b_by = bound_ms(nbytes, ops, H100_FP32_TFLOPS)
    log(f"K3b times (two launches of one step, float32): kernel {ms:.4f} ms, twin {plain:.4f} ms, "
        f"bound {b_ms:.6f} ms ({b_by}), library none")
    return dict(name="K3b adaptive_quantize_bwd", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/quantize.cu",
                replaces="contextual_image_compression_tpu/ops/quantize.py:127",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


# The tiny codec of the CPU training tests, with 64 channels at the attention
# stage (K2 takes value widths of 64..256 in steps of 64).
TINY_TRAIN = dict(img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 64, 32),
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
    1e-6. Returns (loss, gradient, share, worst, statistics) errors."""
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
        (mc, gc, pc), (mg, gg, pg) = step(sides[0], do_d), step(sides[1], do_d)
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
    _small_train_step_agreement, with convolutions outside cuDNN. cuDNN's
    float32 convolution algorithms (TF32 off, deterministic or not) move the
    step's codec gradients by up to ~3e-4 relative L2 from the CPU's through
    the VGG19 and train-mode BatchNorm backward, and by different amounts
    from run to run; that run is printed for information. Without cuDNN the
    card's convolutions are float32 GEMMs and the step is held to 1e-4; K2,
    K3 and K3b launch in both runs."""
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


def run_full_training(dev, card):
    """The training main path at full width; returns its launch counts."""
    from contextual_image_compression_tpu_torch import ops
    from contextual_image_compression_tpu_torch.config import TrainConfig
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.data.pipeline import (
        CompressionDataset, prepare_masks)
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer

    cfg = TrainConfig(vgg_weights_path="random:0")
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
    hist = trainer.fit(ds, epochs=1, steps_per_epoch=4, artifacts=False)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    probe = trainer.rate_control_probe(ds.first_samples())
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"K1": 1, "K2": 5 + 3, "K3": 2 * 5 + 2 * 3, "K3b": 2 * 5, "K4": 0, "K5": 0}
    if counts != want:
        raise AssertionError(f"training launches {counts}, want {want}")
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

    # step times outside the counted main path, alternating D / no D
    t_d, t_nd = [], []
    it = ds.epoch()
    for i in range(6):
        batch = next(it, None)
        if batch is None:
            it = ds.epoch()
            batch = next(it)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.builder.train_step(state, batch, i % 2 == 0)
        torch.cuda.synchronize()
        (t_d if i % 2 == 0 else t_nd).append(time.perf_counter() - t0)
    md, mnd = float(np.median(t_d)), float(np.median(t_nd))
    bsz = cfg.batch_size
    log(f"full-width GAN training on {card} (TrainConfig() defaults, float32, TF32 off, "
        f"random VGG19 perceptual): {n_params / 1e6:.1f}M trainable parameters; masks of "
        f"{len(imgs)} images {t_mask * 1e3:.1f} ms; warm-up step {t_warm:.2f} s; fit 4 steps {t_fit:.3f} s")
    log(f"step with D {md * 1e3:.2f} ms, without D {mnd * 1e3:.2f} ms (median of 3 each, "
        f"CUDA-synchronized host clock); {2 * bsz / (md + mnd):.1f} img/s on the alternating "
        f"schedule; peak memory {peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated); "
        f"launches {counts}")
    log(f"history {json.dumps(hist)}; probe {probe}")
    return counts


MASK_METHODS = ("spectral_residual", "fine_grained")


def check_k4(dev, B):
    from contextual_image_compression_tpu_torch.data.images import rich_synthetic_images
    from contextual_image_compression_tpu_torch.measure import event_ms
    from contextual_image_compression_tpu_torch.ops import image_ops, saliency
    from contextual_image_compression_tpu_torch.ops.fused_mask import (
        smooth_mask, smooth_mask_plain)

    imgs = torch.from_numpy(rich_synthetic_images(B, (256, 256), seed=40)).to(dev)
    err, maps = 0.0, {}
    for method in MASK_METHODS:
        sal = saliency.compute_saliency_map(imgs, method).contiguous()
        got = smooth_mask(sal)
        want = smooth_mask_plain(sal)
        torch.cuda.synchronize()
        err = max(err, (got - want).abs().max().item())
        maps[method] = sal
    log(f"K4 smooth mask {tuple(sal.shape)}, maps of {' and '.join(MASK_METHODS)}: "
        f"max |kernel - twin| = {err:.3e} (bar 1e-5)")
    if not err <= 1e-5:
        raise AssertionError(f"K4 disagrees with its twin: {err}")
    sal = maps["fine_grained"]
    ms = event_ms(lambda: smooth_mask(sal))
    plain = event_ms(lambda: smooth_mask_plain(sal), reps=5, warmup=1)
    # Operations the function needs per pixel: 7 per bilateral tap (the
    # difference, its square, the weight, two accumulations) and the final
    # division; a multiply-add per Gaussian tap in each of the two passes;
    # the normalization and its max.
    ntaps = len(image_ops.bilateral_taps(9, 75.0, 75.0))
    ops_per_px = 7 * ntaps + 1 + 2 * 2 * 31 + 2
    nbytes = sal.numel() * 4 * 2
    b_ms, b_by = bound_ms(nbytes, ops_per_px * sal.numel(), H100_FP32_TFLOPS)
    log(f"K4 times: kernel {ms:.4f} ms, twin {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        "library none")
    return dict(name="K4 smooth_mask", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/fused_mask.cu",
                replaces="contextual_image_compression_tpu/ops/fused_mask.py:324",
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


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
    counts = ops.launch_counts()
    want = {"K1": 0, "K2": 0, "K3": 0, "K3b": 0, "K4": 2 * (n // batch), "K5": 0}
    if counts != want:
        raise AssertionError(f"mask path launches {counts}, want {want}")
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
    from contextual_image_compression_tpu_torch.measure import event_ms
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
    plain = event_ms(lambda: dct_strips_plain(planes, tables), reps=5, warmup=1)
    lib = event_ms(cublas)
    # four 8-term products per coefficient (2 x 8 x 4 operations), the divide,
    # the rounding and the dequantize
    ops_per_px = 2 * 8 * 4 + 3
    nbytes = planes.numel() * 4 * 3
    b_ms, b_by = bound_ms(nbytes, ops_per_px * planes.numel(), H100_FP32_TFLOPS)
    log(f"K5 times: kernel {ms:.4f} ms, twin {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"library none; cuBLAS yardstick (batched 8x8 products + round) {lib:.4f} ms")
    return dict(name="K5 dct_strips", route="cuda",
                source="contextual_image_compression_tpu_torch/csrc/dct.cu",
                replaces="contextual_image_compression_tpu/ops/dct.py:152",
                max_abs_err=rec_err, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, cublas_yardstick_ms=lib, symbols_identical=same)


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
    counts = ops.launch_counts()
    want = {"K1": 0, "K2": 0, "K3": 0, "K3b": 0, "K4": 0, "K5": 6 + 2 + 5}
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
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            log("  ptxas: " + line.strip())
    from contextual_image_compression_tpu_torch import native

    t0 = time.time()
    coder_path = native.build()
    log(f"range coder built in {time.time() - t0:.1f} s: {coder_path}")

    rng = np.random.RandomState(0)
    B = 16
    records = [check_k1(dev, rng, B), check_k2(dev, B), check_k3(dev, B)]
    check_small_pipeline_against_cpu(dev)
    serving, med = run_full_pipeline(dev, card)
    records.append(check_k3b(dev, B))
    check_small_train_step_against_cpu(dev)
    training = run_full_training(dev, card)
    records.append(check_k4(dev, 64))
    mask_path = run_mask_path(dev, card)
    records.append(check_k5(dev, 128))
    dct_path = run_dct_path(dev, card)
    paths = {"serving": serving, "training": training, "masks": mask_path, "dct": dct_path}
    runs_it = {"K1": ("serving", "training"), "K2": ("serving", "training"),
               "K3": ("serving", "training"), "K3b": ("training",), "K4": ("masks",),
               "K5": ("dct",)}
    for rec, key in zip(records, ("K1", "K2", "K3", "K3b", "K4", "K5")):
        for name, counts in paths.items():
            rec[f"launches_{name}"] = counts[key]
        rec["launches"] = sum(counts[key] for counts in paths.values())
        if any(paths[name][key] == 0 for name in runs_it[key]):
            raise AssertionError(f"{key} was not launched on a path that runs it")
        rec["status"] = "ported; within its bar against the twin; launched on the main paths"
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = {"kernels": [{**{k: rec[k] for k in keys}, **rec} for rec in records]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
