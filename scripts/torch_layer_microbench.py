#!/usr/bin/env python
"""Per-layer microbenchmark of the codec's conv, deconv and dense shapes with
the PyTorch port, with the flags and the JSON keys of
scripts/layer_microbench.py.

Every distinct layer shape of `ModelConfig()`'s codec is timed on its own in
bf16 at --batch images (cuDNN convolutions, cuBLAS products), and reported
as ms a call and TFLOP/s against the useful multiply-adds (a stride-2
deconvolution's structural zeros not counted): the encoder's convs
(`enc.conv*`), the generator's deconvs and out-conv (`gen.*`), the same
deconvs through the polyphase lowering (`poly.deconv*`,
layers.PolyphaseConvT4x4s2), the generator's tail native and through
`packed_tail_forward` with use_pallas left at its default, the cuDNN
lowering (`tail.native`, `tail.packed`), and the latent and fc projections
(`enc.dense_*`, `gen.dense_*`). On the card a time is the median of
`measure.event_ms`; on the CPU the host clock of `utils/profiling.benchmark`.
The per-row lines go to stderr, one JSON object to stdout.

Usage: python scripts/torch_layer_microbench.py [--batch 128] [--iters 20]

It runs on the card; main(device="cpu") runs it on the CPU.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from contextual_image_compression_tpu_torch import measure
    from contextual_image_compression_tpu_torch.config import ModelConfig, resolve_device
    from contextual_image_compression_tpu_torch.models.layers import (
        PolyphaseConvT4x4s2,
        same_pads,
    )
    from contextual_image_compression_tpu_torch.models.packed_tail import packed_tail_forward
    from contextual_image_compression_tpu_torch.utils import profiling

    dev = resolve_device(device)
    B = args.batch
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = ModelConfig()
    h = cfg.img_size[0]
    c1, c2, c3, c4 = cfg.encoder_channels
    g1, g2, g3, g4 = cfg.generator_channels
    bh, bc = cfg.generator_base_hw, cfg.generator_base_ch
    out = {"batch": B}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    def timed(name, fn, macs, per_img=False):
        with torch.no_grad():
            if dev.type == "cuda":
                ms = measure.event_ms(fn, reps=args.iters)
            else:
                ms = 1e3 * profiling.benchmark(fn, warmup=1, iters=args.iters)["sec_per_call"]
        tflops = 2 * macs * B / (ms / 1e3) / 1e12
        out[name] = {"ms": round(ms, 3)}
        if per_img:
            out[name]["gmacs_per_img"] = round(macs / 1e9, 3)
        out[name]["tflops"] = round(tflops, 1)
        print(f"{name:14s} {ms:7.2f} ms  {tflops:6.1f} TFLOP/s", file=sys.stderr, flush=True)

    def conv(x, w, stride):
        ph = same_pads(x.shape[-2], w.shape[-1], stride)
        pw = same_pads(x.shape[-1], w.shape[-1], stride)
        return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)

    # (name, H, Cin, Cout, k, stride, kind), the codec's shapes
    layers = [
        ("enc.conv1", h, cfg.channels, c1, 4, 2, "conv"),
        ("enc.conv2", h // 2, c1, c2, 4, 2, "conv"),
        ("enc.conv3", h // 4, c2, c3, 4, 2, "conv"),
        ("enc.conv4", h // 8, c3, c4, 4, 2, "conv"),
        ("gen.deconv1", bh, bc, g1, 4, 2, "deconv"),
        ("gen.deconv2", 2 * bh, g1 + c3, g2, 4, 2, "deconv"),
        ("gen.deconv3", 4 * bh, g2 + c2, g3, 4, 2, "deconv"),
        ("gen.deconv4", 8 * bh, g3 + c1, g4, 4, 2, "deconv"),
        ("gen.out_conv", h, g4, cfg.channels, 4, 1, "conv"),
    ]
    for name, hh, cin, cout, k, s, kind in layers:
        x = randn(B, cin, hh, hh)
        if kind == "conv":
            w = randn(cout, cin, k, k, scale=0.05)
            timed(name, lambda x=x, w=w, s=s: conv(x, w, s), (hh // s) ** 2 * cout * k * k * cin,
                  per_img=True)
        else:
            w = randn(cin, cout, k, k, scale=0.05)
            timed(name, lambda x=x, w=w: F.conv_transpose2d(x, w, stride=2, padding=1),
                  (hh * s) ** 2 * cout * (k * k // (s * s)) * cin, per_img=True)

    # the polyphase lowering of the deconvs (phase conv + interleave)
    for name, hh, cin, cout in (("poly.deconv1", bh, bc, g1), ("poly.deconv2", 2 * bh, g1 + c3, g2),
                                ("poly.deconv3", 4 * bh, g2 + c2, g3),
                                ("poly.deconv4", 8 * bh, g3 + c1, g4)):
        with torch.device(dev):
            mod = PolyphaseConvT4x4s2(cin, cout)
        mod.reset_parameters(gen)
        mod.to(dt)
        x = randn(B, cin, hh, hh)
        timed(name, lambda x=x, mod=mod: mod(x), (hh * 2) ** 2 * cout * 4 * cin)

    # the generator's tail: deconv4 -> BN (inference) -> LeakyReLU -> out_conv -> tanh
    cin, cmid, cout, th = g3 + c1, g4, cfg.channels, 8 * bh
    x = randn(B, cin, th, th)
    k4, b4 = randn(cin, cmid, 4, 4, scale=0.05), torch.zeros(cmid, dtype=dt, device=dev)
    ko, bo = randn(cout, cmid, 4, 4, scale=0.05), torch.zeros(cout, dtype=dt, device=dev)
    scale, bias = torch.ones(cmid, dtype=dt, device=dev), torch.zeros(cmid, dtype=dt, device=dev)
    mean = torch.zeros(cmid, device=dev)
    var = torch.ones(cmid, device=dev)

    def native_tail():
        z = F.conv_transpose2d(x, k4, stride=2, padding=1) + b4[:, None, None]
        z = z * scale[:, None, None] + bias[:, None, None]  # BN inference, unit statistics
        z = F.leaky_relu(z, 0.2)
        return torch.tanh(conv(z, ko, 1) + bo[:, None, None])

    def packed_tail():
        return packed_tail_forward(x, k4, b4, scale, bias, mean, var, ko, bo)

    tail_macs = (2 * th) ** 2 * cmid * 4 * cin + (2 * th) ** 2 * cout * 16 * cmid
    timed("tail.native", native_tail, tail_macs)
    timed("tail.packed", packed_tail, tail_macs)

    # the latent and fc projections
    flat = c4 * (h // 16) ** 2
    for name, m, n in (("enc.dense_hq", flat, cfg.hq_latent_dim),
                       ("enc.dense_lq", flat, cfg.base_latent_dim),
                       ("gen.dense_hq", cfg.hq_latent_dim, bh * bh * bc),
                       ("gen.dense_lq", cfg.base_latent_dim, bh * bh * bc)):
        x, w = randn(B, m), randn(n, m, scale=0.01)
        timed(name, lambda x=x, w=w: F.linear(x, w), m * n)

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
