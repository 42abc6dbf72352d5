#!/usr/bin/env python
"""Storable-codec evaluation with the PyTorch port: bytes -> image with NO
encoder in the loop, with the flags, printed lines and --out JSON of
scripts/eval_bitstream.py.

It encodes a held-out synthetic corpus (256^2) from a checkpoint directory
to self-contained per-image containers, decodes each from the bytes alone
(CompressionPipeline.decode_from_bitstream), and reports PSNR / SSIM of the
decoded images against the originals and the container bpp (mask and
header included), beside the forward path (encoder in the loop).

Usage:
  python scripts/torch_eval_bitstream.py --model-dir runs/r4_skipfree/ste/models_ckpt \
      --skip-mode zero --synthetic 8 --synthetic-rich --seed 7

It runs on the card; main(device="cpu") runs it on the CPU.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-dir", required=True)
    p.add_argument("--synthetic", type=int, default=8)
    p.add_argument("--synthetic-rich", action="store_true")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--skip-mode", choices=["encoder", "zero", "mask"],
                   default="zero")
    p.add_argument("--rate-mode", choices=["reference", "fixed"],
                   default="reference",
                   help="quantizer rate schedule (ModelConfig.rate_mode); must "
                   "match what the checkpoint was trained/fine-tuned with")
    p.add_argument("--quant-bypass", action="store_true",
                   help="measure the architecture CEILING: run the forward "
                   "path with unquantized latents (no bitstream columns -- "
                   "nothing storable corresponds to fp32 latents)")
    p.add_argument("--bpps", type=float, nargs="+", default=[0.1, 1.0, 2.0])
    p.add_argument("--base-latent-dim", type=int, default=None,
                   help="LQ latent width (HQ = 2x); must match the checkpoint "
                   "(round-5 latent-capacity sweep, runs/r5_latent_sweep)")
    p.add_argument("--mask-downsample", type=int, default=8)
    p.add_argument("--out", default="",
                   help="optional JSON path for the per-bpp results table")
    args = p.parse_args(argv)

    import dataclasses

    import torch

    from contextual_image_compression_tpu_torch.config import ModelConfig
    from contextual_image_compression_tpu_torch.data.images import (
        rich_synthetic_images,
        synthetic_images,
    )
    from contextual_image_compression_tpu_torch.ops.metrics import psnr, ssim_rgb_channel_mean
    from contextual_image_compression_tpu_torch.serve import CompressionPipeline

    gen = rich_synthetic_images if args.synthetic_rich else synthetic_images
    imgs = gen(args.synthetic, (256, 256), seed=args.seed)  # [-1, 1] float
    imgs_u8 = np.clip(np.round((imgs + 1.0) * 127.5), 0, 255).astype(np.uint8)

    mcfg = dataclasses.replace(
        ModelConfig(), skip_mode=args.skip_mode, rate_mode=args.rate_mode,
        quant_bypass=args.quant_bypass,
    )
    if args.base_latent_dim:
        mcfg = dataclasses.replace(mcfg, base_latent_dim=args.base_latent_dim)
    pipe = CompressionPipeline(model_dir=args.model_dir, model_config=mcfg, device=device)
    print(f"Loaded components: {pipe.provenance}")
    print(f"skip_mode={args.skip_mode}, rate_mode={args.rate_mode}, "
          f"{args.synthetic} held-out images (seed {args.seed})"
          + (" [QUANT BYPASSED: ceiling measurement]" if args.quant_bypass else ""))

    def unit(u8):
        return torch.from_numpy(u8.astype(np.float32) / 255.0).to(pipe.device)

    ref = unit(imgs_u8)
    npix = imgs_u8.shape[1] * imgs_u8.shape[2]
    rows = []
    for bpp in args.bpps:
        # Forward-path decode (encoder in the loop) for comparison.
        fwd_u8, _ = pipe(imgs_u8, target_bpp=bpp)
        fwd = unit(fwd_u8)
        fwd_psnr = float(torch.mean(psnr(ref, fwd)))

        if args.quant_bypass:
            fwd_ssim = float(torch.mean(ssim_rgb_channel_mean(ref, fwd)))
            rows.append({
                "target_bpp": bpp,
                "ceiling_psnr": fwd_psnr,
                "ceiling_ssim": fwd_ssim,
            })
            print(f"bpp {bpp}: CEILING (unquantized latents) "
                  f"PSNR {fwd_psnr:.2f} dB, SSIM {fwd_ssim:.4f}")
            continue

        # The storable path: bytes -> image only.
        streams = pipe.encode_to_bitstream(
            imgs_u8, target_bpp=bpp, mask_downsample=args.mask_downsample
        )
        dec = unit(pipe.decode_from_bitstream(streams))
        dec_psnr = float(torch.mean(psnr(ref, dec)))
        dec_ssim = float(torch.mean(ssim_rgb_channel_mean(ref, dec)))
        container_bpp = float(
            np.mean([len(s) * 8.0 / npix for s in streams])
        )
        rows.append({
            "target_bpp": bpp,
            "bitstream_decode_psnr": dec_psnr,
            "bitstream_decode_ssim": dec_ssim,
            "container_bpp": container_bpp,
            "forward_path_psnr": fwd_psnr,
        })
        print(
            f"bpp {bpp}: bitstream-decode PSNR {dec_psnr:.2f} dB, "
            f"SSIM {dec_ssim:.4f}, container bpp {container_bpp:.4f} "
            f"(forward-path PSNR {fwd_psnr:.2f} dB, "
            f"delta {dec_psnr - fwd_psnr:+.2f} dB)"
        )
    if args.out:
        import json

        with open(args.out, "w") as f:
            json.dump({
                "model_dir": args.model_dir, "skip_mode": args.skip_mode,
                "rate_mode": args.rate_mode,
                "quant_bypass": args.quant_bypass,
                "base_latent_dim": mcfg.base_latent_dim,
                "images": args.synthetic, "seed": args.seed,
                "mask_downsample": args.mask_downsample, "rows": rows,
            }, f, indent=2)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
