#!/usr/bin/env python
"""Codec shootout with the PyTorch port: AE vs adaptive GAN vs the DCT/JPEG
baseline (kernel K5) on batched inference, with the flags, printed lines and
files of scripts/codec_shootout.py.

A rate-distortion table + plot: for each codec, (bpp, PSNR, SSIM) points:
  * DCT at a quality sweep (entropy bpp + measured range-coder bpp)
  * GAN codec at the target-bpp sweep (analytic bpp per the reference's model +
    measured latent-bitstream bpp)
  * AE at its single operating point (bottleneck entropy bpp)

With untrained GAN/AE checkpoints this measures the *pipeline*, not learned RD
quality; pass --model-dir/--ae-dir to use trained weights. The JSON is
written before the plot; the plot needs matplotlib.

It runs on the card; main(device="cpu") runs it on the CPU.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--test-dir", default="")
    p.add_argument("--synthetic", type=int, default=16)
    p.add_argument("--synthetic-rich", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model-dir", default="models_ckpt")
    p.add_argument("--gan-skip-mode", choices=["encoder", "zero", "mask"],
                   default="encoder",
                   help="skip topology of the --model-dir checkpoint (pass "
                   "'zero' to run the forward-path GAN series from a skip-free "
                   "checkpoint when no encoder-skip checkpoint is on disk)")
    p.add_argument("--skipfree-dir", default="",
                   help="optional storable-codec checkpoint (skip_mode zero or "
                   "mask): adds the bytes->image RD series (true container "
                   "bpp, decode with no encoder in the loop)")
    p.add_argument("--skipfree-skip-mode", choices=["zero", "mask"],
                   default="zero",
                   help="skip topology the --skipfree-dir checkpoint was "
                   "trained with")
    p.add_argument("--skipfree-rate-mode", choices=["reference", "fixed"],
                   default="reference",
                   help="rate schedule the --skipfree-dir checkpoint was "
                   "trained with (ModelConfig.rate_mode)")
    p.add_argument("--ae-dir", default="ae_model")
    p.add_argument("--img-size", type=int, default=256)
    p.add_argument("--out", default="codec_shootout.json")
    p.add_argument("--plot", default="codec_shootout.png")
    args = p.parse_args(argv)

    import torch

    from contextual_image_compression_tpu_torch.config import (
        AutoencoderConfig, DCTCodecConfig, EvalConfig, ModelConfig, resolve_device,
    )
    from contextual_image_compression_tpu_torch.data import images as image_io
    from contextual_image_compression_tpu_torch.data.pipeline import prepare_masks
    from contextual_image_compression_tpu_torch.eval.harness import CodecEvaluator
    from contextual_image_compression_tpu_torch.ops import bitstream
    from contextual_image_compression_tpu_torch.ops import metrics as M
    from contextual_image_compression_tpu_torch.ops.dct import DCTCodec
    from contextual_image_compression_tpu_torch.ops.saliency import (
        _full_fp32_matmul, resize_op_matrix,
    )
    from contextual_image_compression_tpu_torch.train.ae_trainer import AETrainer

    dev = resolve_device(device)
    size = (args.img_size, args.img_size)
    if args.test_dir:
        images, names, _ = image_io.load_folder_gan(args.test_dir, size)
    else:
        gen = (image_io.rich_synthetic_images if args.synthetic_rich
               else image_io.synthetic_images)
        images = gen(args.synthetic, size, seed=args.seed)
    print(f"{len(images)} images at {size}")
    imgs = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(dev)
    # Every series records its checkpoint provenance.
    results = {
        "provenance": {
            "gan_forward_path": {
                "model_dir": args.model_dir, "skip_mode": args.gan_skip_mode,
                "note": ("NOT STORABLE: with encoder skips the generators "
                         "consume tensors that bypass the latent bitstream "
                         "(GAN_functions.py:256-266); this series measures the "
                         "encode+decode forward pass, bpp is the measured "
                         "latent-stream rate" if args.gan_skip_mode == "encoder"
                         else "storable topology run through the forward path"),
            },
            "gan_storable": {
                "model_dir": args.skipfree_dir or None,
                "skip_mode": args.skipfree_skip_mode,
                "rate_mode": args.skipfree_rate_mode,
                "note": "bytes->image, no encoder in the loop; container bpp "
                        "includes mask thumbnail + headers",
            },
            "ae_dir": args.ae_dir,
        },
        "dct": [], "gan": [], "gan_storable": [], "ae": [],
    }

    def mean(t):
        return float(torch.mean(t.float()))

    # ------------------------------------------------------------------- DCT
    for q in (10, 20, 30, 50, 75, 90):
        codec = DCTCodec(DCTCodecConfig(quality=q), device=device)
        ev = codec.evaluate(imgs)
        m = M.gan_metrics(imgs, ev["reconstruction"])
        sym = ev["symbols"].cpu().numpy()
        measured = float(np.mean([
            codec.measured_bpp(sym[i], size) for i in range(min(4, len(sym)))
        ]))
        results["dct"].append({
            "quality": q,
            "bpp_entropy": mean(ev["bpp"]),
            "bpp_measured": measured,
            "psnr": mean(m["psnr"]),
            "ssim": mean(m["ssim"]),
        })
        print("dct", results["dct"][-1])

    # ------------------------------------------------------------------- GAN
    mcfg = ModelConfig(
        img_size=size, generator_base_hw=args.img_size // 16,
        skip_mode=args.gan_skip_mode,
    )
    ecfg = EvalConfig(model=mcfg, model_dir=args.model_dir)
    evaluator = CodecEvaluator(ecfg, device=device)
    gan, provenance = evaluator.load_models()
    trained = any(v != "init" for v in provenance.values())
    print("GAN weights:", "trained" if trained else "UNTRAINED (pipeline-only numbers)")
    masks = prepare_masks(images, ecfg.saliency, device=device)

    def host(t):
        return t.float().cpu().numpy()

    for bpp in (0.1, 0.5, 1.0, 2.0):
        r = evaluator.compress_and_reconstruct(gan, images, masks, bpp)
        # real latent bitstream for the first few images
        k = min(4, len(images))
        outs = evaluator.run_batch(gan, images[:k], masks[:k], bpp)
        out0 = outs[0]
        qs = host(out0.quant_strength)[:, 0]
        hq_scales = np.exp(3.0 * qs * (1 - host(out0.hq_saliency_quant)[:, 0]))
        lq_scales = np.exp(3.0 * qs * (1 - host(out0.lq_saliency_quant)[:, 0]))
        streams = bitstream.pack_codec_latents(
            host(out0.hq_latent_q)[:k], host(out0.lq_latent_q)[:k],
            hq_scales[:k], lq_scales[:k],
        )
        results["gan"].append({
            "target_bpp": bpp,
            "bpp_analytic": float(np.mean(r["actual_bpp"])),
            "bpp_measured": float(np.mean(bitstream.measured_bpp(streams, size))),
            "psnr": float(np.mean(r["psnr"])),
            "ssim": float(np.mean(r["ssim"])),
            "hq_ratio": float(np.mean(r["hq_ratio"])),
            "trained": trained,
        })
        print("gan", results["gan"][-1])

    # ----------------------------------------------------- storable GAN codec
    if args.skipfree_dir:
        from contextual_image_compression_tpu_torch.serve import CompressionPipeline

        sf_cfg = dataclasses.replace(
            mcfg, skip_mode=args.skipfree_skip_mode,
            rate_mode=args.skipfree_rate_mode,
        )
        pipe = CompressionPipeline(
            model_dir=args.skipfree_dir, model_config=sf_cfg, device=device
        )
        print(f"storable codec weights from {args.skipfree_dir} "
              f"(skip_mode={args.skipfree_skip_mode}, "
              f"rate_mode={args.skipfree_rate_mode}):", pipe.provenance)
        imgs_u8 = np.clip(
            np.round((np.asarray(images) + 1.0) * 127.5), 0, 255
        ).astype(np.uint8)
        ref01 = torch.from_numpy(imgs_u8.astype(np.float32) / 255.0).to(dev)
        npix = float(size[0] * size[1])
        for bpp in (0.1, 0.5, 1.0, 2.0):
            streams = pipe.encode_to_bitstream(
                imgs_u8, target_bpp=bpp, mask_downsample=8
            )
            dec = torch.from_numpy(
                pipe.decode_from_bitstream(streams).astype(np.float32) / 255.0
            ).to(dev)
            results["gan_storable"].append({
                "target_bpp": bpp,
                "bpp_container": float(np.mean(
                    [len(s) * 8.0 / npix for s in streams]
                )),
                "psnr": mean(M.psnr(ref01, dec)),
                "ssim": mean(M.ssim_rgb_channel_mean(ref01, dec)),
            })
            print("gan_storable", results["gan_storable"][-1])

    # -------------------------------------------------------------------- AE
    acfg = AutoencoderConfig(img_size=(128, 128))
    trainer = AETrainer(acfg, log_fn=lambda *_: None, device=device)
    try:
        trainer.load(args.ae_dir)
        ae_trained = True
    except FileNotFoundError:
        trainer.init()
        ae_trained = False
    # jax.image.resize 'linear' (antialiased when it shrinks) as its operator
    # matrices, in full float32
    rh = torch.from_numpy(resize_op_matrix(size[0], 128)).to(dev)
    rw = torch.from_numpy(resize_op_matrix(size[1], 128)).to(dev)
    with _full_fp32_matmul(dev):
        small = torch.einsum("ih,nhwc,jw->nijc", rh, imgs, rw)
    imgs01 = (small * 0.5 + 0.5).cpu().numpy()
    recon = trainer.reconstruct(imgs01)
    m = M.gan_metrics(torch.from_numpy(imgs01).to(dev) * 2 - 1,
                      torch.from_numpy(recon).to(dev) * 2 - 1)
    # bottleneck entropy at 8-bit quantization as the AE's bpp accounting
    with torch.no_grad():
        z = trainer.model.encode(torch.from_numpy(imgs01[:4]).to(dev).permute(0, 3, 1, 2))
    z = z.float().permute(0, 2, 3, 1).cpu().numpy()  # NHWC, the JAX layout
    zq = np.clip(np.round(z * 32), -32768, 32767).astype(np.int16)
    bpps = []
    for i in range(len(zq)):
        stream = DCTCodec.serialize(zq[i].ravel())
        bpps.append(8 * len(stream) / (128 * 128))
    results["ae"].append({
        "bpp_measured": float(np.mean(bpps)),
        "psnr": mean(m["psnr"]),
        "ssim": mean(m["ssim"]),
        "trained": ae_trained,
    })
    print("ae", results["ae"][-1])

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)

    # ------------------------------------------------------------------ plot
    from contextual_image_compression_tpu_torch.eval import plots

    plt = plots.pyplot()
    fig = plt.figure(figsize=(8, 6))
    plt.plot([r["bpp_entropy"] for r in results["dct"]],
             [r["psnr"] for r in results["dct"]], "ko-", label="DCT/JPEG (K5)")
    fwd_name = Path(args.model_dir).parent.name or args.model_dir
    caveat = ", NOT storable" if args.gan_skip_mode == "encoder" else ""
    plt.plot([r["bpp_measured"] for r in results["gan"]],
             [r["psnr"] for r in results["gan"]], "bs-",
             label=(f"GAN fwd-path [{fwd_name}, {args.gan_skip_mode} skips"
                    f"{caveat}] ({'trained' if trained else 'untrained'})"))
    if results["gan_storable"]:
        sf_name = Path(args.skipfree_dir).parent.name or args.skipfree_dir
        plt.plot([r["bpp_container"] for r in results["gan_storable"]],
                 [r["psnr"] for r in results["gan_storable"]], "gd-",
                 label=(f"GAN storable bytes->image [{sf_name}, "
                        f"{args.skipfree_skip_mode} skips, "
                        f"{args.skipfree_rate_mode} rate]"))
    plt.plot([r["bpp_measured"] for r in results["ae"]],
             [r["psnr"] for r in results["ae"]], "r^", markersize=10,
             label=f"AE [{args.ae_dir}] ({'trained' if ae_trained else 'untrained'})")
    plt.xlabel("bpp"); plt.ylabel("PSNR (dB)")
    plt.title("Codec shootout (rate-distortion)")
    plt.grid(True, alpha=0.3); plt.legend()
    fig.savefig(args.plot, dpi=150)
    print(f"wrote {args.out} and {args.plot}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
