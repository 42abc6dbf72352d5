#!/usr/bin/env python
"""Evaluate the adaptive GAN codec with the PyTorch port: the bpp sweep, the
rate-distortion curves and the rate-control analysis, the flags and files of
scripts/test_gan.py.

Examples:
  python scripts/torch_test_gan.py --test-dir test_dataset --model-dir models_ckpt
  python scripts/torch_test_gan.py --synthetic 8         # no dataset needed

It runs on the card; main(device="cpu") runs it on the CPU (each kernel's
plain twin). The plots need matplotlib; metrics.txt and
rate_distortion_data.csv are written before any plot.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--test-dir", default="test_dataset")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--synthetic-rich", action="store_true",
                   help="use the diverse synthetic corpus (held-out seed)")
    p.add_argument("--model-dir", default="models_ckpt")
    p.add_argument("--results-dir", default="test_results")
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--base-latent-dim", type=int, default=None)
    p.add_argument("--threshold-mode", choices=["sigmoid", "hard"], default="sigmoid")
    p.add_argument("--rate-mode", choices=["reference", "fixed"],
                   default="reference",
                   help="quantizer rate schedule (ModelConfig.rate_mode)")
    p.add_argument("--skip-mode", choices=["encoder", "zero", "mask"],
                   default="encoder",
                   help="evaluate the storable (zero-skip) codec variant")
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    from contextual_image_compression_tpu_torch.config import EvalConfig, ModelConfig
    from contextual_image_compression_tpu_torch.data import images as image_io
    from contextual_image_compression_tpu_torch.data.pipeline import prepare_masks
    from contextual_image_compression_tpu_torch.eval import plots
    from contextual_image_compression_tpu_torch.eval.harness import CodecEvaluator

    mcfg = ModelConfig(threshold_mode=args.threshold_mode, skip_mode=args.skip_mode,
                       rate_mode=args.rate_mode)
    if args.img_size:
        mcfg = dataclasses.replace(
            mcfg, img_size=(args.img_size, args.img_size),
            generator_base_hw=args.img_size // 16,
        )
    if args.base_latent_dim:
        mcfg = dataclasses.replace(mcfg, base_latent_dim=args.base_latent_dim)
    cfg = EvalConfig(model=mcfg, results_dir=args.results_dir,
                     model_dir=args.model_dir, test_dir=args.test_dir)
    evaluator = CodecEvaluator(cfg, device=device)

    codec, provenance = evaluator.load_models()
    print(f"Loaded components: {provenance}")

    if args.synthetic:
        gen = (image_io.rich_synthetic_images if args.synthetic_rich
               else image_io.synthetic_images)
        images = gen(args.synthetic, mcfg.img_size, args.seed)
        file_names = [f"synthetic_{i}.png" for i in range(len(images))]
    else:
        images, file_names, _ = image_io.load_folder_gan(args.test_dir, mcfg.img_size)
        if len(images) == 0:
            print(f"No test images found in {args.test_dir}!")
            return 1
    print(f"Evaluating {len(images)} images")

    masks = prepare_masks(images, cfg.saliency, device=device)
    image_io.create_directories([cfg.results_dir])
    results = evaluator.test_compression(codec, images, masks, file_names)
    evaluator.test_rate_control(codec, images, masks, file_names)
    if results["avg_metrics"]:
        plots.plot_rate_distortion_curve(results["avg_metrics"], cfg.results_dir)
    for bpp, m in results["avg_metrics"].items():
        print(f"bpp {bpp}: PSNR {m['psnr']:.2f} dB, SSIM {m['ssim']:.4f}, "
              f"actual bpp {m['actual_bpp']:.4f}, HQ ratio {m['hq_ratio'] * 100:.2f}%")
    print(f"Results saved to {cfg.results_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
