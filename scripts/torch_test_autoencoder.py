#!/usr/bin/env python
"""Evaluate the baseline autoencoder with the PyTorch port: reconstruct the
test images, save JPEG outputs, report MSE / PSNR / SSIM / size-reduction
averages, the flags of scripts/test_autoencoder.py.

It runs on the card; main(device="cpu") runs it on the CPU.
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--test-dir", default="test_dataset")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--model-dir", default="ae_model")
    p.add_argument("--img-size", type=int, default=128)
    p.add_argument("--output-dir", default="compressed_outputs")
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    from contextual_image_compression_tpu_torch.config import AutoencoderConfig
    from contextual_image_compression_tpu_torch.data import images as image_io
    from contextual_image_compression_tpu_torch.eval.ae_eval import evaluate_autoencoder
    from contextual_image_compression_tpu_torch.train.ae_trainer import AETrainer

    cfg = AutoencoderConfig(img_size=(args.img_size, args.img_size))
    trainer = AETrainer(cfg, device=device)
    try:
        trainer.load(args.model_dir)
    except FileNotFoundError:
        print(f"Trained model not found in: {args.model_dir}")
        return 1

    if args.synthetic:
        images = (image_io.synthetic_images(args.synthetic, cfg.img_size, args.seed) + 1) / 2
        # files of the originals, for the size-reduction metric
        tmp = tempfile.mkdtemp(prefix="ae_test_")
        paths = []
        for i in range(len(images)):
            path = f"{tmp}/synthetic_{i}.jpg"
            image_io.save_image_unit(images[i], path)
            paths.append(path)
    else:
        images, paths = image_io.load_folder_unit(args.test_dir, cfg.img_size)
        if len(images) == 0:
            print(f"No images found in test dataset folder: {args.test_dir}")
            return 1

    print(f"Testing on {len(images)} images")
    results = evaluate_autoencoder(trainer, images, paths, args.output_dir)
    print("\n=== Overall Compression Performance ===")
    print(f"  - Average Mean Squared Error (MSE): {results['mse']:.4f}")
    print(f"  - Average Peak Signal-to-Noise Ratio (PSNR): {results['psnr']:.2f} dB")
    print(f"  - Average Structural Similarity Index (SSIM): {results['ssim']:.4f}")
    print(f"  - Average Size Reduction: {results['size_reduction']:.2f}%")
    print(f"\nCompressed images saved in '{args.output_dir}'.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
