#!/usr/bin/env python
"""Train the baseline skip-connection autoencoder with the PyTorch port, with
the flags, printed lines and files of scripts/train_autoencoder.py.

Examples:
  python scripts/torch_train_autoencoder.py --data-dir dataset --epochs 50
  python scripts/torch_train_autoencoder.py --synthetic 64 --epochs 3   # smoke run

It runs on the card; main(device="cpu") runs it on the CPU.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", default="dataset")
    p.add_argument("--synthetic", type=int, default=0)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--img-size", type=int, default=128)
    p.add_argument("--model-dir", default="ae_model")
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    from contextual_image_compression_tpu_torch.config import AutoencoderConfig
    from contextual_image_compression_tpu_torch.data import images as image_io
    from contextual_image_compression_tpu_torch.train.ae_trainer import AETrainer

    cfg = AutoencoderConfig(img_size=(args.img_size, args.img_size))
    if args.epochs:
        cfg = dataclasses.replace(cfg, epochs=args.epochs)
    if args.batch_size:
        cfg = dataclasses.replace(cfg, batch_size=args.batch_size)

    if args.synthetic:
        # synthetic_images yields [-1,1]; AE wants [0,1]
        images = (image_io.synthetic_images(args.synthetic, cfg.img_size, args.seed) + 1) / 2
        print(f"Using {len(images)} synthetic images")
    else:
        images, _paths = image_io.load_folder_unit(args.data_dir, cfg.img_size)
        if len(images) == 0:
            print(f"No images found in the dataset folder: {args.data_dir}")
            return 1
        print(f"Loaded {len(images)} images from {args.data_dir}")

    trainer = AETrainer(cfg, device=device)
    trainer.init()
    history = trainer.fit(images)
    trainer.save(args.model_dir)
    print(f"Model saved to: {args.model_dir} "
          f"(final loss {history['loss'][-1]:.5f}, val {history['val_loss'][-1]:.5f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
