#!/usr/bin/env python
"""Make the JAX-trained tiny GAN checkpoint that the PyTorch port is held to.

    JAX_PLATFORMS=cpu python scripts/make_jax_tiny_gan_fixture.py

A tool of the JAX package (it needs jax and flax), not part of the port.
It trains the tiny codec of the port's training tests (32^2, D = 16,
narrow channels; 'reference' quantizer gradients, no perceptual loss) with
the JAX GANTrainer for one epoch of 4 steps at B = 4 on seeded synthetic
images, then serves 8 seeded uint8 images through the JAX
CompressionPipeline built from that checkpoint directory at target bpp 1.0.
Into --out it copies the seven codec components' `*_final.msgpack`, the
`metadata_final.json`, and `outputs.npz` (the input images, the decoded
uint8 images and the float32 latent symbols of the pipeline).
"""

import argparse
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

TINY_KW = dict(
    img_size=(32, 32), base_latent_dim=16, encoder_channels=(8, 16, 24, 32),
    generator_channels=(24, 16, 8, 8), generator_base_hw=2, generator_base_ch=32,
)
COMPONENTS = ("hq_encoder", "hq_generator", "lq_encoder", "lq_generator",
              "latent_saliency_hq", "latent_saliency_lq", "rd_optimizer")


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default="tests/fixtures/jax_tiny_gan")
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    from contextual_image_compression_tpu.config import (
        ModelConfig,
        QuantizerConfig,
        TrainConfig,
    )
    from contextual_image_compression_tpu.data.images import synthetic_images
    from contextual_image_compression_tpu.data.pipeline import (
        CompressionDataset,
        prepare_masks,
    )
    from contextual_image_compression_tpu.serve import CompressionPipeline
    from contextual_image_compression_tpu.train.loop import GANTrainer

    with tempfile.TemporaryDirectory() as tmp:
        model = ModelConfig(**TINY_KW, quantizer=QuantizerConfig(grad_mode="reference"))
        cfg = TrainConfig(model=model, batch_size=4, epochs=1, use_perceptual=False,
                          model_dir=os.path.join(tmp, "model"),
                          results_dir=os.path.join(tmp, "results"))
        imgs = synthetic_images(16, (32, 32), seed=0)
        ds = CompressionDataset(imgs, prepare_masks(imgs, cfg.saliency), batch_size=4,
                                seed=cfg.seed)
        trainer = GANTrainer(cfg)
        trainer.init_state(resume=False)
        trainer.fit(ds, epochs=1, steps_per_epoch=4, artifacts=False)

        pipe = CompressionPipeline(model_dir=cfg.model_dir, model_config=ModelConfig(**TINY_KW))
        if set(pipe.provenance.values()) != {"final"}:
            raise SystemExit(f"the pipeline did not load every component: {pipe.provenance}")
        u8 = np.round((synthetic_images(8, (32, 32), seed=1) + 1.0) * 127.5).astype(np.uint8)
        decoded, info = pipe(u8, target_bpp=1.0)

        os.makedirs(args.out, exist_ok=True)
        for name in COMPONENTS:
            shutil.copy(os.path.join(cfg.model_dir, f"{name}_final.msgpack"), args.out)
        shutil.copy(os.path.join(cfg.model_dir, "metadata_final.json"), args.out)
        np.savez_compressed(
            os.path.join(args.out, "outputs.npz"), images=u8, decoded=decoded,
            hq_symbols=np.asarray(info["hq_symbols"], np.float32),
            lq_symbols=np.asarray(info["lq_symbols"], np.float32), target_bpp=np.float32(1.0))
    size = sum(f.stat().st_size for f in Path(args.out).iterdir())
    print(f"wrote {args.out}: {size} bytes; provenance {pipe.provenance}")


if __name__ == "__main__":
    main()
