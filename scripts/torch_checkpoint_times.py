#!/usr/bin/env python3
"""Where a full-width checkpoint's time goes on the card (PyTorch port).

    python3 scripts/torch_checkpoint_times.py

Prints the card's name and power limit, then, for the GAN train state of
TrainConfig() after one step (codec, discriminator, four Adam states: ~5
GB in the JAX package's files) in a temporary directory:

  * save, GANTrainer.save in 'background' mode: its blocking part (the
    clone on the card, what a training step waits for) and its writer
    thread; then the writer's work again in two parts, the layout maps to
    JAX's layout with the copy to the host, and the file writes;
  * resume, in the stages of GANTrainer.init_state(resume=True): the
    seeded build on the card, the files read and parsed
    (checkpoint/flax_msgpack.py), the layout maps on the host (convert.py),
    the copy to the card (load_state_dict, the Adam states).

Each stage on the host clock with the card synchronised; the files are
read right after they were written, so from the page cache. Needs a CUDA
device.
"""

import argparse
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    argparse.ArgumentParser(description=__doc__).parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from contextual_image_compression_tpu_torch import convert
    from contextual_image_compression_tpu_torch.checkpoint import CheckpointStore, flax_msgpack
    from contextual_image_compression_tpu_torch.config import TrainConfig
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.data.pipeline import CompressionDataset
    from contextual_image_compression_tpu_torch.measure import card_name_and_power
    from contextual_image_compression_tpu_torch.models.adaptive import ALL_CODEC_COMPONENTS
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_and_power()
    print(card, flush=True)
    dev = torch.device("cuda")
    times = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainConfig(vgg_weights_path="random:0", model_dir=tmp)
        trainer = GANTrainer(cfg, device=dev, log_fn=lambda s: None)
        state = trainer.init_state(resume=False)
        imgs = synthetic_images(cfg.batch_size, cfg.model.img_size, seed=0)
        masks = (imgs[..., :1] + 1.0) / 2.0
        ds = CompressionDataset(imgs, masks, batch_size=cfg.batch_size, device=dev)
        trainer.builder.train_step(state, next(ds.epoch()), True)  # Adam moments exist

        stage("save: blocking part (the clone on the card)", lambda: trainer.save("final"))
        stage("save: the writer thread (layout maps on the card, copy to the host, write)",
              trainer._join_saver)

        def to_jax():
            trees = convert.codec_variables(state.codec)
            trees["discriminator"] = convert.discriminator_variables(state.disc, cfg.model)
            trees["optimizers"] = convert.optimizer_variables(state)
            return trees

        trees = stage("save, its parts: layout maps on the card + copy to the host", to_jax)
        store = CheckpointStore(tmp)
        stage("save, its parts: write the files", lambda: store.save_components(trees, "final"))
        nbytes = sum(os.path.getsize(os.path.join(tmp, f)) for f in os.listdir(tmp)
                     if f.endswith(".msgpack"))
        del trees

        fresh = stage("resume: seeded build on the card", lambda: GANTrainer(
            cfg, device=dev, log_fn=lambda s: None))
        st = stage("resume: seeded init", lambda: fresh.builder.init_state(cfg.seed))
        loaded = stage("resume: read and parse the files", lambda: {
            name: flax_msgpack.read(store._path(name, "final"))
            for name in ALL_CODEC_COMPONENTS + ("discriminator", "optimizers")})
        sds = stage("resume: layout maps on the host", lambda: {
            **{c: convert.component_state(c, loaded[c], cfg.model) for c in ALL_CODEC_COMPONENTS},
            "discriminator": convert.convert_discriminator_variables(
                loaded["discriminator"], cfg.model)})

        def to_card():
            for c in ALL_CODEC_COMPONENTS:
                getattr(st.codec, c).load_state_dict(sds[c])
            st.disc.load_state_dict(sds["discriminator"])

        stage("resume: copy to the card (load_state_dict)", to_card)
        stage("resume: Adam states (layout maps on the host + copy)",
              lambda: convert.load_optimizer_variables(st, loaded["optimizers"]))
        whole = stage("resume: init_state(resume=True) as one call",
                      lambda: GANTrainer(cfg, device=dev, log_fn=lambda s: None).init_state())
        del whole
    print(f"train state {nbytes / 1e9:.3f} GB (TrainConfig(), one step taken) on {card}; "
          f"host clock, card synchronised:", flush=True)
    for name, secs in times.items():
        print(f"  {name}: {secs:.3f} s ({nbytes / 1e9 / secs:.2f} GB/s over the whole state)",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
