#!/usr/bin/env python
"""Train the adaptive GAN compression codec with the PyTorch port: the
reference flow (the training epochs, then fine-tuning at each bpp), with the
flags, printed lines and files of scripts/train_gan.py.

Examples:
  python scripts/torch_train_gan.py --data-dir dataset --epochs 20
  python scripts/torch_train_gan.py --synthetic 64 --epochs 2 --img-size 128 \
      --base-latent-dim 128      # smoke run, no dataset needed

It runs on the card; main(device="cpu") runs it on the CPU (each kernel's
plain twin). Training writes the per-epoch figures, which need matplotlib:
where it does not import, main raises before any work. On the card the
corpus stays in device memory when it is under 4 GiB.

On a (data, model) mesh, one process a device, under torchrun:
  torchrun --nproc-per-node 4 scripts/torch_train_gan.py --backend nccl \
      --model-parallel 2 --synthetic 64 --epochs 2
Each rank takes cuda:<LOCAL_RANK> (nccl), each node its share of the corpus;
the batch size is the global one. gloo serves the CPU and ranks that share
a card. --model-parallel above 1 without torchrun exits naming it.
"""

import argparse
import dataclasses
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data-dir", default="dataset")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic images instead of a dataset dir")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--base-latent-dim", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--results-dir", default=None)
    p.add_argument("--model-dir", default=None)
    p.add_argument("--vgg-weights", default="")
    p.add_argument("--no-perceptual", action="store_true")
    p.add_argument("--quant-grad-mode", choices=["auto", "ste", "reference"],
                   default="auto",
                   help="'auto' follows the measured per-topology map "
                   "(encoder skips -> 'reference', zero skips -> 'ste'; "
                   "see QuantizerConfig.grad_mode)")
    p.add_argument("--skip-mode", choices=["encoder", "zero", "mask"],
                   default="encoder",
                   help="'zero' trains the storable codec (generators see no "
                   "encoder skips; the latent bitstream alone reconstructs -- "
                   "see ModelConfig.skip_mode); 'mask' is 'zero' plus "
                   "decode-side mask/blend-map skip conditioning (zero extra "
                   "bits). Checkpoint-compatible with 'encoder' runs, so "
                   "fine-tuning from one is supported")
    p.add_argument("--rate-mode", choices=["reference", "fixed"],
                   default="reference",
                   help="quantizer rate schedule: 'reference' is the faithful "
                   "falling schedule (anti-monotone on the real-bitstream "
                   "axis); 'fixed' rises with target bpp so measured container "
                   "bpp/PSNR track the request (see ModelConfig.rate_mode)")
    p.add_argument("--precision", choices=["float32", "mixed"], default="float32",
                   help="'mixed' = bfloat16 activations with float32 params, "
                   "optimizer states, BN statistics, and losses")
    p.add_argument("--bn-mode", choices=["train", "frozen"], default="train")
    p.add_argument("--disc-bn-mode", choices=["train", "frozen"], default=None,
                   help="discriminator BN mode; default 'frozen' (batch-stat D "
                   "BN measurably destabilizes the adversarial game -- see "
                   "train/gan_trainer.py). The reference's D effectively runs "
                   "frozen (GAN_train.py:198-224)")
    p.add_argument("--save-mode", choices=["background", "host"],
                   default="background",
                   help="'background': a snapshot on the device + writer thread (fast, "
                   "but transiently doubles the ~5 GB train state in device "
                   "memory); 'host': blocking device->host serialization with no "
                   "device copy (use when device memory is tight)")
    p.add_argument("--branch-recon-weight", type=float, default=0.0,
                   help="weight for the per-branch reconstruction loss "
                   "(MSE on hq_output and lq_output each, in addition to the "
                   "reference's blended-only recon). 0.0 = faithful. The "
                   "reference's blend map is ~all-LQ during training, so its "
                   "HQ generator never learns (measured 14.65 dB vs LQ's "
                   "22.50 dB); see LossConfig.branch_recon_weight")
    p.add_argument("--broadcast-quirk", action="store_true",
                   help="reproduce the reference's (B,B) TF broadcast in the "
                   "latent-saliency and bitrate losses (GAN_train.py:307-335)")
    p.add_argument("--synthetic-rich", action="store_true",
                   help="use the diverse synthetic corpus for --synthetic")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="model-parallel degree of the (data, model) mesh; a mesh "
                   "runs under torchrun, one process a device")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="torch.distributed backend under torchrun (required there): "
                   "nccl with a card a rank, gloo on the CPU or for ranks that "
                   "share a card")
    p.add_argument("--no-fine-tune", action="store_true",
                   help="skip the per-bpp fine-tuning phase")
    p.add_argument("--fine-tune-only", action="store_true",
                   help="skip the main training phase and run only the per-bpp "
                   "fine-tuning (resumes from the latest checkpoint; use to "
                   "finish an interrupted reference flow)")
    p.add_argument("--fine-tune-bpps", default="",
                   help="comma-separated target bpps for fine-tuning "
                   "(default: the config bpp_range)")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="epochs between intermediate checkpoints (default 5, "
                   "the reference cadence, GAN_train.py:548; raise it on "
                   "remote-TPU runtimes where each save costs minutes of "
                   "device->host transfer -- the end-of-fit 'final' save "
                   "always happens)")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)

    from contextual_image_compression_tpu_torch.config import (
        LossConfig, ModelConfig, QuantizerConfig, TrainConfig, resolve_device,
    )
    from contextual_image_compression_tpu_torch.data import images as image_io
    from contextual_image_compression_tpu_torch.data.pipeline import (
        CompressionDataset, prepare_masks,
    )
    from contextual_image_compression_tpu_torch.eval import plots
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer

    plots.pyplot()  # every fit below writes figures
    mesh = None
    if "WORLD_SIZE" in os.environ:  # under torchrun
        if args.backend is None:
            raise SystemExit("under torchrun, give --backend (nccl or gloo)")
        from contextual_image_compression_tpu_torch.parallel import (
            create_mesh, initialize_multihost,
        )
        initialize_multihost("env://", backend=args.backend)
        mesh = create_mesh(args.model_parallel, multihost=True,
                           device=None if resolve_device(device).type == "cuda" else device)
        device = mesh.device
        print(f"Mesh {mesh.shape}, rank position {mesh.position} on {device}")
    elif args.model_parallel > 1:
        raise SystemExit(f"--model-parallel {args.model_parallel} needs a process group: "
                         "run it under torchrun (one process a device) with --backend")

    mcfg = ModelConfig()
    if args.img_size:
        mcfg = dataclasses.replace(
            mcfg, img_size=(args.img_size, args.img_size),
            generator_base_hw=args.img_size // 16,
        )
    if args.base_latent_dim:
        mcfg = dataclasses.replace(mcfg, base_latent_dim=args.base_latent_dim)
    mcfg = dataclasses.replace(
        mcfg, quantizer=QuantizerConfig(grad_mode=args.quant_grad_mode),
        skip_mode=args.skip_mode, rate_mode=args.rate_mode,
    )
    if args.precision == "mixed":
        mcfg = dataclasses.replace(mcfg, dtype="bfloat16", param_dtype="float32")

    cfg = TrainConfig(model=mcfg, seed=args.seed,
                      vgg_weights_path=args.vgg_weights,
                      use_perceptual=not args.no_perceptual,
                      loss=LossConfig(
                          reference_broadcast_quirk=args.broadcast_quirk,
                          branch_recon_weight=args.branch_recon_weight,
                      ))
    overrides = {}
    for field, val in [("epochs", args.epochs), ("batch_size", args.batch_size),
                       ("learning_rate", args.learning_rate),
                       ("results_dir", args.results_dir),
                       ("model_dir", args.model_dir),
                       ("checkpoint_every", args.checkpoint_every)]:
        if val is not None:
            overrides[field] = val
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    if args.synthetic:
        gen = (image_io.rich_synthetic_images if args.synthetic_rich
               else image_io.synthetic_images)
        images = gen(args.synthetic, mcfg.img_size, args.seed)
        print(f"Using {len(images)} synthetic images"
              + (" (rich corpus)" if args.synthetic_rich else ""))
    else:
        images, _, _ = image_io.load_folder_gan(
            args.data_dir, mcfg.img_size, args.max_images
        )
        if len(images) == 0:
            print(f"No images found in {args.data_dir}!")
            return 1
        print(f"Loaded {len(images)} images from {args.data_dir}")

    print("Computing saliency masks on device...")
    masks = prepare_masks(images, cfg.saliency, device=device)
    # Keep the corpus in device memory when it fits (no upload per step).
    corpus_bytes = images.nbytes + masks.nbytes
    device_resident = resolve_device(device).type == "cuda" and corpus_bytes < 4 * 1024**3
    if device_resident:
        print(f"Corpus ({corpus_bytes / 2**20:.0f} MiB) kept device-resident")
    nodes = sorted(set(mesh.nodes)) if mesh is not None else [0]
    dataset = CompressionDataset(
        images, masks, batch_size=cfg.batch_size, bpp_range=cfg.bpp_range,
        seed=cfg.seed, device_resident=device_resident, device=device,
        process_index=mesh.nodes[mesh.position] if mesh is not None else 0,
        process_count=len(nodes),
    )

    trainer = GANTrainer(cfg, bn_mode=args.bn_mode,
                         disc_bn_mode=args.disc_bn_mode,
                         save_mode=args.save_mode, device=device, mesh=mesh)
    trainer.init_state(resume=not args.no_resume)
    if not args.fine_tune_only:
        trainer.fit(dataset)

    if not args.no_fine_tune:
        ft_bpps = ([float(b) for b in args.fine_tune_bpps.split(",") if b]
                   or list(cfg.bpp_range))
        for target_bpp in ft_bpps:
            print(f"Fine-tuning for target bitrate: {target_bpp} bpp...")
            trainer.fit(
                dataset.with_target_bpp(float(target_bpp)),
                epochs=cfg.fine_tune_epochs,
            )
    print("Training completed!")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
