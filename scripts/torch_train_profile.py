"""Where the time of the PyTorch port's full-width GAN training step goes, on one GPU.

    python3 scripts/torch_train_profile.py [--steps 6] [--out-dir profile_out]
                                           [--precision float32|mixed]

Builds GANTrainer(TrainConfig(vgg_weights_path="random:0"), device="cuda")
(TrainConfig() defaults: 256^2, D = 512, B = 16, float32 with TF32 off,
random VGG19 perceptual loss; --precision mixed: ModelConfig(dtype=
"bfloat16", param_dtype="float32"), VGG19 still float32), masks 16
synthetic images through K1, then:

  * times the phases of the step with CUDA events (codec forward, D phase,
    G/LS/RD losses with the perceptual and discriminator forwards plus the
    one backward, the three optimizer steps), median over --steps steps
    alternating D / no D, and the perceptual term alone (two VGG19 forwards
    and the backward to the reconstruction);
  * traces 4 steps (2 with D, 2 without) with torch.profiler and prints the
    CUDA kernels by total device time and the device-busy share of the
    traced wall time, beside the card's name and power limit. The Chrome
    trace and a JSON summary go to --out-dir (train_trace_<precision>.json,
    train_profile_<precision>.json).

It needs a CUDA device and exits 1 without one.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--out-dir", default="profile_out")
    ap.add_argument("--precision", choices=["float32", "mixed"], default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from contextual_image_compression_tpu_torch.config import ModelConfig, TrainConfig
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.data.pipeline import (
        CompressionDataset, prepare_masks)
    from contextual_image_compression_tpu_torch.measure import card_name_and_power, event_ms
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_name_and_power()
    print(f"{card}; precision {args.precision}", flush=True)
    dev = torch.device("cuda")
    # the trainer's checkpoint store makes its directory; this run saves nothing
    ckpt_dir = tempfile.TemporaryDirectory()
    mcfg = ModelConfig(dtype="bfloat16" if args.precision == "mixed" else "float32",
                       param_dtype="float32")
    cfg = TrainConfig(model=mcfg, vgg_weights_path="random:0", model_dir=ckpt_dir.name)
    imgs = synthetic_images(cfg.batch_size, cfg.model.img_size, seed=0)
    ds = CompressionDataset(imgs, prepare_masks(imgs, cfg.saliency, device=dev),
                            batch_size=cfg.batch_size, device_resident=True, device=dev)
    trainer = GANTrainer(cfg, device=dev, log_fn=lambda s: None)
    state = trainer.init_state(resume=False)
    b = trainer.builder
    batch = next(ds.epoch())
    for i in range(2):  # warm-up: cuDNN heuristics, allocator
        b.train_step(state, batch, i == 0)
    torch.cuda.synchronize()

    names = ("codec forward (K2, K3 x2)", "D phase", "G/LS/RD losses + one backward (K3b x2)",
             "three optimizer steps + BN commit")
    phase = {n: [] for n in names}
    step_ms = []
    for i in range(args.steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        out = b.codec_forward(state, batch)
        ev[1].record()
        if i % 2 == 0:
            b.d_phase(state, batch, out)
        ev[2].record()
        b.g_backward(state, batch, out)
        ev[3].record()
        b.g_update(state)
        ev[4].record()
        ev[4].synchronize()
        for n, a, c in zip(names, ev[:-1], ev[1:]):
            if n != "D phase" or i % 2 == 0:
                phase[n].append(a.elapsed_time(c))
        step_ms.append(ev[0].elapsed_time(ev[4]))
    times = {n: float(np.median(v)) for n, v in phase.items()}
    for n, ms in times.items():
        print(f"phase {n}: {ms:.3f} ms (CUDA events, median, B={cfg.batch_size})", flush=True)
    print(f"step (CUDA events): median {np.median(step_ms):.3f} ms over {args.steps} steps",
          flush=True)

    blended = out.blended.permute(0, 3, 1, 2).detach().requires_grad_(True)

    def perceptual():
        b.perceptual(batch.image, blended).backward()

    perc_ms = event_ms(perceptual, reps=5, warmup=1)
    print(f"perceptual term alone (2 VGG19 forwards + backward to the image): {perc_ms:.3f} ms",
          flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(4):
            b.train_step(state, batch, i % 2 == 0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    os.makedirs(args.out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.out_dir, f"train_trace_{args.precision}.json"))
    rows = []
    for ev in prof.key_averages():
        # device-side kernels, copies and sets only: user ranges such as
        # torch.optim's "Optimizer.step#Adam.step" span kernels counted already
        if ev.device_type != DeviceType.CUDA or getattr(ev, "is_user_annotation", False) \
                or ev.key.startswith("Optimizer."):
            continue
        self_dev = getattr(ev, "self_device_time_total", None)
        if self_dev is None:
            self_dev = ev.self_cuda_time_total
        if self_dev > 0:
            rows.append((self_dev, ev.count, ev.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(f"traced 4 steps: wall {wall_ms:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
          f"({100 * busy_us / 1e3 / wall_ms:.1f}% of wall)", flush=True)
    for self_dev, count, key in rows[:40]:
        print(f"  {self_dev / 1e3 / 4:9.4f} ms/step  {100 * self_dev / busy_us:5.1f}%  "
              f"x{count / 4:<6.1f} {key[:110]}", flush=True)
    with open(os.path.join(args.out_dir, f"train_profile_{args.precision}.json"), "w") as f:
        json.dump({"card": card, "batch": cfg.batch_size, "phase_ms": times,
                   "step_ms": step_ms, "perceptual_ms": perc_ms, "traced_wall_ms": wall_ms,
                   "device_busy_ms": busy_us / 1e3,
                   "kernels": [{"self_device_ms_per_step": r[0] / 1e3 / 4,
                                "count_per_step": r[1] / 4, "name": r[2]}
                               for r in rows[:80]]}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
