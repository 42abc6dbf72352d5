"""The GAN step's discriminator phase on one GPU: its CUDA-event time over 12
steps with D, beside the step's host-clock time, then its kernels under
torch.profiler (device time a call, the traced wall a call).

    python3 scripts/torch_d_phase_times.py mixed float32 mixed

Each argument is a precision ('float32', or 'mixed' for
ModelConfig(dtype="bfloat16", param_dtype="float32")) run in turn in this
process at TrainConfig() (B = 16, 256^2, random VGG19, TF32 off), after two
warm-up steps. A D phase whose CUDA-event time far exceeds its kernels'
device time waits on the host's launches. It needs a CUDA device and exits
1 without one.
"""

import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def d_phase_times(precision, dev):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from contextual_image_compression_tpu_torch.config import ModelConfig, TrainConfig
    from contextual_image_compression_tpu_torch.data.images import synthetic_images
    from contextual_image_compression_tpu_torch.data.pipeline import (
        CompressionDataset, prepare_masks)
    from contextual_image_compression_tpu_torch.train.loop import GANTrainer

    ckpt_dir = tempfile.TemporaryDirectory()  # the trainer's store makes it; nothing is saved
    mcfg = ModelConfig(dtype="bfloat16" if precision == "mixed" else "float32",
                       param_dtype="float32")
    cfg = TrainConfig(model=mcfg, vgg_weights_path="random:0", model_dir=ckpt_dir.name)
    imgs = synthetic_images(16, cfg.model.img_size, seed=0)
    ds = CompressionDataset(imgs, prepare_masks(imgs, cfg.saliency, device=dev), batch_size=16,
                            device_resident=True, device=dev)
    trainer = GANTrainer(cfg, device=dev, log_fn=lambda s: None)
    state = trainer.init_state(resume=False)
    b = trainer.builder
    batch = next(ds.epoch())
    for i in range(2):  # warm-up: cuDNN heuristics, allocator
        b.train_step(state, batch, i == 0)
    torch.cuda.synchronize()
    d_ms, step_ms = [], []
    for _ in range(12):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        t0 = time.perf_counter()
        out = b.codec_forward(state, batch)
        ev[0].record()
        b.d_phase(state, batch, out)
        ev[1].record()
        b.g_backward(state, batch, out)
        b.g_update(state)
        ev[2].record()
        ev[2].synchronize()
        d_ms.append(ev[0].elapsed_time(ev[1]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    print(precision, "D phase ms (CUDA events)", [round(x, 2) for x in d_ms], flush=True)
    print(precision, "step ms with D (host clock)", [round(x, 1) for x in step_ms], flush=True)
    out = b.codec_forward(state, batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            b.d_phase(state, batch, out)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 3
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("Optimizer."):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        if us > 0:
            rows.append((us / 3e3, ev.count / 3, ev.key[:100]))
    rows.sort(reverse=True)
    print(f"{precision} D phase traced: wall {wall:.2f} ms a call, device "
          f"{sum(r[0] for r in rows):.2f} ms a call in {sum(r[1] for r in rows):.0f} kernels",
          flush=True)
    for ms, count, name in rows[:12]:
        print(f"   {ms:8.3f} ms x{count:.0f} {name}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from contextual_image_compression_tpu_torch.measure import card_name_and_power

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_name_and_power(), flush=True)
    for precision in sys.argv[1:] or ["mixed", "float32"]:
        d_phase_times(precision, torch.device("cuda"))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
