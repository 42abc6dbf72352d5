"""The GAN training loop.

Counterpart of `GANTrainer` in `contextual_image_compression_tpu/train/
loop.py`: the discriminator trains every `d_every_n_steps`-th step and the
codec every step, the epoch's metric sums stay on the device until the
epoch's one host read, and each epoch appends its means to `history` and logs
a line. `rate_control_probe` is d(mean HQ ratio) / d(target bpp).

Not in this slice of the port, and refused rather than skipped: checkpoint
save and resume (`init_state(resume=True)`; `fit` writes no checkpoint),
per-epoch artifacts and plots (`fit(artifacts=True)`, a probe `save_path`),
meshes, and the NaN guard.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import torch

from contextual_image_compression_tpu_torch.config import TrainConfig, resolve_device
from contextual_image_compression_tpu_torch.data.pipeline import CompressionDataset
from contextual_image_compression_tpu_torch.models.vgg import load_vgg19_features
from contextual_image_compression_tpu_torch.train.gan_trainer import (
    Batch,
    GANStepBuilder,
    GANTrainState,
)

HISTORY_KEYS = (
    "d_loss",
    "g_loss",
    "reconstruction_loss",
    "gan_loss",
    "perceptual_loss",
    "l1_loss",
    "latent_saliency_loss",
    "rd_loss",
)

_LATER = "checkpoints and training artifacts come with a later slice of the port"


class GANTrainer:
    """Owns the step builder, the train state and the loss history."""

    def __init__(self, cfg: TrainConfig, bn_mode: str = "train",
                 disc_bn_mode: Optional[str] = None,
                 log_fn: Callable[[str], None] = print, device="cuda"):
        self.cfg = cfg
        self.log = log_fn
        self.device = resolve_device(device)
        vgg = load_vgg19_features(cfg.vgg_weights_path, self.device) if cfg.use_perceptual else None
        if vgg is not None:
            self.log("Perceptual loss: VGG19 weights loaded")
        elif cfg.use_perceptual:
            self.log("WARNING: no VGG19 weights available -- perceptual loss disabled")
        self.builder = GANStepBuilder(cfg, vgg=vgg, bn_mode=bn_mode,
                                      disc_bn_mode=disc_bn_mode, device=self.device)
        self.history: Dict[str, List[float]] = {k: [] for k in HISTORY_KEYS}
        self.state: Optional[GANTrainState] = None

    def init_state(self, resume: bool = True) -> GANTrainState:
        """A fresh seeded state (cfg.seed). resume=True needs the checkpoint
        store, which the port does not have yet, so it raises."""
        if resume:
            raise NotImplementedError(f"resume: {_LATER}; pass resume=False")
        self.state = self.builder.init_state(self.cfg.seed)
        return self.state

    def fit(self, dataset: CompressionDataset, epochs: Optional[int] = None,
            steps_per_epoch: Optional[int] = None, artifacts: bool = True) -> Dict[str, List[float]]:
        """Train `epochs` epochs of `steps_per_epoch` steps (the dataset's
        epoch length by default), restarting the dataset's epoch iterator
        when it runs out. artifacts=True raises: see the module docstring."""
        if artifacts:
            raise NotImplementedError(f"artifacts=True: {_LATER}; pass artifacts=False")
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.epochs
        steps_per_epoch = steps_per_epoch or dataset.steps_per_epoch
        if self.state is None:
            self.init_state(resume=False)
        for _ in range(epochs):
            t0 = time.time()
            sums: Dict[str, torch.Tensor] = {}
            counts = {k: 0 for k in HISTORY_KEYS}
            step_iter = dataset.epoch()
            n_images = 0
            for step in range(steps_per_epoch):
                try:
                    batch = next(step_iter)
                except StopIteration:
                    step_iter = dataset.epoch()
                    batch = next(step_iter)
                do_d = step % cfg.d_every_n_steps == 0
                self.state, metrics = self.builder.train_step(self.state, batch, do_d)
                n_images += int(batch.image.shape[0])
                for k, v in metrics.items():
                    if k in counts:
                        sums[k] = v if k not in sums else sums[k] + v
                        counts[k] += 1
            means = {k: (sums[k].item() / counts[k] if counts[k] else float("nan"))
                     for k in HISTORY_KEYS}
            for k in HISTORY_KEYS:
                self.history[k].append(means[k])
            epoch_label = len(self.history["g_loss"])
            dt = time.time() - t0
            ips = n_images / dt if dt > 0 else float("nan")
            self.log(
                f"Epoch {epoch_label}: "
                f"D {means['d_loss']:.4f}, G {means['g_loss']:.4f}, "
                f"Recon {means['reconstruction_loss']:.4f}, RD {means['rd_loss']:.4f}, "
                f"LS {means['latent_saliency_loss']:.4f} "
                f"({dt:.2f}s, {ips:.1f} img/s)"
            )
        return self.history

    def rate_control_probe(self, sample_batch: Batch, save_path: Optional[str] = None):
        """[(bpp, mean HQ ratio, d ratio / d bpp)] for bpp in (0.1, 1.0, 2.0)
        on the first sample, codec in eval mode. The ratio depends on the
        bpp through the blend threshold only, so the backward reaches
        neither the quantizer (K3b) nor the generators, in either package."""
        if save_path:
            raise NotImplementedError(f"save_path (the bit-allocation plot): {_LATER}")
        codec = self.state.codec
        img = sample_batch.image[:1].permute(0, 2, 3, 1)
        mask = sample_batch.mask[:1].permute(0, 2, 3, 1)
        results = []
        for bpp in (0.1, 1.0, 2.0):
            b = torch.tensor(bpp, dtype=torch.float32, device=img.device, requires_grad=True)
            out = codec.apply(img, mask, b.reshape(1, 1).expand(img.shape[0], 1), train=False)
            ratio = torch.mean(out.dynamic_threshold)
            (grad,) = torch.autograd.grad(ratio, b)
            results.append((bpp, ratio.item(), grad.item()))
        self.log("Rate Control Gradient Test:")
        for bpp, ratio, grad in results:
            self.log(f"  BPP: {bpp}, HQ Ratio: {ratio:.4f}, Gradient: {grad:.6f}")
        return results
