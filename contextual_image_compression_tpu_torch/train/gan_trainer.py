"""The fused GAN training step of the adaptive codec.

Counterpart of `contextual_image_compression_tpu/train/gan_trainer.py`. One
step, with or without the discriminator phase:

  1. one codec forward, BatchNorm on batch statistics under bn_mode='train'
     (K2 once, K3 twice). The JAX step traces the forward twice, once for
     each phase, on the same parameters and inputs, and relies on XLA to
     share it; stop-gradient does not change values, so one forward serves
     both phases here;
  2. D phase (do_d_step): discriminator loss on the real images and on the
     detached reconstruction, one keras-Adam step of D;
  3. G/LS/RD phase: the fake predictions of the updated D, its parameters
     cut from the graph; ONE backward of g_loss + ls_loss + rd_loss, which
     the codec's detach_for_training routing splits into the reference's
     three per-tape gradients (K3b twice, through the quantizer's score
     path); keras-Adam steps of the generator, latent-saliency and RD
     groups; then the codec's BatchNorm running statistics take this
     forward's batch statistics.

The JAX step discards the BatchNorm updates of its D-phase forward and keeps
the G phase's; with one forward there is one set, kept once. Discriminator
BatchNorm runs on its running statistics (disc_bn_mode 'frozen', the
default) or on batch statistics ('train'), where the D phase keeps those of
its fake pass, as the JAX step does.

With ModelConfig.param_dtype 'bfloat16' the codec's and D's parameters,
gradients and Adam moments are bf16 (optax's order, train/optimizers.py) and
the BatchNorm statistics float32, as in the JAX trainer.

Images and masks are NCHW here; `Batch` carries them so.

On a mesh (`mesh=`, parallel/mesh.py) each rank takes its slice of the
batch (`place_batch`) and holds the state as `place` splits it
(parallel/sharding.py); every loss and metric is the global batch's
(train/losses.py with the data group), the BatchNorm statistics are the
global batch's (models/layers.py), each phase sums its gradients over the
data group before its optimizers step, and the clip takes the whole norm
of a split leaf (train/optimizers.py): the step computes JAX's SPMD step.
A mesh of one data index computes what one device computes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import functional_call

from contextual_image_compression_tpu_torch.config import TrainConfig, resolve_device
from contextual_image_compression_tpu_torch.models.adaptive import (
    GENERATOR_COMPONENTS,
    LATENT_SALIENCY_COMPONENTS,
    RD_COMPONENTS,
    AdaptiveCodec,
    CodecOutput,
)
from contextual_image_compression_tpu_torch.models.discriminator import Discriminator
from contextual_image_compression_tpu_torch.models.layers import cast_floats, commit_batch_stats
from contextual_image_compression_tpu_torch.models.vgg import VGG19Features, preprocess_caffe
from contextual_image_compression_tpu_torch.parallel import sharding
from contextual_image_compression_tpu_torch.train import losses as L
from contextual_image_compression_tpu_torch.train.optimizers import KerasAdam
from contextual_image_compression_tpu_torch.utils.profiling import annotate


class Batch(NamedTuple):
    image: torch.Tensor  # (B, 3, H, W) in [-1, 1]
    mask: torch.Tensor   # (B, 1, H, W) in [0, 1]
    bpp: torch.Tensor    # (B, 1)


@dataclasses.dataclass
class GANTrainState:
    codec: AdaptiveCodec
    disc: Discriminator
    g_opt: KerasAdam
    ls_opt: KerasAdam
    rd_opt: KerasAdam
    d_opt: KerasAdam
    step: int = 0


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _params(codec: AdaptiveCodec, names):
    return [p for n in names for p in getattr(codec, n).parameters()]


class GANStepBuilder:
    """Builds the train state and runs the step (see the module docstring)."""

    def __init__(self, cfg: TrainConfig, vgg: Optional[VGG19Features] = None,
                 bn_mode: str = "train", disc_bn_mode: Optional[str] = None, device="cuda",
                 mesh=None):
        if bn_mode not in ("train", "frozen"):
            raise ValueError(f"unknown bn_mode {bn_mode!r}")
        disc_bn_mode = disc_bn_mode or "frozen"
        if disc_bn_mode not in ("train", "frozen"):
            raise ValueError(f"unknown disc_bn_mode {disc_bn_mode!r}")
        self.cfg = cfg
        self.vgg = vgg
        self.bn_mode = bn_mode
        self.disc_bn_mode = disc_bn_mode
        self.mesh = mesh
        self.group = mesh.data_parallel_group() if mesh is not None else None
        self.device = mesh.device if mesh is not None else resolve_device(device)

    # ------------------------------------------------------------------ state
    def init_state(self, seed: int = 0) -> GANTrainState:
        """Seeded codec and discriminator on the device, fresh optimizers."""
        mcfg, cfg = self.cfg.model, self.cfg
        with torch.device(self.device):
            codec = AdaptiveCodec(mcfg)
            disc = Discriminator(mcfg.img_size, mcfg.channels, mcfg.disc_base_filters,
                                 mcfg.disc_max_filters, mcfg.disc_max_stages,
                                 mcfg.disc_dense_units, mcfg.leaky_slope,
                                 dtype=mcfg.compute_dtype())
            cast_floats(disc, mcfg.parameter_dtype(), buffers=False)  # JAX builds D with the codec's dtypes
        codec.reset_parameters(seed)
        disc.reset_parameters(torch.Generator(device=self.device).manual_seed(seed + 1))

        def adam(params, lr):
            return KerasAdam(params, lr, clipnorm=cfg.clipnorm, b1=cfg.adam_b1, b2=cfg.adam_b2,
                             eps=cfg.adam_eps)

        lr = cfg.learning_rate
        return GANTrainState(
            codec=codec,
            disc=disc,
            g_opt=adam(_params(codec, GENERATOR_COMPONENTS), lr),
            ls_opt=adam(_params(codec, LATENT_SALIENCY_COMPONENTS), lr * cfg.ls_lr_scale),
            rd_opt=adam(_params(codec, RD_COMPONENTS), lr * cfg.rd_lr_scale),
            d_opt=adam(disc.parameters(), lr),
        )

    def place(self, state: GANTrainState,
              min_shard_elems: Optional[int] = None) -> GANTrainState:
        """The state on the mesh (in place): the rule's leaves split over
        'model', parameters and Adam moments alike; without a mesh, as it is.
        `min_shard_elems`: default sharding.DEFAULT_MIN_SHARD_ELEMS."""
        if self.mesh is not None:
            sharding.shard_state(state.codec, self.mesh,
                                 (state.g_opt, state.ls_opt, state.rd_opt), min_shard_elems)
            sharding.shard_state(state.disc, self.mesh, (state.d_opt,), min_shard_elems)
        return state

    def place_batch(self, batch: Batch) -> Batch:
        """This rank's slice of a (node-local) batch."""
        return batch if self.mesh is None else sharding.shard_batch(batch, self.mesh)

    def _reduce(self, module) -> None:
        if self.mesh is not None:
            with annotate("step.allreduce"):
                sharding.reduce_gradients(module, self.mesh)

    # ------------------------------------------------------------------ phases
    def codec_forward(self, state: GANTrainState, batch: Batch) -> CodecOutput:
        """The step's one codec forward, routed for the single backward."""
        return state.codec.apply(_nhwc(batch.image), _nhwc(batch.mask), batch.bpp,
                                 train=self.bn_mode == "train", detach_for_training=True)

    def d_phase(self, state: GANTrainState, batch: Batch, out: CodecOutput) -> torch.Tensor:
        """One discriminator update; returns the detached d_loss."""
        train = self.disc_bn_mode == "train"
        state.d_opt.zero_grad()
        real_preds = state.disc(batch.image, train)
        fake_preds = state.disc(_nchw(out.blended).detach(), train)
        d_loss = L.discriminator_loss(real_preds, fake_preds, self.cfg.loss, self.group)
        d_loss.backward()
        self._reduce(state.disc)
        state.d_opt.step()
        if train:  # keep the statistics of the fake pass
            commit_batch_stats(state.disc)
        return d_loss.detach()

    def perceptual(self, images: torch.Tensor, compressed: torch.Tensor) -> torch.Tensor:
        if self.vgg is None or not self.cfg.use_perceptual:
            return torch.zeros((), dtype=torch.float32, device=images.device)
        lcfg = self.cfg.loss
        with annotate("step.perceptual"):
            with torch.no_grad():
                orig = self.vgg(preprocess_caffe(images))
            gen = self.vgg(preprocess_caffe(compressed))
            return L.perceptual_loss(orig, gen, lcfg.perceptual_layer_weights,
                                     lcfg.perceptual_scale, self.group)

    def g_backward(self, state: GANTrainState, batch: Batch,
                   out: CodecOutput) -> Dict[str, torch.Tensor]:
        """The G/LS/RD losses and one backward of their sum into the codec's
        `.grad`s; returns the detached metrics."""
        lcfg, mcfg = self.cfg.loss, self.cfg.model
        with annotate("step.losses"):
            for opt in (state.g_opt, state.ls_opt, state.rd_opt):
                opt.zero_grad()
            blended = _nchw(out.blended)
            frozen_d = {k: p.detach() for k, p in state.disc.named_parameters()}
            fake_preds = functional_call(state.disc, frozen_d,
                                         (blended, self.disc_bn_mode == "train"))

            grp = self.group
            recon = L.mse(batch.image, blended, grp)
            adv = L.adversarial_loss(fake_preds, grp)
            l1 = L.mae(batch.image, blended, grp)
            perceptual = self.perceptual(batch.image, blended)
            ls_loss_raw = L.latent_saliency_loss(out.hq_saliency_loss, out.lq_saliency_loss,
                                                 batch.mask, lcfg, grp)
            rd_loss_raw = L.rd_loss(out.rd_params, batch.bpp, lcfg, grp)
            bitrate_control, underutil = L.bitrate_losses(
                out.dynamic_threshold, batch.bpp, mcfg.base_latent_dim, mcfg.img_size, lcfg, grp)
            g_loss = L.combine_generator_loss(recon, l1, perceptual, adv, bitrate_control, lcfg)
            if lcfg.branch_recon_weight > 0.0:
                branch = (L.mse(batch.image, _nchw(out.hq_output), grp)
                          + L.mse(batch.image, _nchw(out.lq_output), grp))
                g_loss = g_loss + lcfg.branch_recon_weight * branch
            ls_loss = lcfg.ls_loss_weight * ls_loss_raw
            rd_opt_loss = (lcfg.rd_loss_weight * rd_loss_raw
                           + lcfg.rd_bitrate_weight * bitrate_control + underutil)
            metrics = {
                "g_loss": g_loss,
                "reconstruction_loss": recon,
                "gan_loss": adv,
                "l1_loss": l1,
                "perceptual_loss": perceptual,
                "latent_saliency_loss": ls_loss_raw,
                "rd_loss": rd_loss_raw,
                "bitrate_control_loss": bitrate_control,
                "actual_bpp": L.mean(L.analytic_bpp_from_allocation(
                    out.dynamic_threshold, mcfg.base_latent_dim, mcfg.img_size), grp),
            }
        with annotate("step.backward"):
            (g_loss + ls_loss + rd_opt_loss).backward()
            self._reduce(state.codec)
        return {k: v.detach() for k, v in metrics.items()}

    def g_update(self, state: GANTrainState) -> None:
        """The three codec optimizer steps, then the BatchNorm statistics of
        the step's forward."""
        for opt in (state.g_opt, state.ls_opt, state.rd_opt):
            opt.step()
        commit_batch_stats(state.codec)
        state.step += 1

    # ------------------------------------------------------------------ step
    def train_step(self, state: GANTrainState, batch: Batch,
                   do_d_step: bool) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        """One training step, updating `state` in place. Metrics are 0-dim
        tensors on the device."""
        out = self.codec_forward(state, batch)
        metrics: Dict[str, torch.Tensor] = {}
        if do_d_step:
            metrics["d_loss"] = self.d_phase(state, batch, out)
        metrics.update(self.g_backward(state, batch, out))
        self.g_update(state)
        return state, metrics
