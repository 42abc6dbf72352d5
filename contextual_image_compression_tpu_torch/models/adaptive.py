"""The adaptive (saliency-guided, rate-controlled) dual-branch codec.

Counterpart of `contextual_image_compression_tpu/models/adaptive.py`, for
inference (`apply(train=False)`) and training (`apply(train=True,
detach_for_training=True)`) in float32, in mixed precision (ModelConfig
dtype 'bfloat16' with param_dtype 'float32': bfloat16 activations, the
parameters float32 and cast at use) or with bfloat16 parameters
(param_dtype 'bfloat16'; BatchNorm statistics stay float32, as in flax):

    hq_latent, hq_skips = hq_encoder(img)        # with self-attention (K2; jnp formula
                                                 # with attention_use_pallas=False)
    lq_latent, lq_skips = lq_encoder(img)
    s_hq, s_lq = latent saliency MLPs
    rd_params = rd_optimizer(mask, bpp)          # reported, not applied
    b = clip(bpp / 5, 0, 1); thr = 0.9 - 0.85 b; qs = schedule(b)
    dyn_thr = sigmoid(20 * (mask^0.7 - thr))     # or the hard threshold
    zq = quantize(latent, s, qs)                 # K3 (backward K3b), both branches;
                                                 # jnp formula with quantizer.use_pallas=False
    out = hq_gen(zq_hq, skips) * dyn_thr + lq_gen(zq_lq, skips) * (1 - dyn_thr)

The components are submodules named like the JAX codec's components, so a
converted state dict (convert.py) loads with `load_state_dict`. Images and
masks cross `apply` in NHWC, latents as (B, D); inside, everything is NCHW.
Gradients flow through `apply`; callers that only infer wrap it in
`torch.no_grad()`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn
from torch.func import functional_call

from contextual_image_compression_tpu_torch.config import ModelConfig
from contextual_image_compression_tpu_torch.models.encoder import Encoder
from contextual_image_compression_tpu_torch.models.generator import Generator
from contextual_image_compression_tpu_torch.models.latent_saliency import LatentSaliency
from contextual_image_compression_tpu_torch.models.layers import cast_floats, const
from contextual_image_compression_tpu_torch.models.rd_optimizer import RDOptimizer
from contextual_image_compression_tpu_torch.ops.quantize import adaptive_quantize
from contextual_image_compression_tpu_torch.ops.saliency import (
    _full_fp32_matmul,
    resize_op_matrix,
)
from contextual_image_compression_tpu_torch.utils.profiling import annotate

# The three disjoint parameter groups of GAN training, one optimizer each.
GENERATOR_COMPONENTS = ("hq_encoder", "hq_generator", "lq_encoder", "lq_generator")
LATENT_SALIENCY_COMPONENTS = ("latent_saliency_hq", "latent_saliency_lq")
RD_COMPONENTS = ("rd_optimizer",)
ALL_CODEC_COMPONENTS = GENERATOR_COMPONENTS + LATENT_SALIENCY_COMPONENTS + RD_COMPONENTS


class CodecOutput(NamedTuple):
    blended: torch.Tensor            # (B, H, W, C) in [-1, 1]
    hq_latent_q: torch.Tensor        # (B, 2D)
    lq_latent_q: torch.Tensor        # (B, D)
    rd_params: torch.Tensor          # (B, 3)
    dynamic_threshold: torch.Tensor  # (B, H, W, 1)
    hq_latent: torch.Tensor
    lq_latent: torch.Tensor
    hq_saliency_quant: torch.Tensor  # (B, 1); LS params detached in training
    lq_saliency_quant: torch.Tensor
    hq_saliency_loss: torch.Tensor   # (B, 1); latent detached in training
    lq_saliency_loss: torch.Tensor
    hq_output: torch.Tensor          # (B, H, W, C)
    lq_output: torch.Tensor
    quant_strength: torch.Tensor     # (B, 1)
    hq_lq_threshold: torch.Tensor    # (B, 1)
    overall_compression: torch.Tensor  # (B, 1)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _with_detached_params(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """module(x) with its parameters cut from the graph: gradients reach x
    but not the parameters (JAX: apply on stop_gradient(params))."""
    params = {k: p.detach() for k, p in module.named_parameters()}
    return functional_call(module, params, (x,))


class AdaptiveCodec(nn.Module):
    def __init__(self, cfg: ModelConfig = ModelConfig()):
        super().__init__()
        self.cfg = cfg
        h, w = cfg.img_size
        enc = dict(img_size=cfg.img_size, in_channels=cfg.channels,
                   channels=cfg.encoder_channels, leaky_slope=cfg.leaky_slope,
                   dense_w8=cfg.dense_w8, dense_int8=cfg.dense_int8)
        self.hq_encoder = Encoder(cfg.hq_latent_dim, add_attention=cfg.hq_attention,
                                  attention_use_pallas=cfg.attention_use_pallas, **enc)
        self.lq_encoder = Encoder(cfg.base_latent_dim, add_attention=False, **enc)
        if cfg.generator_base_hw * 16 != h or h != w:
            raise ValueError("the generator upsamples base_hw by 16 to a square img_size")
        gen = dict(out_channels=cfg.channels, channels=cfg.generator_channels,
                   skip_channels=tuple(cfg.encoder_channels[:3]),
                   base_hw=cfg.generator_base_hw, base_ch=cfg.generator_base_ch,
                   leaky_slope=cfg.leaky_slope, packed_tail=cfg.generator_packed_tail,
                   packed_tail_int8=cfg.packed_tail_int8, dense_w8=cfg.dense_w8,
                   dense_int8=cfg.dense_int8, polyphase=cfg.generator_polyphase)
        self.hq_generator = Generator(cfg.hq_latent_dim, **gen)
        self.lq_generator = Generator(cfg.base_latent_dim, **gen)
        self.latent_saliency_hq = LatentSaliency(cfg.hq_latent_dim)
        self.latent_saliency_lq = LatentSaliency(cfg.base_latent_dim)
        self.rd_optimizer = RDOptimizer(cfg.bpp_norm_divisor, cfg.leaky_slope)
        cast_floats(self, cfg.parameter_dtype(), buffers=False)

    def reset_parameters(self, seed: int = 0) -> None:
        """Keras-style init (glorot-uniform kernels, zero biases, BN identity,
        attention gamma 0) from one seeded generator on the parameters' device,
        drawn in float32 and rounded to the parameters' dtype."""
        dev = next(self.parameters()).device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        for name in ALL_CODEC_COMPONENTS:
            getattr(self, name).reset_parameters(gen)

    # ---------------------------------------------------------------- schedule
    def rd_schedule(self, target_bpp: torch.Tensor):
        """(overall, threshold, quant_strength), each (B, 1), in target_bpp's dtype."""
        cfg = self.cfg
        dt, dev = target_bpp.dtype, target_bpp.device

        def c(v):
            return const(v, dt, dev)

        b = torch.clamp(target_bpp / c(cfg.bpp_norm_divisor), 0.0, 1.0)
        overall = c(1.0) - c(cfg.overall_compression_slope) * b
        threshold = c(cfg.hq_lq_threshold_base) - c(cfg.hq_lq_threshold_slope) * b
        if cfg.rate_mode == "fixed":
            quant = torch.clamp(c(cfg.fixed_quant_base) + c(cfg.fixed_quant_slope) * b,
                                0.0, cfg.fixed_quant_max)
        elif cfg.rate_mode == "reference":
            quant = c(cfg.quant_strength_base) - c(cfg.quant_strength_slope) * b
        else:
            raise ValueError(f"unknown rate_mode {cfg.rate_mode!r}")
        return overall, threshold, quant

    def dynamic_threshold(self, mask: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
        """Per-pixel HQ/LQ map. mask (B, 1, H, W), threshold (B, 1) -> (B, 1, H, W)."""
        cfg = self.cfg
        dt, dev = mask.dtype, mask.device
        enhanced = torch.pow(torch.clamp(mask, min=0.0), const(cfg.saliency_gamma, dt, dev))
        thr = threshold[:, :, None, None]
        if cfg.threshold_mode == "hard":
            return (enhanced > thr).to(dt)
        return torch.sigmoid((enhanced - thr) * const(cfg.threshold_sharpness, dt, dev))

    # ------------------------------------------------------------------ skips
    def _zero_skips(self, batch: int, dtype, device):
        h, w = self.cfg.img_size
        ch = self.cfg.encoder_channels
        return tuple(
            torch.zeros((batch, ch[i - 1], h >> i, w >> i), dtype=dtype, device=device)
            for i in (1, 2, 3)
        )

    def _mask_skips(self, mask: torch.Tensor, dyn_thr: torch.Tensor, dtype):
        """skip_mode='mask': channel 0 the mask, channel 1 the blend map, both
        resized (linear, antialiased) to each skip's size; other channels zero."""
        h, w = self.cfg.img_size
        ch = self.cfg.encoder_channels
        dev = mask.device
        planes = torch.cat([mask.float(), dyn_thr.float()], dim=1)  # (B, 2, H, W)
        skips = []
        for i in (1, 2, 3):
            hh, ww = h >> i, w >> i
            rh = torch.from_numpy(resize_op_matrix(h, hh)).to(dev)
            rw = torch.from_numpy(resize_op_matrix(w, ww)).to(dev)
            with _full_fp32_matmul(dev):
                p = (rh @ planes) @ rw.T
            zeros = torch.zeros((mask.shape[0], ch[i - 1] - 2, hh, ww), dtype=dtype, device=dev)
            skips.append(torch.cat([p.to(dtype), zeros], dim=1))
        return tuple(skips)

    # ----------------------------------------------------------------- decode
    def decode_latents(self, hq_latent_q: torch.Tensor, lq_latent_q: torch.Tensor,
                       mask: torch.Tensor, target_bpp: torch.Tensor) -> torch.Tensor:
        """Generator-only decode of the storable codec: quantized latents
        (B, 2D) and (B, D), the mask (B, H, W, 1) and target_bpp (B, 1) ->
        the blended image (B, H, W, C), with no encoder in the loop. Skips
        are zero, or the mask planes in skip_mode 'mask'; with 'encoder'
        skips it reconstructs from what the latents carry alone."""
        ct = self.cfg.compute_dtype()
        zq_hq, zq_lq = hq_latent_q.to(ct), lq_latent_q.to(ct)
        m = mask.to(ct).permute(0, 3, 1, 2)
        _, threshold, _ = self.rd_schedule(target_bpp.to(ct))
        dyn_thr = self.dynamic_threshold(m, threshold)
        if self.cfg.skip_mode == "mask":
            skips = self._mask_skips(m, dyn_thr, ct)
        else:
            skips = self._zero_skips(zq_hq.shape[0], ct, m.device)
        hq_out = self.hq_generator(zq_hq, skips)
        lq_out = self.lq_generator(zq_lq, skips)
        return _nhwc(hq_out * dyn_thr + lq_out * (const(1.0, ct, m.device) - dyn_thr))

    # ------------------------------------------------------------------ apply
    def apply(self, img: torch.Tensor, mask: torch.Tensor, target_bpp: torch.Tensor,
              train: bool = False, detach_for_training: bool = False) -> CodecOutput:
        """img (B, H, W, C) in [-1, 1], mask (B, H, W, 1), target_bpp (B, 1).

        train=True runs BatchNorm on batch statistics; they wait in each
        layer until `layers.commit_batch_stats(codec)`. detach_for_training=True routes
        one backward of g + ls + rd losses into the three parameter groups
        as the reference's three gradient tapes would: the quantizer's score
        comes from the latent-saliency MLPs with detached parameters, the
        LS-loss score from the detached latent."""
        cfg = self.cfg
        ct = cfg.compute_dtype()
        with annotate("codec.encode"):
            x = img.to(ct).permute(0, 3, 1, 2)
            m = mask.to(ct).permute(0, 3, 1, 2)
            target_bpp = target_bpp.to(ct)
            hq_latent, hq_skips = self.hq_encoder(x, train)
            lq_latent, lq_skips = self.lq_encoder(x, train)

        with annotate("codec.plan"):
            overall, threshold, quant_strength = self.rd_schedule(target_bpp)
            dyn_thr = self.dynamic_threshold(m, threshold)
            if cfg.skip_mode == "zero":
                hq_skips = lq_skips = self._zero_skips(x.shape[0], ct, x.device)
            elif cfg.skip_mode == "mask":
                hq_skips = lq_skips = self._mask_skips(m, dyn_thr, ct)
            if detach_for_training:
                s_hq = _with_detached_params(self.latent_saliency_hq, hq_latent)
                s_lq = _with_detached_params(self.latent_saliency_lq, lq_latent)
                s_hq_loss = self.latent_saliency_hq(hq_latent.detach())
                s_lq_loss = self.latent_saliency_lq(lq_latent.detach())
            else:
                s_hq = self.latent_saliency_hq(hq_latent)
                s_lq = self.latent_saliency_lq(lq_latent)
                s_hq_loss, s_lq_loss = s_hq, s_lq
            rd_params = self.rd_optimizer(m, target_bpp)

        with annotate("codec.quantize"):
            if cfg.quant_bypass:
                zq_hq, zq_lq = hq_latent, lq_latent
            else:
                qcfg = cfg.resolved_quantizer()
                zq_hq = adaptive_quantize(hq_latent, s_hq, quant_strength, qcfg)
                zq_lq = adaptive_quantize(lq_latent, s_lq, quant_strength, qcfg)

        with annotate("codec.generate"):
            hq_out = self.hq_generator(zq_hq, hq_skips, train)
            lq_out = self.lq_generator(zq_lq, lq_skips, train)
            blended = hq_out * dyn_thr + lq_out * (const(1.0, ct, x.device) - dyn_thr)
        return CodecOutput(
            blended=_nhwc(blended),
            hq_latent_q=zq_hq,
            lq_latent_q=zq_lq,
            rd_params=rd_params,
            dynamic_threshold=_nhwc(dyn_thr),
            hq_latent=hq_latent,
            lq_latent=lq_latent,
            hq_saliency_quant=s_hq,
            lq_saliency_quant=s_lq,
            hq_saliency_loss=s_hq_loss,
            lq_saliency_loss=s_lq_loss,
            hq_output=_nhwc(hq_out),
            lq_output=_nhwc(lq_out),
            quant_strength=quant_strength,
            hq_lq_threshold=threshold,
            overall_compression=overall,
        )
