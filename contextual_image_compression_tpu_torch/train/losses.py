"""Losses of the adversarial compression training, in float32.

Counterpart of `contextual_image_compression_tpu/train/losses.py`, formula
for formula. Every loss upcasts its inputs to float32. Inputs may be NCHW or
NHWC: every reduction is over all elements or over all but the batch axis.
With `LossConfig.reference_broadcast_quirk` the latent-saliency and bitrate
terms reproduce the reference's (B, 1) - (B,) broadcast, (B, B) means.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from contextual_image_compression_tpu_torch.config import LossConfig

_KERAS_EPS = 1e-7


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


def bce(labels: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on probabilities, keras semantics: clip to
    [1e-7, 1 - 1e-7], mean over all elements."""
    p = torch.clamp(_f32(probs), _KERAS_EPS, 1.0 - _KERAS_EPS)
    labels = _f32(labels)
    return -torch.mean(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((_f32(a) - _f32(b)) ** 2)


def mae(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(_f32(a) - _f32(b)))


def discriminator_loss(real_preds: torch.Tensor, fake_preds: torch.Tensor,
                       cfg: LossConfig) -> torch.Tensor:
    """0.5 * (BCE(0.9, D(real)) + BCE(0.1, D(fake))), label-smoothed."""
    real_labels = torch.full_like(real_preds, cfg.d_real_label)
    fake_labels = torch.full_like(fake_preds, cfg.d_fake_label)
    return 0.5 * (bce(real_labels, real_preds) + bce(fake_labels, fake_preds))


def adversarial_loss(fake_preds: torch.Tensor) -> torch.Tensor:
    """BCE against ones."""
    return bce(torch.ones_like(fake_preds), fake_preds)


def perceptual_loss(orig_feats: Sequence[torch.Tensor], gen_feats: Sequence[torch.Tensor],
                    layer_weights: Sequence[float], scale: float = 0.5) -> torch.Tensor:
    """sum_i w_i * MSE(zscore(orig_i), zscore(gen_i)) * scale, each z-score
    over the whole tensor with the biased standard deviation (jnp.std)."""
    total = torch.zeros((), dtype=torch.float32, device=gen_feats[0].device)
    for w, of, gf in zip(layer_weights, orig_feats, gen_feats):
        of, gf = _f32(of), _f32(gf)
        o = (of - of.mean()) / (of.std(correction=0) + 1e-8)
        g = (gf - gf.mean()) / (gf.std(correction=0) + 1e-8)
        total = total + w * torch.mean((o - g) ** 2)
    return total * scale


def latent_saliency_loss(hq_score: torch.Tensor, lq_score: torch.Tensor, masks: torch.Tensor,
                         cfg: LossConfig) -> torch.Tensor:
    """HQ score against the mean mask value, LQ score against its complement.
    hq_score, lq_score (B, 1); masks (B, 1, H, W) or (B, H, W, 1)."""
    flat_masks = torch.mean(_f32(masks), dim=(1, 2, 3))  # (B,)
    hq_score, lq_score = _f32(hq_score), _f32(lq_score)
    if not cfg.reference_broadcast_quirk:
        flat_masks = flat_masks[:, None]  # (B, 1): per-sample pairing
    loss_hq = torch.mean((hq_score - flat_masks) ** 2)
    loss_lq = torch.mean((lq_score - (1.0 - flat_masks)) ** 2)
    return loss_hq + loss_lq


def rd_loss(rd_params: torch.Tensor, target_bpp: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    """MSE(rd_params[:, 0], clip(1 - bpp / 4, 0.1, 0.9))."""
    lo, hi = cfg.rd_target_clip
    target = torch.clamp(1.0 - _f32(target_bpp) / cfg.rd_target_bpp_divisor, lo, hi)
    actual = _f32(rd_params[:, 0:1])
    return torch.mean((actual - target) ** 2)


def analytic_bpp_from_allocation(bit_allocation: torch.Tensor, base_latent_dim: int,
                                 img_hw: Tuple[int, int]) -> torch.Tensor:
    """hq = mean(bit_allocation); bpp = (hq * 2D * 32 + (1 - hq) * D * 32) / (H W).
    Returns (B,)."""
    hq_ratio = torch.mean(_f32(bit_allocation), dim=(1, 2, 3))
    hq_bits = hq_ratio * (base_latent_dim * 2) * 32.0
    lq_bits = (1.0 - hq_ratio) * base_latent_dim * 32.0
    return (hq_bits + lq_bits) / float(img_hw[0] * img_hw[1])


def bitrate_losses(bit_allocation: torch.Tensor, target_bpp: torch.Tensor, base_latent_dim: int,
                   img_hw: Tuple[int, int], cfg: LossConfig):
    """(control, underutilization penalty):
    control = mean |actual - target|,
    penalty = mean relu(target - actual) * relu(target - 1) * 2."""
    actual = analytic_bpp_from_allocation(bit_allocation, base_latent_dim, img_hw)  # (B,)
    target = _f32(target_bpp)  # (B, 1)
    if not cfg.reference_broadcast_quirk:
        actual = actual[:, None]
    control = torch.mean(torch.abs(actual - target))
    penalty = torch.mean(torch.relu(target - actual) * torch.relu(target - 1.0) * 2.0)
    return control, penalty


def combine_generator_loss(recon, l1, perceptual, adv, bitrate_control,
                           cfg: LossConfig) -> torch.Tensor:
    """Weighted sum plus the floor-offset hack max(0, floor - g) * coeff,
    which pushes g toward >= 0.5."""
    g = (cfg.recon_weight * recon
         + cfg.l1_weight * l1
         + cfg.perceptual_weight * perceptual
         + cfg.adv_weight * adv
         + cfg.bitrate_weight * bitrate_control)
    offset = torch.clamp(cfg.g_loss_floor - g, min=0.0) * cfg.g_loss_floor_coeff
    return g + offset
