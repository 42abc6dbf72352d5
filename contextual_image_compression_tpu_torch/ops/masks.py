"""Saliency masks: adaptive thresholds, the smooth and binary masks, and the
contextual mask of a batch.

Counterpart of `contextual_image_compression_tpu/ops/masks.py`:

  * adaptive threshold = min(Otsu(saliency * 255), the first 50-bin
    histogram bin whose normalized cumulative sum exceeds the 70th
    percentile), clamped to [0.05, 0.5];
  * create_saliency_mask(smooth=True), the training masks: bilateral
    (9, 75, 75) -> Gaussian 31 -> max-normalize of the map, through kernel
    K4 (ops/fused_mask.py); the threshold is not consulted;
  * create_saliency_mask(smooth=False): the binary mask saliency > threshold;
  * compute_contextual_mask: 'combined' with the smooth mask runs kernel K1
    on gray255 and the 64^2 spectral map, in float32 or, with
    mask_engine_dtype 'bfloat16', on K1's bf16 route; every other method,
    and the binary mask, runs compute_saliency_map -> create_saliency_mask,
    which never read the engine dtype (nor does the JAX package there);
  * mask_use_pallas=False: every method and both mask kinds run
    compute_saliency_map -> create_saliency_mask, and the smooth mask is
    JAX's off-TPU formula, image_ops' bilateral filter (Taylor range weight
    of a [0, 1] map) -> Gaussian 31 -> normalize_max in plain PyTorch, so
    neither K1 nor K4 launches.

The thresholds are discrete, so they reproduce the JAX package's float32
arithmetic step by step: the same bin-index expression (truncation, then
clip), Otsu's uint8 truncation, prefix sums in XLA's order
(image_ops.prefix_sum), the -inf guard on empty classes and argmax's
first-index rule.
"""

from __future__ import annotations

import torch

from contextual_image_compression_tpu_torch.config import SaliencyConfig, torch_dtype
from contextual_image_compression_tpu_torch.ops import image_ops as iops
from contextual_image_compression_tpu_torch.ops import saliency as saliency_ops
from contextual_image_compression_tpu_torch.ops.fused_mask import contextual_mask, smooth_mask


def _histogram_fixed_bins(x: torch.Tensor, nbins: int, lo: float, hi: float) -> torch.Tensor:
    """Per-image float32 histogram over the last two axes: (..., H, W) ->
    (..., nbins), bin = clip(int((x - lo) / (hi - lo) * nbins), 0, nbins - 1)."""
    scaled = iops.true_div(x - lo, hi - lo) * nbins
    idx = torch.clamp(scaled.to(torch.int32), 0, nbins - 1).to(torch.int64)
    lead = idx.shape[:-2]
    flat = idx.reshape(-1, idx.shape[-2] * idx.shape[-1])
    rows = torch.arange(flat.shape[0], device=x.device)[:, None] * nbins
    hist = torch.bincount((flat + rows).reshape(-1), minlength=flat.shape[0] * nbins)
    return hist.reshape(tuple(lead) + (nbins,)).to(torch.float32)


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis."""
    mx = torch.amax(x, dim=-1, keepdim=True)
    n = x.shape[-1]
    pos = torch.arange(n, device=x.device).expand_as(x)
    return torch.where(x == mx, pos, torch.full_like(pos, n)).amin(dim=-1)


def otsu_threshold(x: torch.Tensor) -> torch.Tensor:
    """Otsu's threshold of [0, 1] maps on the uint8-quantized map
    (cv2.threshold THRESH_OTSU), back in [0, 1]. x: (..., H, W) -> (...)."""
    u8 = torch.clamp(x * 255.0, 0, 255).to(torch.uint8).to(torch.float32)
    hist = _histogram_fixed_bins(iops.true_div(u8, 255.0), 256, 0.0, 1.0 + 1e-7)
    levels = torch.arange(256, dtype=torch.float32, device=x.device)
    total = torch.sum(hist, dim=-1, keepdim=True)
    p = hist / torch.clamp(total, min=1.0)
    omega0 = iops.prefix_sum(p)
    mu_t = iops.prefix_sum(p * levels)
    mu_total = mu_t[..., -1:]
    omega1 = 1.0 - omega0
    mu0 = mu_t / torch.clamp(omega0, min=1e-12)
    mu1 = (mu_total - mu_t) / torch.clamp(omega1, min=1e-12)
    dmu = mu0 - mu1
    sigma_b = omega0 * omega1 * (dmu * dmu)
    valid = (omega0 > 1e-12) & (omega1 > 1e-12)
    sigma_b = torch.where(valid, sigma_b, torch.full_like(sigma_b, -float("inf")))
    return iops.true_div(_first_argmax(sigma_b).to(torch.float32), 255.0)


def percentile_threshold(x: torch.Tensor, percentile: float = 0.7, nbins: int = 50) -> torch.Tensor:
    """Left edge of the first `nbins`-bin histogram bin whose normalized
    cumulative sum exceeds `percentile` (bin 0 if none does)."""
    hist = _histogram_fixed_bins(x, nbins, 0.0, 1.0)
    cumsum = iops.prefix_sum(hist)
    cumsum = cumsum / torch.clamp(cumsum[..., -1:], min=1.0)
    first = _first_argmax((cumsum > percentile).to(torch.uint8))
    return iops.true_div(first.to(torch.float32), float(nbins))


def adaptive_threshold(x: torch.Tensor, config: SaliencyConfig | None = None) -> torch.Tensor:
    """min(Otsu, percentile) clamped to [mask_threshold_min, mask_threshold_max]."""
    cfg = config or SaliencyConfig()
    t = torch.minimum(otsu_threshold(x), percentile_threshold(x, cfg.mask_percentile))
    return torch.clamp(t, cfg.mask_threshold_min, cfg.mask_threshold_max)


def create_saliency_mask(
    saliency_map: torch.Tensor,
    threshold=None,
    smooth: bool = True,
    config: SaliencyConfig | None = None,
) -> torch.Tensor:
    """smooth=True: the continuous mask max-normalize(Gaussian31(bilateral(
    saliency))) through K4 on the card (with mask_use_pallas=False, by
    image_ops); the threshold is not consulted. smooth=False: the binary
    mask saliency > threshold, with the adaptive threshold when None.
    saliency_map: (..., H, W) float32 in [0, 1]."""
    cfg = config or SaliencyConfig()
    if smooth:
        if not cfg.mask_use_pallas:
            mask = iops.bilateral_filter(
                saliency_map, d=cfg.mask_bilateral_d, sigma_color=cfg.mask_bilateral_sigma_color,
                sigma_space=cfg.mask_bilateral_sigma_space, unit_range=True)
            return iops.normalize_max(iops.gaussian_blur(mask, cfg.mask_gaussian_ksize, 0.0))
        return smooth_mask(
            saliency_map.contiguous(),
            d=cfg.mask_bilateral_d,
            sigma_color=cfg.mask_bilateral_sigma_color,
            sigma_space=cfg.mask_bilateral_sigma_space,
            gauss_ksize=cfg.mask_gaussian_ksize,
        )
    if threshold is None:
        threshold = adaptive_threshold(saliency_map, cfg)[..., None, None]
    return (saliency_map > threshold).to(torch.float32)


def _check_config(cfg: SaliencyConfig) -> None:
    if cfg.mask_engine_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"mask_engine_dtype {cfg.mask_engine_dtype!r}: 'float32' or 'bfloat16'")


def compute_contextual_mask(
    images: torch.Tensor, config: SaliencyConfig | None = None
) -> torch.Tensor:
    """images: (B, H, W, 3) uint8, or (B, H, W, 3) float in [-1, 1] (a single
    image without the batch axis also works). Returns (B, H, W) float32 masks
    in [0, 1]: through K1 for the 'combined' smooth mask (in the
    mask_engine_dtype), through compute_saliency_map and K4 for the other
    methods' smooth masks; with mask_use_pallas=False through
    compute_saliency_map and image_ops for every method."""
    cfg = config or SaliencyConfig()
    _check_config(cfg)
    if images.dtype == torch.uint8:
        gray255 = iops.rgb_to_gray(images.to(torch.float32))
    else:
        gray255 = saliency_ops._as_gray(images)
    if cfg.method != "combined" or not cfg.mask_smooth or not cfg.mask_use_pallas:
        sal = saliency_ops.compute_saliency_map(gray255, cfg.method, cfg)
        return create_saliency_mask(sal, smooth=cfg.mask_smooth, config=cfg)
    batched = gray255.ndim == 3
    if not batched:
        gray255 = gray255[None]
    gray255 = gray255.contiguous()
    spec = saliency_ops.spectral_residual_small(
        gray255, cfg.spectral_resolution, cfg.spectral_blur_sigma, cfg.spectral_dft_matmul
    ).contiguous()
    out = contextual_mask(
        gray255, spec,
        scales=cfg.fine_grained_scales,
        spectral_weight=cfg.combined_spectral_weight,
        fine_weight=cfg.combined_fine_weight,
        d=cfg.mask_bilateral_d,
        sigma_color=cfg.mask_bilateral_sigma_color,
        sigma_space=cfg.mask_bilateral_sigma_space,
        gauss_ksize=cfg.mask_gaussian_ksize,
        compute_dtype=torch_dtype(cfg.mask_engine_dtype),
    )
    return out if batched else out[0]


def enhance_saliency_map(saliency_map: torch.Tensor) -> torch.Tensor:
    """Multi-scale enhancement: exact bilateral (9, 75, 75) -> 0.5 / 0.3 / 0.2
    mix of Gaussian 3 / 9 / 15 -> power 0.8 -> clip to [0, 1]. The JAX
    package keeps it for parity with a reference function nothing calls."""
    filtered = iops.bilateral_filter(saliency_map, 9, 75.0, 75.0)
    enhanced = torch.zeros_like(saliency_map)
    for w, k in zip((0.5, 0.3, 0.2), (3, 9, 15)):
        enhanced = enhanced + w * iops.gaussian_blur(filtered, k, 0.0)
    enhanced = torch.pow(torch.clamp(enhanced, min=0.0), 0.8)
    return torch.clamp(enhanced, 0.0, 1.0)
