"""Image quality metrics on tensors, batched over leading axes.

Counterpart of `contextual_image_compression_tpu/ops/metrics.py`: PSNR with
an explicit data range, SSIM with skimage.structural_similarity's defaults
for float images (7x7 uniform window as direct window sums, K1 0.01, K2 0.03,
sample covariance, the valid-window crop), the GAN metrics, which map
[-1, 1] to [0, 1] and average the per-RGB-channel SSIM, and the
autoencoder's metrics on uint8 images (grayscale SSIM).
"""

from __future__ import annotations

from typing import Dict

import torch

from contextual_image_compression_tpu_torch.ops.image_ops import rgb_to_gray


def mse(a: torch.Tensor, b: torch.Tensor, axes=None) -> torch.Tensor:
    d = a - b
    return torch.mean(d * d) if axes is None else torch.mean(d * d, dim=axes)


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0, axes=None) -> torch.Tensor:
    """Peak signal-to-noise ratio in dB (skimage semantics)."""
    err = mse(a.to(torch.float32), b.to(torch.float32), axes=axes)
    return 10.0 * torch.log10((data_range * data_range) / torch.clamp(err, min=1e-20))


def _uniform_filter_valid(x: torch.Tensor, win: int) -> torch.Tensor:
    """Mean over win x win windows, valid extent, on the last two axes: two
    separable direct window sums, taps added in order."""

    def along(arr, axis):
        n = arr.shape[axis] - win + 1
        out = arr.narrow(axis, 0, n)
        for i in range(1, win):
            out = out + arr.narrow(axis, i, n)
        return out

    return along(along(x, -1), -2) / float(win * win)


def ssim(
    a: torch.Tensor,
    b: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM of 2-D images on the last two axes, over the valid-window crop."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    n = win_size * win_size
    cov_norm = n / (n - 1.0)
    ux = _uniform_filter_valid(a, win_size)
    uy = _uniform_filter_valid(b, win_size)
    uxx = _uniform_filter_valid(a * a, win_size)
    uyy = _uniform_filter_valid(b * b, win_size)
    uxy = _uniform_filter_valid(a * b, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    s = s[..., pad : s.shape[-2] - pad, pad : s.shape[-1] - pad]
    return torch.mean(s, dim=(-2, -1))


def ssim_rgb_channel_mean(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Per-RGB-channel SSIM averaged. a, b: (..., H, W, 3)."""
    vals = [ssim(a[..., c], b[..., c], data_range=data_range) for c in range(a.shape[-1])]
    return torch.mean(torch.stack(vals, dim=0), dim=0)


def gan_metrics(original: torch.Tensor, compressed: torch.Tensor) -> Dict[str, torch.Tensor]:
    """PSNR / SSIM / MSE after [-1, 1] -> [0, 1]. original, compressed:
    (..., H, W, 3) in [-1, 1]."""
    o = (original + 1.0) / 2.0
    c = (compressed + 1.0) / 2.0
    return {
        "psnr": psnr(o, c, data_range=1.0, axes=(-3, -2, -1)),
        "ssim": ssim_rgb_channel_mean(o, c, data_range=1.0),
        "mse": mse(o, c, axes=(-3, -2, -1)),
    }


def estimate_compression_ratio(original_size, latent_size):
    """(compression_ratio, percentage_reduction) from byte sizes."""
    compression_ratio = original_size / latent_size
    percentage_reduction = (1.0 - latent_size / original_size) * 100.0
    return compression_ratio, percentage_reduction


def ae_metrics(original_u8: torch.Tensor, compressed_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
    """MSE on raw values, PSNR at data range 255 and SSIM of the BT.601 luma,
    per image. original_u8, compressed_u8: (..., H, W, 3) uint8."""
    o = original_u8.to(torch.float32)
    c = compressed_u8.to(torch.float32)
    return {
        "mse": mse(o, c, axes=(-3, -2, -1)),
        "psnr": psnr(o, c, data_range=255.0, axes=(-3, -2, -1)),
        "ssim": ssim(rgb_to_gray(o), rgb_to_gray(c), data_range=255.0),
    }
