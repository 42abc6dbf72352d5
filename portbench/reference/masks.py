"""The contextual mask in plain PyTorch, float32.

What serving computes from a uint8 image (the 'combined' smooth mask):

  1. gray = 0.299 R + 0.587 G + 0.114 B on 0..255;
  2. spectral residual (Hou & Zhang 2007) at 64^2: the gray image resized
     to 64^2 by a linear, antialiased resize; F = FFT2; residual = log|F| -
     its 3x3 box mean (reflect-101); |IFFT2(exp(residual) F / |F|)|^2;
     Gaussian blur (sigma 3, 19 taps, reflect-101); min-max normalized;
     then resized back to H x W (linear);
  3. fine-grained centre-surround (Montabone & Soto 2010): sum over
     r = 1..6 of |g - boxmean_{2r+1}(g)| on g = gray / 255 (reflect-101),
     max-normalized;
  4. combined = max-normalize(0.6 spectral + 0.4 fine);
  5. bilateral filter, d = 9 (a disk of radius 4), sigma_color =
     sigma_space = 75, with the exact range weight, reflect-101;
  6. Gaussian blur of 31 taps (OpenCV's sigma rule: 5.0), reflect-101,
     max-normalized.

`rounding` (precision.Rounding) rounds the map at each stage's output (a
control's lower precision).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import FLOAT32


def linear_resize_matrix(src: int, dst: int) -> torch.Tensor:
    """(dst, src) weights of a linear resize with half-pixel centres, the
    triangle widened by src / dst when shrinking (antialias), each row
    normalized to sum 1."""
    if src == dst:
        return torch.eye(src, dtype=torch.float32)
    scale = dst / src
    kscale = max(1.0 / scale, 1.0)
    centre = (np.arange(dst) + 0.5) / scale - 0.5
    x = np.abs(centre[:, None] - np.arange(src)[None, :]) / kscale
    w = np.maximum(0.0, 1.0 - x)
    w = w / w.sum(axis=1, keepdims=True)
    return torch.from_numpy(w.astype(np.float32))


def gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _pad101(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    return F.pad(x[:, None], (pw, pw, ph, ph), mode="reflect")[:, 0]


def separable(x: torch.Tensor, taps) -> torch.Tensor:
    """Correlate (B, H, W) with the 1-D taps along rows, then columns,
    reflect-101 at the borders."""
    k = torch.as_tensor(np.asarray(taps, np.float32), device=x.device).to(x.dtype)
    n = k.numel()
    p = n // 2
    xp = _pad101(x, p, 0)[:, None]
    x = F.conv2d(xp, k.view(1, 1, n, 1))[:, 0]
    xp = _pad101(x, 0, p)[:, None]
    return F.conv2d(xp, k.view(1, 1, 1, n))[:, 0]


def normalize_max(x: torch.Tensor) -> torch.Tensor:
    mx = x.amax(dim=(-2, -1), keepdim=True)
    return torch.where(mx > 0, x / torch.clamp(mx, min=1e-12), x)


def normalize_minmax(x: torch.Tensor) -> torch.Tensor:
    mn = x.amin(dim=(-2, -1), keepdim=True)
    mx = x.amax(dim=(-2, -1), keepdim=True)
    return (x - mn) / torch.clamp(mx - mn, min=1e-12)


def spectral_residual(gray: torch.Tensor, size: int = 64, sigma: float = 3.0) -> torch.Tensor:
    b, h, w = gray.shape
    dev = gray.device
    rh = linear_resize_matrix(h, size).to(dev)
    rw = linear_resize_matrix(w, size).to(dev)
    small = rh @ gray @ rw.T
    f = torch.fft.fft2(small.double())
    amp = f.abs()
    log_amp = torch.log(amp + 1e-9)
    box = separable(log_amp, [1.0 / 3.0] * 3)
    r = torch.exp(log_amp - box) / torch.clamp(amp, min=1e-30)
    sal = torch.fft.ifft2(f * r).abs() ** 2
    ksize = int(2 * math.ceil(3.0 * sigma) + 1)
    sal = separable(sal.float(), gaussian_taps(ksize, sigma))
    sal = normalize_minmax(sal)
    uh = linear_resize_matrix(size, h).to(dev)
    uw = linear_resize_matrix(size, w).to(dev)
    return uh @ sal @ uw.T


def fine_grained(gray: torch.Tensor, radii=(1, 2, 3, 4, 5, 6)) -> torch.Tensor:
    g = gray / 255.0
    total = torch.zeros_like(g)
    for r in radii:
        k = 2 * r + 1
        total = total + torch.abs(g - separable(g, [1.0 / k] * k))
    return normalize_max(total)


def bilateral(x: torch.Tensor, d: int = 9, sigma_color: float = 75.0,
              sigma_space: float = 75.0) -> torch.Tensor:
    r = d // 2
    xp = _pad101(x, r, r)
    h, w = x.shape[-2:]
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy * dy + dx * dx > r * r:
                continue
            sw = math.exp(-(dy * dy + dx * dx) / (2.0 * sigma_space ** 2))
            s = xp[:, r + dy:r + dy + h, r + dx:r + dx + w]
            wgt = sw * torch.exp(-((s - x) ** 2) / (2.0 * sigma_color ** 2))
            num = num + wgt * s
            den = den + wgt
    return num / den


def contextual_mask(images_u8: torch.Tensor, scfg: dict, rounding=FLOAT32) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, H, W) float32 masks in [0, 1]. scfg: the
    configuration's saliency block (weights, radii, filter sizes)."""
    rnd = rounding.results
    x = images_u8.float()
    gray = rnd(0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2])
    spec = rnd(spectral_residual(gray, scfg["spectral_resolution"], scfg["spectral_blur_sigma"]))
    fine = rnd(fine_grained(gray, scfg["fine_grained_scales"]))
    comb = rnd(normalize_max(scfg["combined_spectral_weight"] * spec
                             + scfg["combined_fine_weight"] * fine))
    smooth = rnd(bilateral(comb, scfg["mask_bilateral_d"], scfg["mask_bilateral_sigma_color"],
                           scfg["mask_bilateral_sigma_space"]))
    k = scfg["mask_gaussian_ksize"]
    sigma = 0.3 * ((k - 1) * 0.5 - 1.0) + 0.8
    return normalize_max(rnd(separable(smooth, gaussian_taps(k, sigma))))
