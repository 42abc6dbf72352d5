"""Static saliency: spectral residual (Hou & Zhang 2007), fine-grained
center-surround (Montabone & Soto 2010) and their 0.6 / 0.4 combination.

Counterpart of `contextual_image_compression_tpu/ops/saliency.py`.
`spectral_residual_small` is the map at its native 64^2 resolution: gray -> antialiased
linear resize to 64^2 -> DFT -> log-amplitude minus its 3x3 box mean -> inverse
DFT with the original phase -> squared magnitude -> Gaussian blur -> min-max
normalize. Every linear map is an explicit operator matrix built the way the
JAX package builds it (jax.image.resize's weights, the f64 mod-n DFT, the
reflect-101 box and blur), and the products run in full float32: with
reduced-precision passes the log-amplitude cancellation moves the final mask
by up to 3.5e-2. `SaliencyConfig(spectral_dft_matmul=False)` takes the FFT
core instead (`torch.fft`; XLA's CPU FFT, torch's CPU FFT and cuFFT round
differently, so it agrees with the JAX FFT core to float32 noise, not bit
for bit).

This is plain PyTorch on purpose: it is a handful of (B*64, 64) x (64, 64)
products per image.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from contextual_image_compression_tpu_torch.config import SaliencyConfig
from contextual_image_compression_tpu_torch.ops import image_ops as iops


def _as_gray(image: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) in [-1, 1] -> gray in [0, 255]; (..., H, W) passes as f32."""
    if image.ndim >= 3 and image.shape[-1] == 3:
        img_255 = (image + 1.0) * 127.5
        return iops.rgb_to_gray(img_255)
    return image.to(torch.float32)


@functools.lru_cache(maxsize=32)
def resize_op_matrix(src: int, dst: int) -> np.ndarray:
    """The (dst, src) float32 matrix of jax.image.resize(..., 'linear') along
    one axis: a triangle kernel, widened by src/dst when downsampling
    (antialias), columns normalized, samples outside the input zeroed.
    Evaluated in float32 in the same order as jax's compute_weight_mat."""
    if src == dst:
        return np.eye(src, dtype=np.float32)
    f32 = np.float32
    scale = dst / src
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(dst, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(src, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(weights, axis=0, keepdims=True, dtype=f32)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    ).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= src - 0.5)
    weights = np.where(inside[None, :], weights, f32(0.0)).astype(f32)
    return np.ascontiguousarray(weights.T)


def _filter_op_matrix(n: int, kernel) -> np.ndarray:
    """The (n, n) matrix of a reflect-101 1-D correlation along rows, built by
    filtering an identity (taps accumulate in order, in float32)."""
    eye = np.eye(n, dtype=np.float32)
    k = len(kernel)
    pad = k // 2
    xp = np.pad(eye, ((pad, pad), (0, 0)), mode="reflect")
    out = np.zeros_like(eye)
    for i in range(k):
        out = (out + np.float32(kernel[i]) * xp[i : i + n]).astype(np.float32)
    return out


@functools.lru_cache(maxsize=16)
def blur_op_matrix(n: int, ksize: int, sigma: float) -> np.ndarray:
    return _filter_op_matrix(n, iops.gaussian_kernel_1d(ksize, sigma))


@functools.lru_cache(maxsize=16)
def box_op_matrix(n: int, ksize: int) -> np.ndarray:
    return _filter_op_matrix(n, [np.float32(1.0 / ksize)] * ksize)


@functools.lru_cache(maxsize=16)
def dft_matrices(n: int):
    """Real and imaginary parts of the symmetric n-point DFT matrix
    exp(-2*pi*i*jk/n), with jk reduced mod n and evaluated in float64 so each
    entry is the correctly rounded float32."""
    jk = np.outer(np.arange(n), np.arange(n)) % n
    ang = (2.0 * math.pi / n) * jk.astype(np.float64)
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@contextlib.contextmanager
def _full_fp32_matmul(device: torch.device):
    """Run float32 products without TF32 on the card, restoring the setting."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _spectral_core_dft(small: torch.Tensor) -> torch.Tensor:
    """DFT -> spectral residual -> inverse DFT -> squared magnitude, with the
    phase factor folded as exp(residual)/|F| * (Re F, Im F)."""
    n = small.shape[-1]
    dev = small.device
    dr_np, di_np = dft_matrices(n)
    dr = torch.from_numpy(dr_np).to(dev)
    di = torch.from_numpy(di_np).to(dev)
    bm = torch.from_numpy(box_op_matrix(n, 3)).to(dev)

    tr = small @ dr
    ti = small @ di
    fr = dr @ tr - di @ ti
    fi = dr @ ti + di @ tr

    amplitude = torch.sqrt(fr * fr + fi * fi)
    log_amp = torch.log(amplitude + 1e-9)
    box = (bm @ log_amp) @ bm.T
    residual = log_amp - box
    scale = torch.exp(residual) / torch.clamp(amplitude, min=1e-30)
    rr = fr * scale
    ri = fi * scale

    ur = rr @ dr + ri @ di
    ui = ri @ dr - rr @ di
    gr = dr @ ur + di @ ui
    gi = dr @ ui - di @ ur
    return (gr * gr + gi * gi) * (1.0 / float(n) ** 4)


def _spectral_core_fft(small: torch.Tensor) -> torch.Tensor:
    """The same core through `torch.fft` (cuFFT on the card), as the JAX
    package's `_spectral_core_fft` computes it with `jnp.fft`: the phase
    factor folded as in the DFT core, the result |ifft2(R)|^2."""
    n = small.shape[-1]
    bm = torch.from_numpy(box_op_matrix(n, 3)).to(small.device)
    f = torch.fft.fft2(small)
    fr, fi = f.real, f.imag
    amplitude = torch.sqrt(fr * fr + fi * fi)
    log_amp = torch.log(amplitude + 1e-9)
    residual = log_amp - (bm @ log_amp) @ bm.T
    scale = torch.exp(residual) / torch.clamp(amplitude, min=1e-30)
    return torch.abs(torch.fft.ifft2(torch.complex(fr * scale, fi * scale))) ** 2


def spectral_residual_small(
    image: torch.Tensor, resolution: int = 64, blur_sigma: float = 3.0,
    dft_matmul: bool = True,
) -> torch.Tensor:
    """The spectral-residual map at `resolution`^2, min-max normalized and not
    upsampled. image: (..., H, W, 3) in [-1, 1] or (..., H, W) gray255.
    dft_matmul: the DFT as float32 matrix products (`SaliencyConfig`'s
    default), else the FFT core. Returns (..., resolution, resolution)
    float32."""
    gray = _as_gray(image)
    h, w = gray.shape[-2], gray.shape[-1]
    lead = gray.shape[:-2]
    g3 = gray.reshape((-1, h, w))
    dev = g3.device
    with _full_fp32_matmul(dev):
        wdn_h = torch.from_numpy(resize_op_matrix(h, resolution)).to(dev)
        wdn_w = torch.from_numpy(resize_op_matrix(w, resolution)).to(dev)
        small = (wdn_h @ g3) @ wdn_w.T
        sal = (_spectral_core_dft if dft_matmul else _spectral_core_fft)(small)
        ksize = int(2 * math.ceil(3.0 * blur_sigma) + 1)
        blur = torch.from_numpy(blur_op_matrix(resolution, ksize, blur_sigma)).to(dev)
        sal = (blur @ sal) @ blur.T
    sal = iops.normalize_minmax(sal)
    return sal.reshape(tuple(lead) + (resolution, resolution))


def spectral_residual_saliency(
    image: torch.Tensor, resolution: int = 64, blur_sigma: float = 3.0,
    dft_matmul: bool = True,
) -> torch.Tensor:
    """The spectral-residual map at the image's size: the `resolution`^2 map
    upsampled by the two linear-resize operator matrices. image: (..., H, W, 3)
    in [-1, 1] or (..., H, W) gray255. Returns (..., H, W) float32."""
    gray = _as_gray(image)
    h, w = gray.shape[-2], gray.shape[-1]
    lead = gray.shape[:-2]
    sal = spectral_residual_small(gray, resolution, blur_sigma, dft_matmul)
    sal = sal.reshape(-1, resolution, resolution)
    dev = sal.device
    with _full_fp32_matmul(dev):
        up_h = torch.from_numpy(resize_op_matrix(resolution, h)).to(dev)
        up_w = torch.from_numpy(resize_op_matrix(resolution, w)).to(dev)
        out = (up_h @ sal) @ up_w.T
    return out.reshape(tuple(lead) + (h, w))


def fine_grained_saliency(image: torch.Tensor, scales=(1, 2, 3, 4, 5, 6)) -> torch.Tensor:
    """Fine-grained center-surround saliency (Montabone & Soto 2010):
    sum over scales of relu(I - box) + relu(box - I), box the (2r+1)^2 mean of
    I = gray / 255, then max-normalized."""
    gray = iops.true_div(_as_gray(image), 255.0)
    on_total = torch.zeros_like(gray)
    off_total = torch.zeros_like(gray)
    for r in scales:
        surround = iops.box_filter(gray, 2 * r + 1)
        on_total = on_total + torch.clamp(gray - surround, min=0.0)
        off_total = off_total + torch.clamp(surround - gray, min=0.0)
    return iops.normalize_max(on_total + off_total)


def compute_saliency_map(image: torch.Tensor, method: str = "combined", config=None) -> torch.Tensor:
    """'spectral_residual', 'fine_grained', or 'combined' = max-normalize(
    0.6 spectral + 0.4 fine). image: (..., H, W, 3) in [-1, 1] or (..., H, W)
    gray255. Returns (..., H, W) float32 in [0, 1]."""
    cfg = config or SaliencyConfig()
    spectral = (cfg.spectral_resolution, cfg.spectral_blur_sigma, cfg.spectral_dft_matmul)
    if method == "spectral_residual":
        return spectral_residual_saliency(image, *spectral)
    if method == "fine_grained":
        return fine_grained_saliency(image, cfg.fine_grained_scales)
    if method == "combined":
        spec = spectral_residual_saliency(image, *spectral)
        fine = fine_grained_saliency(image, cfg.fine_grained_scales)
        return iops.normalize_max(
            cfg.combined_spectral_weight * spec + cfg.combined_fine_weight * fine)
    raise ValueError(f"Unsupported saliency method: {method}")
