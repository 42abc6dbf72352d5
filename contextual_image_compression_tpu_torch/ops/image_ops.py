"""Image filtering primitives on tensors, OpenCV semantics.

Counterpart of `contextual_image_compression_tpu/ops/image_ops.py`: the same
kernels (cv2.getGaussianKernel with its sigma rule and small-kernel table),
BORDER_REFLECT_101 padding and per-image normalizations. Saliency-map filters
take (..., H, W) tensors.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F


def opencv_gaussian_sigma(ksize: int) -> float:
    """OpenCV's derived sigma when sigma=0: 0.3*((ksize-1)*0.5 - 1) + 0.8."""
    return 0.3 * ((ksize - 1) * 0.5 - 1.0) + 0.8


# cv2.getGaussianKernel's fixed binomial kernels for small ksize with sigma <= 0.
_CV2_SMALL_GAUSSIAN = {
    1: np.array([1.0], np.float32),
    3: np.array([0.25, 0.5, 0.25], np.float32),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
                np.float32),
    9: np.array([4, 13, 30, 51, 60, 51, 30, 13, 4], np.float32) / 256.0,
}


@functools.lru_cache(maxsize=64)
def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """1-D Gaussian kernel identical to cv2.getGaussianKernel for float inputs.
    The returned array is shared between callers: do not write to it."""
    if sigma <= 0:
        if ksize in _CV2_SMALL_GAUSSIAN:
            return _CV2_SMALL_GAUSSIAN[ksize]
        sigma = opencv_gaussian_sigma(ksize)
    half = (ksize - 1) / 2.0
    x = np.arange(ksize, dtype=np.float64) - half
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def reflect_pad_hw(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """BORDER_REFLECT_101 padding of the last two axes (= numpy 'reflect')."""
    lead = x.shape[:-2]
    x4 = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    out = F.pad(x4, (pad_w, pad_w, pad_h, pad_h), mode="reflect")
    return out.reshape(lead + tuple(out.shape[-2:]))


def sep_filter_axis(x: torch.Tensor, kernel, axis: int) -> torch.Tensor:
    """Correlate the last-two-axes image with a 1-D kernel along `axis`
    (-2: rows, -1: columns), reflect-101 at the border; taps accumulate
    in order."""
    k = len(kernel)
    pad = k // 2
    n = x.shape[axis]
    if axis == -2:
        xp = reflect_pad_hw(x, pad, 0)
    elif axis == -1:
        xp = reflect_pad_hw(x, 0, pad)
    else:
        raise ValueError(f"axis must be -2 or -1, got {axis}")
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + float(kernel[i]) * xp.narrow(axis, i, n)
    return out


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """Separable Gaussian blur on the last two axes, cv2.GaussianBlur-compatible."""
    kern = gaussian_kernel_1d(ksize, sigma)
    return sep_filter_axis(sep_filter_axis(x, kern, -2), kern, -1)


def box_sum(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Unnormalized ksize x ksize box sum on the last two axes (reflect-101):
    rows first, then columns."""
    ones = [1.0] * ksize
    return sep_filter_axis(sep_filter_axis(x, ones, -2), ones, -1)


def true_div(x: torch.Tensor, divisor: float) -> torch.Tensor:
    """x / divisor as an IEEE float32 division on every device. (On CUDA,
    torch turns a division by a Python scalar into a multiply by its
    reciprocal, which is an ulp off for some x; the thresholds and
    histogram bins below are discrete, so that ulp would move them.)"""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


_SCAN_BASE = 16


def _sequential_prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis, accumulated left to right in
    x's dtype (torch.cumsum accumulates float32 in double on the CPU)."""
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, dim=-1)


def prefix_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive prefix sum along `dim` with the float32 rounding of
    jnp.cumsum on XLA's CPU backend, which runs a cumulative reduce-window as
    a two-level scan: the axis cut into chunks of 16 (zero-padded at the
    end), a left-to-right sum inside each chunk, the same scan applied to the
    chunk totals, and each chunk's exclusive offset added last."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= _SCAN_BASE:
        out = _sequential_prefix_sum(x)
    else:
        m = -(-n // _SCAN_BASE)
        xp = F.pad(x, (0, m * _SCAN_BASE - n)).reshape(x.shape[:-1] + (m, _SCAN_BASE))
        inner = _sequential_prefix_sum(xp)
        outer = prefix_sum(inner[..., -1])
        offset = F.pad(outer[..., :-1], (1, 0))
        out = (inner + offset[..., None]).reshape(x.shape[:-1] + (m * _SCAN_BASE,))[..., :n]
    return out.movedim(-1, dim)


def _box_axis_prefix(x: torch.Tensor, ksize: int, axis: int) -> torch.Tensor:
    """Box mean along one axis (-2 or -1) by prefix sums, reflect-101."""
    pad = ksize // 2
    xp = reflect_pad_hw(x, pad, 0) if axis == -2 else reflect_pad_hw(x, 0, pad)
    c = prefix_sum(xp, axis)
    n = x.shape[axis]
    hi = c.narrow(axis, ksize - 1, n)
    lo = c.narrow(axis, 0, n)
    rest = hi.narrow(axis, 1, n - 1) - lo.narrow(axis, 0, n - 1)
    return true_div(torch.cat([hi.narrow(axis, 0, 1), rest], dim=axis), float(ksize))


def box_filter(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """Normalized ksize x ksize box mean on the last two axes (reflect-101),
    in the JAX package's two formulations: prefix sums for ksize >= 7, direct
    taps of 1/ksize below that."""
    if ksize >= 7:
        return _box_axis_prefix(_box_axis_prefix(x, ksize, -2), ksize, -1)
    kern = [float(np.float32(1.0 / ksize))] * ksize
    return sep_filter_axis(sep_filter_axis(x, kern, -2), kern, -1)


def bilateral_filter(
    x: torch.Tensor,
    d: int = 9,
    sigma_color: float = 75.0,
    sigma_space: float = 75.0,
    unit_range: bool = False,
) -> torch.Tensor:
    """Disk-masked bilateral filter on the last two axes, cv2.bilateralFilter
    semantics for float32 input. unit_range=False weighs by the exact range
    Gaussian exp(color_coeff * diff^2); unit_range=True clips diff to [-1, 1]
    and uses its 2nd-order Taylor form 1 + t (1 + t / 2), as the JAX
    package's CPU path does for [0, 1] saliency maps."""
    radius = d // 2
    color_coeff = -0.5 / (sigma_color * sigma_color)
    space_coeff = -0.5 / (sigma_space * sigma_space)
    xp = reflect_pad_hw(x, radius, radius)
    h, w = x.shape[-2], x.shape[-1]
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            r2 = dy * dy + dx * dx
            if r2 > radius * radius:
                continue
            shifted = xp[..., dy + radius : dy + radius + h, dx + radius : dx + radius + w]
            diff = shifted - x
            if unit_range:
                diff = torch.clamp(diff, -1.0, 1.0)
                t = color_coeff * diff * diff
                range_w = 1.0 + t * (1.0 + 0.5 * t)
            else:
                range_w = torch.exp(color_coeff * diff * diff)
            wgt = math.exp(space_coeff * r2) * range_w
            num = num + wgt * shifted
            den = den + wgt
    return num / torch.clamp(den, min=1e-20)


def bilateral_taps(d: int, sigma_space: float, sigma_color: float):
    """The disk-masked taps of a d x d bilateral window, in (dy, dx) row-major
    order, with the space weight sw = exp(space_coeff * r^2) and the
    first-order Taylor range coefficient swc = sw * color_coeff, both
    evaluated in double precision and rounded to float32."""
    radius = d // 2
    color_coeff = -0.5 / (sigma_color * sigma_color)
    space_coeff = -0.5 / (sigma_space * sigma_space)
    taps = []
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            r2 = dy * dy + dx * dx
            if r2 > radius * radius:  # cv2's disk mask
                continue
            sw = math.exp(space_coeff * r2)
            taps.append((dy, dx, float(np.float32(sw)), float(np.float32(sw * color_coeff))))
    return taps


def bilateral_filter_taylor(
    x: torch.Tensor, d: int = 9, sigma_color: float = 75.0, sigma_space: float = 75.0
) -> torch.Tensor:
    """Bilateral filter of a [0, 1] map on the last two axes with the range
    weight exp(color_coeff * diff^2) replaced by its first-order Taylor form
    sw + swc * diff^2 (|color_coeff * diff^2| <= 8.9e-5 at sigma 75, so the
    dropped terms are ~4e-9)."""
    radius = d // 2
    xp = reflect_pad_hw(x, radius, radius)
    h, w = x.shape[-2], x.shape[-1]
    num = torch.zeros_like(x)
    den = torch.zeros_like(x)
    for dy, dx, sw, swc in bilateral_taps(d, sigma_space, sigma_color):
        shifted = xp[..., dy + radius : dy + radius + h, dx + radius : dx + radius + w]
        diff = shifted - x
        wgt = sw + swc * (diff * diff)
        num = num + wgt * shifted
        den = den + wgt
    return num / torch.clamp(den, min=1e-20)


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """ITU-R BT.601 luma (cv2 COLOR_RGB2GRAY). img: (..., H, W, 3) -> (..., H, W)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return 0.299 * r + 0.587 * g + 0.114 * b


def normalize_minmax(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Min-max normalize to [0, 1] per image over the last two axes."""
    mn = torch.amin(x, dim=(-2, -1), keepdim=True)
    mx = torch.amax(x, dim=(-2, -1), keepdim=True)
    return (x - mn) / torch.clamp(mx - mn, min=eps)


def normalize_max(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Divide by the per-image max over the last two axes where it is positive."""
    mx = torch.amax(x, dim=(-2, -1), keepdim=True)
    return torch.where(mx > 0, x / torch.clamp(mx, min=eps), x)
