"""Mask engine kernels K1 (contextual mask) and K4 (smooth mask), each with
its plain PyTorch twin.

K1 replaces `contextual_image_compression_tpu/ops/fused_mask.py::
contextual_mask_pallas` (kernel body `_make_contextual_kernel`). Per image,
from gray255 (B, H, W) and the spectral-residual map (B, r, r), it computes

  1. fine-grained saliency sum_r |g - boxmean_{2r+1}(g)| on g = gray/255,
     reflect-101, then max-normalize;
  2. the linear (jax.image.resize) upsample of the spectral map to H x W;
  3. comb = 0.6 * spec + 0.4 * fine, max-normalize;
  4. the disk-masked bilateral filter (d = 9, 49 taps) with the first-order
     Taylor range weight sw + swc * diff^2;
  5. the separable 31-tap Gaussian (sigma 5), then max-normalize.

K4 replaces `smooth_mask_pallas` of the same file (kernel body
`_make_kernel`): stages 4 and 5 on a given saliency map, read as it is
(K1 divides its input by the map's max first).

Reflect-101 padding applies per stage to that stage's own input. On a CUDA
tensor `contextual_mask` and `smooth_mask` launch their kernels in
`csrc/fused_mask.cu`; on a CPU tensor they run `contextual_mask_plain` and
`smooth_mask_plain`, which are also what the card's results are held against.

On the card, `_mask_plan` picks one of two routes before any launch, from
the image and filter sizes alone:

* 'cluster': one launch per call. Each image goes to a thread-block cluster
  of 6 (or, for larger images, 8) blocks, each block owning a strip of
  whole rows, with every intermediate in the strips' shared memory; the
  route of every default configuration (256^2, and anything up to 335^2 at
  the default filters).
* 'tiled': six launches over 32x32 tiles with two scratch images in device
  memory, for images whose strips do not fit in a cluster's shared memory.

K1 also has a bf16 route, the TPU kernel's compute_dtype=bfloat16
(`contextual_mask(..., compute_dtype=torch.bfloat16)`, selected by
SaliencyConfig.mask_engine_dtype): the windowed passes in bf16, summed in
chunks of CHUNK taps in the TPU kernel's order, the normalizations, the
upsample, the blend and the bilateral's division in float32. Its twin,
`_contextual_mask_plain_bf16`, rounds each bf16 operation once; the card's
kernels match it bit for bit.

Each wrapper counts its launches in `.launches` and, apart, per route in
`.route_launches` (K1's bf16 launches as 'cluster_bf16' / 'tiled_bf16'). A
route is never chosen because a launch failed: a refused launch, or a
cluster the card cannot schedule, raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from contextual_image_compression_tpu_torch.ops import cuda_kernels as ck
from contextual_image_compression_tpu_torch.ops import image_ops as iops
from contextual_image_compression_tpu_torch.ops.saliency import (
    _full_fp32_matmul,
    resize_op_matrix,
)


def contextual_mask_plain(
    gray255: torch.Tensor,
    spectral: torch.Tensor,
    scales=(1, 2, 3, 4, 5, 6),
    spectral_weight: float = 0.6,
    fine_weight: float = 0.4,
    d: int = 9,
    sigma_color: float = 75.0,
    sigma_space: float = 75.0,
    gauss_ksize: int = 31,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """K1's function in plain PyTorch. gray255: (B, H, W) in [0, 255];
    spectral: (B, r, r) (upsampled here) or (B, H, W). compute_dtype
    bfloat16 runs the windowed passes in bf16 (`_contextual_mask_plain_bf16`)."""
    if compute_dtype == torch.bfloat16:
        return _contextual_mask_plain_bf16(gray255, spectral, scales, spectral_weight,
                                           fine_weight, d, sigma_color, sigma_space, gauss_ksize)
    if compute_dtype != torch.float32:
        raise ValueError(f"contextual_mask: compute_dtype float32 or bfloat16, got {compute_dtype}")
    h, w = gray255.shape[-2:]
    g = gray255.to(torch.float32) * (1.0 / 255.0)
    fine = torch.zeros_like(g)
    for r in sorted(set(scales)):
        k = 2 * r + 1
        surround = iops.box_sum(g, k) * float(np.float32(1.0 / (k * k)))
        fine = fine + torch.abs(g - surround)
    fine = iops.normalize_max(fine)

    spec = spectral.to(torch.float32)
    if tuple(spec.shape[-2:]) != (h, w):
        spec = resize_spectral(spec, h, w)
    comb = iops.normalize_max(spectral_weight * spec + fine_weight * fine)
    y = iops.bilateral_filter_taylor(comb, d, sigma_color, sigma_space)
    return iops.normalize_max(iops.gaussian_blur(y, gauss_ksize, 0.0))


# Taps a bf16 partial sum takes before it joins the running total: the bf16
# route sums every window in chunks of this many taps, in the TPU kernel's
# order (contextual_image_compression_tpu/ops/fused_mask.py: _CHUNK).
CHUNK = 8


def bf16_value(v: float) -> float:
    """v rounded to float32, then to bfloat16 (nearest even), as a float:
    `jnp.asarray(v, jnp.bfloat16)` for the TPU kernel's constants."""
    return float(torch.tensor(float(np.float32(v))).to(torch.bfloat16).float())


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """Indices of positions -pad .. n + pad - 1 after reflect-101."""
    i = torch.arange(-pad, n + pad, device=device).abs()
    return torch.where(i >= n, 2 * n - 2 - i, i)


def _chunked_sum(n: int, term):
    """term(0) + ... + term(n - 1) as the bf16 route adds taps: CHUNK terms at
    a time in order, each chunk's sum then added to the total. With bf16
    tensors every add rounds to bf16, as each operation of the TPU kernel does."""
    total = None
    for c0 in range(0, n, CHUNK):
        acc = term(c0)
        for i in range(c0 + 1, min(c0 + CHUNK, n)):
            acc = acc + term(i)
        total = acc if total is None else total + acc
    return total


def upsample_two_tap(spec: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The linear upsample (B, r, r) -> (B, h, w) in its two-tap form, rows
    first, in float32 with every product and sum rounded apart: what K1's
    bf16 route computes (the bf16 mask then rounds this map, so the twin and
    the kernel must agree on it to the bit)."""
    ih, wh = (torch.from_numpy(a).to(spec.device) for a in upsample_taps(spec.shape[-2], h))
    iw, ww = (torch.from_numpy(a).to(spec.device) for a in upsample_taps(spec.shape[-1], w))
    s = spec.to(torch.float32)
    i1 = torch.clamp(ih.long() + 1, max=spec.shape[-2] - 1)
    rows = wh[:, :1] * s[..., ih.long(), :] + wh[:, 1:] * s[..., i1, :]  # (B, h, r)
    j1 = torch.clamp(iw.long() + 1, max=spec.shape[-1] - 1)
    return rows[..., iw.long()] * ww[:, 0] + rows[..., j1] * ww[:, 1]


def _contextual_mask_plain_bf16(gray255, spectral, scales, spectral_weight, fine_weight, d,
                                sigma_color, sigma_space, gauss_ksize):
    """K1's bf16 route in plain PyTorch, following the TPU kernel's
    `_make_contextual_kernel(dt=bfloat16)` operation by operation:

      * g = bf16(gray * (1/255) in float32);
      * per radius r, the running vertical sum (rs + g[y - r]) + g[y + r]
        and the horizontal box sum of rs over 2r + 1 columns in chunks
        (`_chunked_sum`), surround = sum * bf16(1 / k^2), fine += |g - surround|,
        all in bf16; the fine map's max-normalization in float32;
      * comb = max-normalize(0.6 * spec + 0.4 * fine) in float32, rounded to bf16;
      * the disk bilateral in bf16: per tap wgt = sw + swc * diff^2 (sw, swc
        rounded to bf16), num += wgt * shifted, den += wgt, in chunks; the
        ratio in float32, rounded to bf16;
      * the separable Gaussian (rows, then columns) in bf16 in chunks, then
        max-normalization in float32 -> float32 mask.

    Every bf16 operation is a torch operation on bf16 tensors, so each rounds
    once to bf16 (float32 holds a product of two bf16 values exactly, and a
    sum rounded to float32 then to bf16 is the sum rounded to bf16). The
    spectral map is upsampled by `upsample_two_tap`, as the kernel does."""
    bf = torch.bfloat16
    dev = gray255.device
    h, w = gray255.shape[-2:]
    g = (gray255.to(torch.float32) * (1.0 / 255.0)).to(bf)

    rmax = max(scales)
    rows_i = _reflect_index(h, rmax, dev)
    rs = g
    fine = None
    for r in range(1, rmax + 1):
        rs = (rs + g[..., rows_i[rmax - r:rmax - r + h], :]) + g[..., rows_i[rmax + r:rmax + r + h], :]
        if r not in scales:
            continue
        k = 2 * r + 1
        cols_i = _reflect_index(w, r, dev)
        cs = _chunked_sum(k, lambda i: rs[..., cols_i[i:i + w]])
        surround = cs * torch.tensor(bf16_value(1.0 / (k * k)), dtype=bf, device=dev)
        term = torch.abs(g - surround)
        fine = term if fine is None else fine + term
    fine = iops.normalize_max(fine.to(torch.float32))

    spec = spectral.to(torch.float32)
    if tuple(spec.shape[-2:]) != (h, w):
        if spec.shape[-2] > h or spec.shape[-1] > w:
            spec = resize_spectral(spec, h, w)
        else:
            spec = upsample_two_tap(spec, h, w)
    x = iops.normalize_max(spectral_weight * spec + fine_weight * fine).to(bf)

    radius = d // 2
    taps = iops.bilateral_taps(d, sigma_space, sigma_color)
    ri, ci = _reflect_index(h, radius, dev), _reflect_index(w, radius, dev)
    xp = x[..., ri, :][..., ci]
    num = den = None
    for c0 in range(0, len(taps), CHUNK):
        acc_n = acc_d = None
        for dy, dx, sw, swc in taps[c0:c0 + CHUNK]:
            sh = xp[..., radius + dy:radius + dy + h, radius + dx:radius + dx + w]
            diff = sh - x
            wgt = (torch.tensor(bf16_value(sw), dtype=bf, device=dev)
                   + torch.tensor(bf16_value(swc), dtype=bf, device=dev) * (diff * diff))
            acc_n = wgt * sh if acc_n is None else acc_n + wgt * sh
            acc_d = wgt if acc_d is None else acc_d + wgt
        num = acc_n if num is None else num + acc_n
        den = acc_d if den is None else den + acc_d
    y = (num.to(torch.float32) / torch.clamp(den.to(torch.float32), min=1e-20)).to(bf)

    gk = [torch.tensor(bf16_value(v), dtype=bf, device=dev)
          for v in iops.gaussian_kernel_1d(gauss_ksize, 0.0)]
    pad = gauss_ksize // 2
    ri, ci = _reflect_index(h, pad, dev), _reflect_index(w, pad, dev)
    yr = y[..., ri, :]
    rowout = _chunked_sum(gauss_ksize, lambda i: gk[i] * yr[..., i:i + h, :])
    rc = rowout[..., ci]
    out = _chunked_sum(gauss_ksize, lambda i: gk[i] * rc[..., i:i + w])
    return iops.normalize_max(out.to(torch.float32))


def resize_spectral(spec: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, r, r) -> (B, h, w) by the linear resize operator matrices in full
    float32 (jax.image.resize 'linear': antialiased when it shrinks)."""
    dev = spec.device
    uph = torch.from_numpy(resize_op_matrix(spec.shape[-2], h)).to(dev)
    upw = torch.from_numpy(resize_op_matrix(spec.shape[-1], w)).to(dev)
    with _full_fp32_matmul(dev):
        return (uph @ spec) @ upw.T


@functools.lru_cache(maxsize=16)
def upsample_taps(src: int, dst: int):
    """The two-tap form of resize_op_matrix(src, dst): for each output row,
    the first nonzero input index and the weights of it and of the next one.
    The linear resize upsamples with at most two adjacent taps per row."""
    mat = resize_op_matrix(src, dst)
    idx = np.zeros(dst, np.int32)
    wts = np.zeros((dst, 2), np.float32)
    for i in range(dst):
        nz = np.nonzero(mat[i])[0]
        if len(nz) == 0:
            continue
        if len(nz) > 2 or nz[-1] - nz[0] > 1:
            raise ValueError(f"resize {src}->{dst} is not a two-tap upsample")
        idx[i] = nz[0]
        wts[i, 0] = mat[i, nz[0]]
        if len(nz) == 2:
            wts[i, 1] = mat[i, nz[1]]
    return idx, wts


@functools.lru_cache(maxsize=8)
def _host_filter_tables(d, sigma_color, sigma_space, gauss_ksize, bf16=False):
    """The bilateral (sw, swc) pairs and the Gaussian taps as host arrays,
    which the cluster route copies into its kernel arguments, and the
    number of bilateral taps; bf16=True rounds them to bf16 (`bf16_value`)
    for K1's bf16 route."""
    taps = iops.bilateral_taps(d, sigma_space, sigma_color)
    tap_w = np.ascontiguousarray(
        np.array([[sw, swc] for _, _, sw, swc in taps], np.float32).reshape(-1))
    gk = np.ascontiguousarray(iops.gaussian_kernel_1d(gauss_ksize, 0.0), np.float32).copy()
    if bf16:
        tap_w = np.array([bf16_value(v) for v in tap_w], np.float32)
        gk = np.array([bf16_value(v) for v in gk], np.float32)
    return tap_w, gk, len(taps)


@functools.lru_cache(maxsize=8)
def _filter_tables(dev, d, sigma_color, sigma_space, gauss_ksize, bf16=False):
    """`_host_filter_tables` on `dev` (the tiled route reads them from device
    memory)."""
    tap_w, gk, n_taps = _host_filter_tables(d, sigma_color, sigma_space, gauss_ksize, bf16)
    return torch.from_numpy(tap_w).to(dev), torch.from_numpy(gk).to(dev), n_taps


@functools.lru_cache(maxsize=8)
def _upsample_tables(dev, rh, rw, h, w):
    """K1's two-tap upsample tables on `dev`, built once per shape. The
    cluster route reads a strip's spectral rows as one block, so the row
    index must not decrease nor step by more than one a row."""
    steps = np.diff(upsample_taps(rh, h)[0])
    if steps.size and (steps.min() < 0 or steps.max() > 1):
        raise ValueError(f"resize {rh}->{h}: the upsample's row index is not a unit staircase")
    arrays = (*upsample_taps(rh, h), *upsample_taps(rw, w))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _check_filter_sizes(name, h, w, d, gauss_ksize, rmax=0):
    if rmax > 8 or d // 2 > 8 or gauss_ksize > 63:
        raise ValueError(f"{name}: box radius and bilateral radius <= 8, ksize <= 63")
    if min(h, w) <= max(rmax, d // 2, gauss_ksize // 2):
        raise ValueError(f"{name}: image {h}x{w} too small for the filters")


# Blocks per image, in order of preference. On an H100 SXM 17 clusters of 6
# such blocks run at once and 15 of 8 (cudaOccupancyMaxActiveClusters, as
# scripts/torch_mask_stages.py prints it), so a B = 16 batch takes one wave
# at 6 and two at 8; 8 (the portable maximum) takes the images whose strips
# do not fit at 6.
CLUSTER_SIZES = (6, 8)
MAX_SMEM_BYTES = 232448  # shared memory one block may use on the H100


class MaskPlan(NamedTuple):
    """How a K1 / K4 call runs on the card (see `_mask_plan`)."""

    route: str       # 'cluster' or 'tiled'
    cluster: int     # blocks per image (cluster route)
    rows: int        # image rows per block; the last block may own fewer
    stride: int      # floats per strip row (odd: no shared-memory bank conflicts)
    halo: int        # halo rows above and below a strip, and reflected columns each side
    smem_bytes: int  # dynamic shared memory per block (cluster route)


@functools.lru_cache(maxsize=64)
def _mask_plan(h: int, w: int, rmax: int, radius: int, ksize: int) -> MaskPlan:
    """The route of a mask kernel call for an h x w image, box radius rmax
    (0 for K4), bilateral radius and Gaussian size. The cluster route splits
    the rows over the first of CLUSTER_SIZES whose strips fit and takes, per
    block, buffer 0 (its rows plus `halo` rows each side and 3 rows of
    slack), buffers 1 and 2 (its rows), each row `stride` floats, plus 36
    floats of maxima; csrc/fused_mask.cu checks the same layout. Images
    whose strips exceed a block's shared memory even at 8 blocks take the
    tiled route."""
    halo = max(rmax, radius, ksize // 2)
    stride = w + 2 * halo
    stride += 1 - stride % 2
    for size in CLUSTER_SIZES:
        rows = -(-h // size)
        cluster = -(-h // rows)
        smem = 4 * ((3 * rows + 2 * halo + 3) * stride + 36)
        if smem <= MAX_SMEM_BYTES:
            return MaskPlan("cluster", cluster, rows, stride, halo, smem)
    return MaskPlan("tiled", cluster, rows, stride, halo, smem)


def _halo_rows(plan: MaskPlan, h: int, rank: int, halo: int):
    """For block `rank`, the rows a stage with `halo` rows each side reads:
    (image row after reflect-101, owning block, row within that block's
    strip), as the cluster kernel computes them."""
    r0 = rank * plan.rows
    n = min(plan.rows, h - r0)
    out = []
    for j in range(n + 2 * halo):
        yy = abs(r0 - halo + j)
        if yy >= h:
            yy = 2 * h - 2 - yy
        owner = yy // plan.rows
        out.append((yy, owner, yy - owner * plan.rows))
    return out


def _cluster_args(plan: MaskPlan):
    return (plan.cluster, plan.rows, plan.stride, plan.halo, plan.smem_bytes)


def mask_max_clusters(contextual: bool, h: int, w: int, scales=(1, 2, 3, 4, 5, 6), d: int = 9,
                      gauss_ksize: int = 31) -> int:
    """How many clusters of the cluster route the current card runs at once
    for such a call (`cudaOccupancyMaxActiveClusters`); launches nothing."""
    import ctypes

    rmax = max(scales) if contextual else 0
    plan = _mask_plan(h, w, rmax, d // 2, gauss_ksize)
    if plan.route != "cluster":
        raise ValueError(f"a {h}x{w} mask takes the tiled route")
    count = ctypes.c_int(0)
    err = ck.library().cic_mask_max_clusters(int(contextual), h, w, rmax, d // 2, gauss_ksize,
                                             *_cluster_args(plan), ctypes.addressof(count))
    ck.check(err, "mask_max_clusters")
    return count.value


def _count(wrapper, route):
    wrapper.launches += 1
    wrapper.route_launches[route] += 1


def contextual_mask(
    gray255: torch.Tensor,
    spectral: torch.Tensor,
    scales=(1, 2, 3, 4, 5, 6),
    spectral_weight: float = 0.6,
    fine_weight: float = 0.4,
    d: int = 9,
    sigma_color: float = 75.0,
    sigma_space: float = 75.0,
    gauss_ksize: int = 31,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Fused contextual mask (B, H, W) float32 from gray255 (B, H, W) and the
    spectral map (B, r, r). Launches K1 for CUDA tensors, on the route
    `_mask_plan` picks, in float32 or (compute_dtype bfloat16) on the bf16
    route, counted apart as routes 'cluster_bf16' / 'tiled_bf16'; the plain
    twin runs only for CPU tensors."""
    args = (scales, spectral_weight, fine_weight, d, sigma_color, sigma_space, gauss_ksize)
    if compute_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"contextual_mask: compute_dtype float32 or bfloat16, got {compute_dtype}")
    if gray255.device.type == "cpu":
        return contextual_mask_plain(gray255, spectral, *args, compute_dtype=compute_dtype)
    if gray255.device.type != "cuda":
        raise ValueError(f"contextual_mask: unsupported device {gray255.device}")
    if gray255.dtype != torch.float32 or spectral.dtype != torch.float32:
        raise TypeError("contextual_mask: gray255 and spectral must be float32")
    if gray255.ndim != 3 or spectral.ndim != 3 or spectral.shape[0] != gray255.shape[0]:
        raise ValueError("contextual_mask: expected gray255 (B, H, W) and spectral (B, r, r)")
    b, h, w = gray255.shape
    rh, rw = spectral.shape[-2:]
    rmax = max(scales)
    if min(scales) < 1:
        raise ValueError("contextual_mask: box radii must be >= 1")
    _check_filter_sizes("contextual_mask", h, w, d, gauss_ksize, rmax)
    ck.require_cuda("contextual_mask", gray255, spectral)
    if rh > h or rw > w:
        # an image below the spectral resolution: the kernel's two-tap
        # upsample cannot shrink the map, so it is resized first, as the
        # twin resizes it, and enters the kernel at (H, W)
        spectral = resize_spectral(spectral, h, w).contiguous()
        rh, rw = h, w
    dev = gray255.device
    up = _upsample_tables(dev, rh, rw, h, w)
    scale_mask = 0
    for r in scales:
        scale_mask |= 1 << r
    plan = _mask_plan(h, w, rmax, d // 2, gauss_ksize)
    bf16 = compute_dtype == torch.bfloat16
    suffix = "_bf16" if bf16 else ""
    out = torch.empty_like(gray255)
    head = (gray255.data_ptr(), spectral.data_ptr(), b, h, w, rh, rw,
            up[0].data_ptr(), up[1].data_ptr(), up[2].data_ptr(), up[3].data_ptr(),
            scale_mask, rmax, float(spectral_weight), float(fine_weight), d // 2)
    if plan.route == "cluster":
        tap_w, gk, n_taps = _host_filter_tables(d, float(sigma_color), float(sigma_space),
                                                gauss_ksize, bf16)
        launch = getattr(ck.library(), "cic_contextual_mask_cluster" + suffix)
        err = launch(*head, tap_w.ctypes.data, n_taps, gk.ctypes.data, gauss_ksize,
                     *_cluster_args(plan), out.data_ptr(), ck.stream_ptr(dev))
    else:
        tap_w, gk, n_taps = _filter_tables(dev, d, float(sigma_color), float(sigma_space),
                                           gauss_ksize, bf16)
        scratch1 = torch.empty_like(gray255)
        scratch2 = torch.empty_like(gray255)
        maxes = torch.empty((b, 4), dtype=torch.float32, device=dev)
        launch = getattr(ck.library(), "cic_contextual_mask" + suffix)
        err = launch(*head, tap_w.data_ptr(), n_taps, gk.data_ptr(), gauss_ksize,
                     scratch1.data_ptr(), scratch2.data_ptr(), maxes.data_ptr(), out.data_ptr(),
                     ck.stream_ptr(dev))
    ck.check(err, f"contextual_mask ({plan.route + suffix} route)")
    _count(contextual_mask, plan.route + suffix)
    return out


contextual_mask.launches = 0
contextual_mask.route_launches = {"cluster": 0, "tiled": 0, "cluster_bf16": 0, "tiled_bf16": 0}


def smooth_mask_plain(
    saliency: torch.Tensor,
    d: int = 9,
    sigma_color: float = 75.0,
    sigma_space: float = 75.0,
    gauss_ksize: int = 31,
) -> torch.Tensor:
    """K4's function in plain PyTorch, float32: the disk bilateral of the map
    as given (first-order Taylor range weight, no clip), the separable
    Gaussian, then max-normalize. saliency: (..., H, W)."""
    y = iops.bilateral_filter_taylor(saliency.to(torch.float32), d, sigma_color, sigma_space)
    return iops.normalize_max(iops.gaussian_blur(y, gauss_ksize, 0.0))


def smooth_mask(
    saliency: torch.Tensor,
    d: int = 9,
    sigma_color: float = 75.0,
    sigma_space: float = 75.0,
    gauss_ksize: int = 31,
) -> torch.Tensor:
    """Smooth mask (B, H, W) or (H, W) float32 of saliency maps of the same
    shape. Launches K4 for CUDA tensors, on the route `_mask_plan` picks;
    the plain twin runs only for CPU tensors."""
    if saliency.device.type == "cpu":
        return smooth_mask_plain(saliency, d, sigma_color, sigma_space, gauss_ksize)
    if saliency.device.type != "cuda":
        raise ValueError(f"smooth_mask: unsupported device {saliency.device}")
    if saliency.dtype != torch.float32:
        raise TypeError("smooth_mask: saliency must be float32")
    if saliency.ndim == 2:
        return smooth_mask(saliency[None], d, sigma_color, sigma_space, gauss_ksize)[0]
    if saliency.ndim != 3:
        raise ValueError("smooth_mask: expected saliency (B, H, W) or (H, W)")
    b, h, w = saliency.shape
    _check_filter_sizes("smooth_mask", h, w, d, gauss_ksize)
    ck.require_cuda("smooth_mask", saliency)
    dev = saliency.device
    plan = _mask_plan(h, w, 0, d // 2, gauss_ksize)
    out = torch.empty_like(saliency)
    if plan.route == "cluster":
        tap_w, gk, n_taps = _host_filter_tables(d, float(sigma_color), float(sigma_space),
                                                gauss_ksize)
        err = ck.library().cic_smooth_mask_cluster(
            saliency.data_ptr(), b, h, w, d // 2, tap_w.ctypes.data, n_taps, gk.ctypes.data,
            gauss_ksize, *_cluster_args(plan), out.data_ptr(), ck.stream_ptr(dev))
    else:
        tap_w, gk, n_taps = _filter_tables(dev, d, float(sigma_color), float(sigma_space),
                                           gauss_ksize)
        scratch = torch.empty_like(saliency)
        maxes = torch.empty((b, 4), dtype=torch.float32, device=dev)
        err = ck.library().cic_smooth_mask(
            saliency.data_ptr(), b, h, w, d // 2, tap_w.data_ptr(), n_taps,
            gk.data_ptr(), gauss_ksize, scratch.data_ptr(), maxes.data_ptr(), out.data_ptr(),
            ck.stream_ptr(dev))
    ck.check(err, f"smooth_mask ({plan.route} route)")
    _count(smooth_mask, plan.route)
    return out


smooth_mask.launches = 0
smooth_mask.route_launches = {"cluster": 0, "tiled": 0}
