"""HiFiC's ChannelNorm: kernel K9 and its plain twin.

ChannelNorm (models/hific.py) normalizes each pixel of x (B, C, H, W) over
its channels: (x - mean_c x) * rsqrt(var_c x + eps) * alpha_c + beta_c, the
biased variance, an optional ReLU, all in float32 whatever x's dtype and
rounded once to it.

K9 (`csrc/channel_norm.cu`) replaces no TPU kernel: the JAX package has no
HiFiC. It replaces the eager formula, `channel_norm_plain`, which crossed
device memory about six times an element; K9 reads each element once and
writes it once (its source note gives the design).

`channel_norm` runs the twin for a CPU tensor. For a CUDA tensor it launches
K9 on the route x's layout asks for: contiguous x takes the NCHW route,
channels_last x (the served HiFiC) the NHWC route, and the output keeps x's
layout. It raises on what K9 does not take: a tensor that needs a gradient
(K9 has no backward; HiFiC is served, not trained, here), any other stride
pattern, a dtype other than bfloat16 and float32, a channels_last x of more
than NHWC_MAX_CHANNELS channels.

A channels_last x may hold more channels than alpha and beta: the ones past
C pad each pixel's row (HiFiC pads its 60-channel rows to 64 so that cuDNN's
NHWC kernels take them as they are). They are left out of the statistics
and written 0, by K9 and by the twin alike.

`channel_norm.launches` counts K9's launches, `channel_norm.launches_nhwc`
those on the NHWC route.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from contextual_image_compression_tpu_torch.ops import cuda_kernels as ck

TILE_BYTES = 65536  # one tile of a block (csrc/channel_norm.cu keeps three)
NHWC_TILE_BYTES = 32768  # the NHWC route's: two blocks an SM
THREADS = 256       # csrc/channel_norm.cu's block; a thread takes 4 pixels
MAX_TILE_PIXELS = 4 * THREADS
LANE_QUADS = 8      # NHWC: quads of 4 channels a lane holds (csrc/channel_norm.cu)
LANE_TARGET = 4     # NHWC: quads of one pixel a lane aims at
NHWC_MAX_CHANNELS = 4 * 32 * LANE_QUADS


def _nhwc(x: torch.Tensor) -> bool:
    """Whether x is channels_last and not also contiguous (K9's NHWC route)."""
    return not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)


def channel_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                       relu: bool = False) -> torch.Tensor:
    """The eager formula: statistics and the affine step in float32, the
    ReLU before the one rounding to x's dtype. It computes in NCHW whatever
    x's layout, so a channels_last x gives the same bits, in channels_last.
    Channels of x past weight's C are padding: left out, and 0 in the
    output."""
    c = weight.shape[0]
    x32 = x.to(torch.float32, memory_format=torch.contiguous_format)
    if x.shape[1] > c:
        x32 = x32[:, :c]
    var, mean = torch.var_mean(x32, dim=1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = torch.addcmul(bias.float()[:, None, None], y, weight.float()[:, None, None])
    if relu:
        y = torch.relu_(y)
    if x.shape[1] > c:
        y = F.pad(y, (0, 0, 0, 0, 0, x.shape[1] - c))
    return y.to(x.dtype, memory_format=torch.channels_last if _nhwc(x)
                else torch.contiguous_format)


def tile_pixels(channels: int, itemsize: int) -> int:
    """K9's pixels a tile, P: the largest power of two whose tile of all
    channels keeps within TILE_BYTES, at least one 16-byte copy a channel
    row and at most MAX_TILE_PIXELS."""
    p = 16 // itemsize
    while p * 2 <= MAX_TILE_PIXELS and channels * p * 2 * itemsize <= TILE_BYTES:
        p *= 2
    return p


def nhwc_plan(row: int, itemsize: int) -> tuple:
    """K9's NHWC route for pixel rows of `row` elements: (P, L), the pixels a
    tile and the lanes a pixel. L: the least power of two, at most 32, whose
    lanes hold a row's quads at LANE_TARGET a lane; P: a multiple of the
    block's round (8 warps x 32 / L pixels x LANE_QUADS / (quads a lane)
    pixels at once) within NHWC_TILE_BYTES, one round at least. A round is a
    multiple of 8 pixels, which keeps every tile 16-byte aligned."""
    quads = -(-row // 4)
    lanes = 1
    while lanes < 32 and lanes * LANE_TARGET < quads:
        lanes *= 2
    slots = 1
    while slots * lanes < quads:
        slots *= 2
    if slots > LANE_QUADS:
        raise ValueError(f"channel_norm: channels_last rows take at most {NHWC_MAX_CHANNELS} "
                         f"elements, got {row}")
    per_round = (THREADS // 32) * (32 // lanes) * (LANE_QUADS // slots)
    return per_round * max(1, NHWC_TILE_BYTES // (row * itemsize * per_round)), lanes


def channel_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                 relu: bool = False) -> torch.Tensor:
    """ChannelNorm of x (B, C, H, W) with alpha = weight and beta = bias (C,).
    Launches K9 for a CUDA tensor, on the NCHW or the NHWC route as x is
    contiguous or channels_last; the plain twin runs for a CPU tensor. A
    channels_last x may carry channels past C (B, S, H, W): padding, left
    out of the statistics and written 0."""
    if x.device.type == "cpu":
        return channel_norm_plain(x, weight, bias, eps, relu)
    if x.device.type != "cuda":
        raise ValueError(f"channel_norm: unsupported device {x.device}")
    if ck.needs_grad(x, weight, bias):
        raise ValueError("channel_norm: K9 has no backward; call it under torch.no_grad()")
    if x.ndim != 4 or weight.ndim != 1 or bias.shape != weight.shape or \
            x.shape[1] < weight.shape[0]:
        raise ValueError("channel_norm: x must be (B, C, H, W), weight and bias (C,)")
    if weight.dtype != bias.dtype:
        raise TypeError("channel_norm: weight and bias must share a dtype")
    ck.require_cuda("channel_norm", weight, bias)
    if x.device != weight.device:
        raise ValueError(f"channel_norm: all tensors must be on {x.device}")
    b, s, h, w = x.shape
    c = weight.shape[0]
    nhwc = _nhwc(x)
    if not nhwc and (not x.is_contiguous() or s != c):
        raise ValueError("channel_norm: x must be contiguous (B, C, H, W) or channels_last")
    code = ck.dtype_code(x.dtype)
    out = torch.empty_like(x)
    lib = ck.library()
    if nhwc:
        p, lanes = nhwc_plan(s, x.element_size())
        err = lib.cic_channel_norm_nhwc(
            code, x.data_ptr(), weight.data_ptr(), bias.data_ptr(), ck.dtype_code(weight.dtype),
            out.data_ptr(), b, c, s, h, w, p, lanes, float(eps), int(relu),
            ck.stream_ptr(x.device))
    else:
        err = lib.cic_channel_norm(
            code, x.data_ptr(), weight.data_ptr(), bias.data_ptr(), ck.dtype_code(weight.dtype),
            out.data_ptr(), b, c, h, w, tile_pixels(c, x.element_size()), float(eps), int(relu),
            ck.stream_ptr(x.device))
    ck.check(err, "channel_norm")
    channel_norm.launches += 1
    channel_norm.launches_nhwc += nhwc
    return out


channel_norm.launches = 0
channel_norm.launches_nhwc = 0
