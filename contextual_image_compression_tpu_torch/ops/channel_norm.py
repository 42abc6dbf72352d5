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
K9, or raises on what K9 does not take: a tensor that needs a gradient (K9
has no backward; HiFiC is served, not trained, here), a tensor that is not
contiguous, a dtype other than bfloat16 and float32.
"""

from __future__ import annotations

import torch

from contextual_image_compression_tpu_torch.ops import cuda_kernels as ck

TILE_BYTES = 65536  # one tile of a block (csrc/channel_norm.cu keeps three)
THREADS = 256       # csrc/channel_norm.cu's block; a thread takes 4 pixels
MAX_TILE_PIXELS = 4 * THREADS


def channel_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                       relu: bool = False) -> torch.Tensor:
    """The eager formula: statistics and the affine step in float32, the
    ReLU before the one rounding to x's dtype."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=1, keepdim=True, correction=0)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = torch.addcmul(bias.float()[:, None, None], y, weight.float()[:, None, None])
    if relu:
        y = torch.relu_(y)
    return y.to(x.dtype)


def tile_pixels(channels: int, itemsize: int) -> int:
    """K9's pixels a tile, P: the largest power of two whose tile of all
    channels keeps within TILE_BYTES, at least one 16-byte copy a channel
    row and at most MAX_TILE_PIXELS."""
    p = 16 // itemsize
    while p * 2 <= MAX_TILE_PIXELS and channels * p * 2 * itemsize <= TILE_BYTES:
        p *= 2
    return p


def channel_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                 relu: bool = False) -> torch.Tensor:
    """ChannelNorm of x (B, C, H, W) with alpha = weight and beta = bias (C,).
    Launches K9 for a CUDA tensor; the plain twin runs for a CPU tensor."""
    if x.device.type == "cpu":
        return channel_norm_plain(x, weight, bias, eps, relu)
    if x.device.type != "cuda":
        raise ValueError(f"channel_norm: unsupported device {x.device}")
    if ck.needs_grad(x, weight, bias):
        raise ValueError("channel_norm: K9 has no backward; call it under torch.no_grad()")
    if x.ndim != 4 or weight.shape != (x.shape[1],) or bias.shape != (x.shape[1],):
        raise ValueError("channel_norm: x must be (B, C, H, W), weight and bias (C,)")
    if weight.dtype != bias.dtype:
        raise TypeError("channel_norm: weight and bias must share a dtype")
    ck.require_cuda("channel_norm", x, weight, bias)
    b, c, h, w = x.shape
    out = torch.empty_like(x)
    err = ck.library().cic_channel_norm(
        ck.dtype_code(x.dtype), x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        ck.dtype_code(weight.dtype), out.data_ptr(), b, c, h, w,
        tile_pixels(c, x.element_size()), float(eps), int(relu), ck.stream_ptr(x.device),
    )
    ck.check(err, "channel_norm")
    channel_norm.launches += 1
    return out


channel_norm.launches = 0
