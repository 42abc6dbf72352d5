"""The generator's inference tail with BatchNorm folded into the last deconv.

Counterpart of `contextual_image_compression_tpu/models/packed_tail.py::
packed_tail_forward`. The JAX module evaluates deconv4 -> BN -> LeakyReLU ->
out_conv -> tanh in a phase-planar layout packed for the TPU's matrix unit;
the layout changes no value, so the port runs the same numerics in pixel
layout:

  * fold BN into the deconv in float32 (scale = bn_scale * rsqrt(var + eps),
    kernel * scale cast to the compute dtype) and shift = bn_bias +
    (deconv_bias - mean) * scale;
  * deconv without bias, + shift, LeakyReLU;
  * int8 form (serving): per channel amax = max(max(|bn_bias|, |shift|) +
    8 |bn_scale|, 1e-6), q = clip(rint(y * 127 / amax), +-127), and out_conv
    runs on q with weights W * amax / 127 cast to the compute dtype;
  * + bias, tanh.

`use_pallas=True` is the counterpart of the JAX `fused_tail_pallas`: K8
(`ops/generator_tail.py`) on CUDA tensors, its twin on CPU tensors. As in JAX,
that path ignores `int8_planar`.

The int8 form's operands (the folded deconv weight, shift, 127 / amax, the
scaled out-conv weight, the bias) are `fold_int8_tail`'s `Int8Tail`;
`packed_tail_forward(int8_planar=True)` folds them on every call and runs
`int8_tail_plain` (cuDNN's transposed conv and conv, elementwise passes
between them). A generator folds them once and keeps them
(`Generator._int8_operands`) and calls `int8_tail_forward`, which takes K8's
int8 route (`ops/generator_tail.py::int8_tail`: one launch, the deconv
rounded to bf16 once as in the XLA path) for a square bf16 CUDA input within
the kernel's widths (Cin <= 128, Cmid <= 32, Co <= 4), and
`int8_tail_plain`, its eager twin, for anything else.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from contextual_image_compression_tpu_torch.models.layers import leaky_relu
from contextual_image_compression_tpu_torch.ops import generator_tail
from contextual_image_compression_tpu_torch.ops.generator_tail import fused_tail


class Int8Tail(NamedTuple):
    """The int8 tail's operands, in the compute dtype dt unless stated."""

    folded: torch.Tensor      # (Cin, Cmid, 4, 4): deconv weight * BN scale
    shift: torch.Tensor       # (Cmid,)
    inv_amax: torch.Tensor    # (Cmid,) float32: 127 / amax
    out_weight: torch.Tensor  # (Co, Cmid, 4, 4): out-conv weight * amax / 127
    out_bias: torch.Tensor    # (Co,)
    leaky_slope: float
    taps: Optional[torch.Tensor] = None  # K8's tap tiles of `folded` (bf16 only)


def _require_square(x: torch.Tensor) -> None:
    if x.shape[2] != x.shape[3]:
        raise ValueError(
            "packed_tail_forward requires square spatial dims (boundary_masks "
            f"and depth_to_space4 derive both axes from H); got {x.shape[2]}x"
            f"{x.shape[3]}. Use generator_packed_tail=False for non-square "
            "img_size configs."
        )


def fold_tail_bn(deconv_weight, deconv_bias, bn_scale, bn_bias, bn_mean, bn_var, dtype,
                 bn_eps: float = 1e-3):
    """Fold inference BatchNorm into the deconv: (weight * scale in float32
    cast to dtype, float32 shift = bn_bias + (deconv_bias - mean) * scale)."""
    f32 = torch.float32
    scale = bn_scale.to(f32) * torch.rsqrt(bn_var.to(f32) + bn_eps)
    shift = bn_bias.to(f32) + (deconv_bias.to(f32) - bn_mean.to(f32)) * scale
    return (deconv_weight.to(f32) * scale[None, :, None, None]).to(dtype), shift


def fold_int8_tail(deconv_weight, deconv_bias, bn_scale, bn_bias, bn_mean, bn_var, out_weight,
                   out_bias, dtype, *, bn_eps: float = 1e-3, leaky_slope: float = 0.2,
                   int8_sigma: float = 8.0, pack: bool = False) -> Int8Tail:
    """The int8 form's operands: BN folded into the deconv (`fold_tail_bn`),
    per channel amax = max(max(|bn_bias|, |shift|) + sigma |bn_scale|, 1e-6)
    in float32, 127 / amax, the out-conv weight times amax / 127 cast to
    dtype, shift and the bias in dtype. pack: also K8's tap tiles (bf16)."""
    f32 = torch.float32
    folded, shift = fold_tail_bn(deconv_weight, deconv_bias, bn_scale, bn_bias, bn_mean, bn_var,
                                 dtype, bn_eps)
    amax = torch.clamp(
        torch.maximum(torch.abs(bn_bias.to(f32)), torch.abs(shift))
        + float(int8_sigma) * torch.abs(bn_scale.to(f32)),
        min=1e-6,
    )
    w = (out_weight.to(f32) * (amax / 127.0)[None, :, None, None]).to(dtype)
    taps = generator_tail._pack_tap_tiles(folded) if pack and dtype == torch.bfloat16 else None
    return Int8Tail(folded, shift.to(dtype), 127.0 / amax, w, out_bias.to(dtype),
                    float(leaky_slope), taps)


def int8_tail_plain(x: torch.Tensor, t: Int8Tail) -> torch.Tensor:
    """The int8 tail in PyTorch (cuDNN on the card): deconv, + shift,
    LeakyReLU, q = clip(rint(y * 127 / amax), +-127) in float32, out_conv
    (k4/s1 SAME: pad (1, 2) on both axes, then a VALID conv) on q, + bias,
    tanh. The eager twin of K8's int8 route."""
    dt = x.dtype
    y = F.conv_transpose2d(x, t.folded, stride=2, padding=1)
    y = leaky_relu(y + t.shift[:, None, None], t.leaky_slope)
    q = torch.clamp(torch.round(y.to(torch.float32) * t.inv_amax[:, None, None]), -127.0, 127.0)
    out = F.conv2d(F.pad(q.to(dt), (1, 2, 1, 2)), t.out_weight)
    return torch.tanh(out + t.out_bias[:, None, None])


def takes_int8_route(x: torch.Tensor, t: Int8Tail) -> bool:
    """Whether `int8_tail_forward` launches K8's int8 route for x: a square
    bf16 CUDA input, the tap tiles packed, Cin <= 128, Cmid <= 32, Co <= 4."""
    cin, cmid = t.folded.shape[:2]
    return (x.device.type == "cuda" and x.dtype == torch.bfloat16 and t.taps is not None
            and x.shape[2] == x.shape[3] and cin <= 128 and cmid <= 32
            and t.out_weight.shape[0] <= 4)


def int8_tail_forward(x: torch.Tensor, t: Int8Tail) -> torch.Tensor:
    """The int8 tail from folded operands: K8's int8 route where
    `takes_int8_route`, else `int8_tail_plain`."""
    _require_square(x)
    if takes_int8_route(x, t):
        return generator_tail.int8_tail(x, t.taps, t.shift, t.inv_amax, t.out_weight,
                                        t.out_bias, t.leaky_slope)
    return int8_tail_plain(x, t)


def packed_tail_forward(
    x: torch.Tensor,
    deconv_weight: torch.Tensor,
    deconv_bias: torch.Tensor,
    bn_scale: torch.Tensor,
    bn_bias: torch.Tensor,
    bn_mean: torch.Tensor,
    bn_var: torch.Tensor,
    out_weight: torch.Tensor,
    out_bias: torch.Tensor,
    *,
    bn_eps: float = 1e-3,
    leaky_slope: float = 0.2,
    use_pallas: bool = False,
    int8_planar: bool = False,
    int8_sigma: float = 8.0,
) -> torch.Tensor:
    """x: (B, Cin, H, W); deconv_weight (Cin, Cmid, 4, 4) in the port's
    transposed-conv layout; out_weight (Cout, Cmid, 4, 4). Returns the tanh
    output (B, Cout, 2H, 2W) in x's dtype. use_pallas=True runs K8
    (`fused_tail`) and ignores int8_planar; False runs cuDNN's transposed
    conv and conv, the counterpart of the JAX package's default XLA path."""
    _require_square(x)
    dt = x.dtype
    if int8_planar and not use_pallas:
        return int8_tail_plain(x, fold_int8_tail(
            deconv_weight, deconv_bias, bn_scale, bn_bias, bn_mean, bn_var, out_weight,
            out_bias, dt, bn_eps=bn_eps, leaky_slope=leaky_slope, int8_sigma=int8_sigma))
    folded, shift = fold_tail_bn(deconv_weight, deconv_bias, bn_scale, bn_bias, bn_mean,
                                 bn_var, dt, bn_eps)
    if use_pallas:
        return fused_tail(x, folded, shift.to(dt), out_weight.to(dt), out_bias.to(torch.float32),
                          leaky_slope)
    y = F.conv_transpose2d(x, folded, stride=2, padding=1)
    y = leaky_relu(y + shift.to(dt)[:, None, None], leaky_slope)
    # out_conv is k4/s1 SAME: pad (1, 2) on both axes, then a VALID conv
    out = F.conv2d(F.pad(y, (1, 2, 1, 2)), out_weight.to(dt))
    return torch.tanh(out + out_bias.to(dt)[:, None, None])
