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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from contextual_image_compression_tpu_torch.models.layers import leaky_relu
from contextual_image_compression_tpu_torch.ops.generator_tail import fused_tail




def fold_tail_bn(deconv_weight, deconv_bias, bn_scale, bn_bias, bn_mean, bn_var, dtype,
                 bn_eps: float = 1e-3):
    """Fold inference BatchNorm into the deconv: (weight * scale in float32
    cast to dtype, float32 shift = bn_bias + (deconv_bias - mean) * scale)."""
    f32 = torch.float32
    scale = bn_scale.to(f32) * torch.rsqrt(bn_var.to(f32) + bn_eps)
    shift = bn_bias.to(f32) + (deconv_bias.to(f32) - bn_mean.to(f32)) * scale
    return (deconv_weight.to(f32) * scale[None, :, None, None]).to(dtype), shift


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
    if x.shape[2] != x.shape[3]:
        raise ValueError(
            "packed_tail_forward requires square spatial dims (boundary_masks "
            f"and depth_to_space4 derive both axes from H); got {x.shape[2]}x"
            f"{x.shape[3]}. Use generator_packed_tail=False for non-square "
            "img_size configs."
        )
    dt = x.dtype
    f32 = torch.float32
    folded, shift = fold_tail_bn(deconv_weight, deconv_bias, bn_scale, bn_bias, bn_mean,
                                 bn_var, dt, bn_eps)
    if use_pallas:
        return fused_tail(x, folded, shift.to(dt), out_weight.to(dt), out_bias.to(f32),
                          leaky_slope)
    y = F.conv_transpose2d(x, folded, stride=2, padding=1)
    y = leaky_relu(y + shift.to(dt)[:, None, None], leaky_slope)
    # out_conv is k4/s1 SAME: pad (1, 2) on both axes, then a VALID conv
    if int8_planar:
        amax = torch.clamp(
            torch.maximum(torch.abs(bn_bias.to(f32)), torch.abs(shift))
            + float(int8_sigma) * torch.abs(bn_scale.to(f32)),
            min=1e-6,
        )
        q = torch.clamp(torch.round(y.to(f32) * (127.0 / amax)[:, None, None]), -127.0, 127.0)
        w = (out_weight.to(f32) * (amax / 127.0)[None, :, None, None]).to(dt)
        out = F.conv2d(F.pad(q.to(dt), (1, 2, 1, 2)), w)
    else:
        out = F.conv2d(F.pad(y, (1, 2, 1, 2)), out_weight.to(dt))
    return torch.tanh(out + out_bias.to(dt)[:, None, None])
