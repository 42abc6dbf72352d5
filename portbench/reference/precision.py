"""Roundings of the reference and of its controls.

The reference computes in float32 (`FLOAT32`: nothing rounded). A control
is the same reference computed one precision step below the
configuration's: a `Rounding` rounds the operands of every product
(convolutions, dense layers, the attention's products) and, where the
lower precision also stores its tensors so, every result a layer keeps:

  * `FP8`: per-tensor scaled float8 e4m3 (amax mapped to 448), operands
    and results, the step below bfloat16 serving;
  * `TF32`: operands rounded to TF32's 10-bit mantissa, results float32,
    the step below float32 with TF32 off (the tensor cores' TF32 products
    round their inputs so and sum in float32);
  * `BF16`: bfloat16 results, the step below the float32 mask engine.

The rounding passes the gradient straight through, so a training control
differentiates as the reference does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

E4M3_MAX = 448.0


def _straight_through(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    if x.requires_grad:
        return x + (rounded - x).detach()
    return rounded


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    return _straight_through(x, x.detach().to(torch.bfloat16).to(x.dtype))


def fp8(x: torch.Tensor) -> torch.Tensor:
    xd = x.detach()
    scale = torch.clamp(xd.abs().amax().float(), min=1e-30) / E4M3_MAX
    q = (xd.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return _straight_through(x, q.to(x.dtype))


def tf32(x: torch.Tensor) -> torch.Tensor:
    xd = x.detach().float().contiguous()
    bits = xd.view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return _straight_through(x, rounded.to(x.dtype))


class Rounding(NamedTuple):
    operands: Callable[[torch.Tensor], torch.Tensor]
    results: Callable[[torch.Tensor], torch.Tensor]


FLOAT32 = Rounding(identity, identity)
FP8 = Rounding(fp8, fp8)
TF32 = Rounding(tf32, identity)
BF16 = Rounding(bf16, bf16)
