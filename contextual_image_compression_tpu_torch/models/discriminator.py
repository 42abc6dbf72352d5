"""Input-size-adaptive discriminator, in NCHW.

Counterpart of `contextual_image_compression_tpu/models/discriminator.py`:
num_stages = min(max(1, log2(H / 4)), max_stages) stages of
    conv k4 s2 -> LeakyReLU -> BatchNorm (from stage 1 on; activation first)
with filters starting at base_filters and doubling up to max_filters, then
    flatten -> Dense(dense_units) -> LeakyReLU -> Dense(1) -> sigmoid.
The flatten is in NCHW order; `convert.py` permutes the JAX (NHWC-order)
`dense` rows to match. The GAN step runs BatchNorm on its running statistics
(`disc_bn_mode='frozen'`) unless asked for batch statistics. `dtype` is the
compute dtype (bfloat16 under mixed precision, as the JAX codec builds D
with the model's dtype); the parameters and statistics stay float32.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn

from contextual_image_compression_tpu_torch.models.layers import (
    KBatchNorm,
    KConv,
    KDense,
    leaky_relu,
)


def disc_geometry(img_size: Tuple[int, int], base_filters: int = 16, max_filters: int = 128,
                  max_stages: int = 4):
    """(filters per stage, final spatial size) for a square power-of-two input."""
    h, w = img_size
    if h != w or h & (h - 1):
        raise ValueError(f"the discriminator takes square power-of-two inputs, got {img_size}")
    stages = min(max(1, int(math.log2(h / 4))), max_stages)
    filters, f = [], base_filters
    for _ in range(stages):
        filters.append(f)
        f = min(f * 2, max_filters)
    return tuple(filters), h >> stages


class Discriminator(nn.Module):
    def __init__(
        self,
        img_size: Tuple[int, int] = (256, 256),
        in_channels: int = 3,
        base_filters: int = 16,
        max_filters: int = 128,
        max_stages: int = 4,
        dense_units: int = 128,
        leaky_slope: float = 0.2,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.dtype = dtype
        filters, hw = disc_geometry(img_size, base_filters, max_filters, max_stages)
        self.leaky_slope = leaky_slope
        self.num_stages = len(filters)
        cin = in_channels
        for i, f in enumerate(filters):
            setattr(self, f"conv{i}", KConv(cin, f, 4, 2))
            if i > 0:
                setattr(self, f"bn{i}", KBatchNorm(f))
            cin = f
        self.dense = KDense(cin * hw * hw, dense_units)
        self.out = KDense(dense_units, 1)

    def reset_parameters(self, gen: torch.Generator):
        """Glorot-uniform kernels, zero biases, BatchNorm identity."""
        for i in range(self.num_stages):
            getattr(self, f"conv{i}").reset_parameters(gen)
        self.dense.reset_parameters(gen)
        self.out.reset_parameters(gen)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x (B, 3, H, W) in [-1, 1] -> (B, 1) probabilities in the compute
        dtype, which x is cast to first."""
        s = self.leaky_slope
        x = x.to(self.dtype)
        for i in range(self.num_stages):
            x = leaky_relu(getattr(self, f"conv{i}")(x), s)
            if i > 0:
                x = getattr(self, f"bn{i}")(x, train)
        x = leaky_relu(self.dense(x.reshape(x.shape[0], -1)), s)
        return torch.sigmoid(self.out(x))
