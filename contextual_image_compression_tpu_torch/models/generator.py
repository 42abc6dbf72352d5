"""Skip-connection transposed-conv generator, in NCHW.

Counterpart of `contextual_image_compression_tpu/models/generator.py`:
    Dense(hw*hw*C0) -> reshape -> BN -> LeakyReLU   (W8A8 at inference under dense_int8)
    ConvT k4 s2 -> BN -> LReLU -> concat skip3 ; likewise skip2, skip1
    ConvT k4 s2 -> BN -> LReLU -> Conv k4 s1 -> tanh       (native tail)
or, at inference with packed_tail, the folded tail of models/packed_tail.py
(train-mode calls take the native tail, as the JAX generator does: batch
statistics cannot be folded).
The fc output is reshaped in NCHW order; `convert.py` permutes the JAX
(NHWC-order) fc columns and bias to match.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from contextual_image_compression_tpu_torch.models.layers import (
    KBatchNorm,
    KConv,
    KConvT,
    KDense,
    leaky_relu,
)
from contextual_image_compression_tpu_torch.models.packed_tail import packed_tail_forward


class Generator(nn.Module):
    def __init__(
        self,
        latent_dim: int,
        out_channels: int = 3,
        channels: Tuple[int, ...] = (256, 128, 64, 32),
        skip_channels: Tuple[int, ...] = (64, 128, 256),
        base_hw: int = 16,
        base_ch: int = 512,
        leaky_slope: float = 0.2,
        packed_tail: bool = False,
        packed_tail_int8: bool = False,
        dense_w8: bool = False,
        dense_int8: bool = False,
    ):
        super().__init__()
        if len(channels) != 4:
            raise ValueError("the generator has four deconv stages")
        self.base_hw, self.base_ch = base_hw, base_ch
        self.leaky_slope = leaky_slope
        self.packed_tail, self.packed_tail_int8 = packed_tail, packed_tail_int8
        self.fc = KDense(latent_dim, base_hw * base_hw * base_ch, w8=dense_w8,
                         int8=dense_int8)
        self.bn0 = KBatchNorm(base_ch)
        # skips concat after deconv1..3: skip3, skip2, skip1
        concat = (skip_channels[2], skip_channels[1], skip_channels[0], 0)
        cin = base_ch
        for i, (ch, extra) in enumerate(zip(channels, concat)):
            setattr(self, f"deconv{i + 1}", KConvT(cin, ch))
            setattr(self, f"bn{i + 1}", KBatchNorm(ch))
            cin = ch + extra
        self.out_conv = KConv(channels[3], out_channels, 4, 1)

    def reset_parameters(self, gen: torch.Generator):
        self.fc.reset_parameters(gen)
        for i in range(1, 5):
            getattr(self, f"deconv{i}").reset_parameters(gen)
        self.out_conv.reset_parameters(gen)

    def forward(self, latent: torch.Tensor, skips, train: bool = False) -> torch.Tensor:
        """latent (B, D), skips (skip1, skip2, skip3) NCHW -> (B, C, H, W) in
        [-1, 1]. train: BatchNorm on batch statistics (see KBatchNorm)."""
        skip1, skip2, skip3 = skips
        s = self.leaky_slope
        x = self.fc(latent, train)
        x = x.reshape(latent.shape[0], self.base_ch, self.base_hw, self.base_hw)
        x = leaky_relu(self.bn0(x, train), s)
        for i, skip in enumerate((skip3, skip2, skip1)):
            x = getattr(self, f"bn{i + 1}")(getattr(self, f"deconv{i + 1}")(x), train)
            x = torch.cat([leaky_relu(x, s), skip.to(x.dtype)], dim=1)
        if self.packed_tail and not train:
            bn = self.bn4
            return packed_tail_forward(
                x, self.deconv4.weight.to(x.dtype), self.deconv4.bias.to(x.dtype),
                bn.weight, bn.bias, bn.running_mean, bn.running_var,
                self.out_conv.weight, self.out_conv.bias.to(x.dtype),
                bn_eps=bn.eps, leaky_slope=s, int8_planar=self.packed_tail_int8,
            )
        x = leaky_relu(self.bn4(self.deconv4(x), train), s)
        return torch.tanh(self.out_conv(x))
