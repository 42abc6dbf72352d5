"""HQ/LQ convolutional encoder with skip outputs, in NCHW.

Counterpart of `contextual_image_compression_tpu/models/encoder.py`:
    conv k4 s2 -> LeakyReLU                  -> skip1
    conv k4 s2 -> BN -> LeakyReLU            -> skip2
    conv k4 s2 -> BN -> LeakyReLU            -> skip3 (taken before attention)
    [SelfAttention, HQ only]
    conv k4 s2 -> BN -> LeakyReLU -> flatten -> Dense(latent_dim)
(the latent Dense W8A8 at inference under dense_int8, as in the JAX encoder)
The flatten is in NCHW order; `convert.py` permutes the JAX (NHWC-order)
latent_dense rows to match, so no permute runs here.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from contextual_image_compression_tpu_torch.models.attention import SelfAttention
from contextual_image_compression_tpu_torch.models.layers import (
    KBatchNorm,
    KConv,
    KDense,
    leaky_relu,
)


class Encoder(nn.Module):
    def __init__(
        self,
        latent_dim: int,
        img_size: Tuple[int, int] = (256, 256),
        in_channels: int = 3,
        add_attention: bool = True,
        channels: Tuple[int, ...] = (64, 128, 256, 512),
        leaky_slope: float = 0.2,
        dense_w8: bool = False,
        dense_int8: bool = False,
    ):
        super().__init__()
        c1, c2, c3, c4 = channels
        self.leaky_slope = leaky_slope
        self.conv1 = KConv(in_channels, c1, 4, 2)
        self.conv2 = KConv(c1, c2, 4, 2)
        self.bn2 = KBatchNorm(c2)
        self.conv3 = KConv(c2, c3, 4, 2)
        self.bn3 = KBatchNorm(c3)
        self.attention = SelfAttention(c3) if add_attention else None
        self.conv4 = KConv(c3, c4, 4, 2)
        self.bn4 = KBatchNorm(c4)
        flat = c4 * (img_size[0] // 16) * (img_size[1] // 16)
        self.latent_dense = KDense(flat, latent_dim, w8=dense_w8, int8=dense_int8)

    def reset_parameters(self, gen: torch.Generator):
        for m in (self.conv1, self.conv2, self.conv3, self.conv4, self.latent_dense):
            m.reset_parameters(gen)
        if self.attention is not None:
            self.attention.reset_parameters(gen)

    def forward(self, x: torch.Tensor, train: bool = False):
        """x: (B, 3, H, W) -> latent (B, D), skips (NCHW). train: BatchNorm
        on batch statistics (see KBatchNorm)."""
        s = self.leaky_slope
        x1 = leaky_relu(self.conv1(x), s)
        x2 = leaky_relu(self.bn2(self.conv2(x1), train), s)
        x3 = leaky_relu(self.bn3(self.conv3(x2), train), s)
        skips = (x1, x2, x3)
        if self.attention is not None:
            x3 = self.attention(x3)
        x4 = leaky_relu(self.bn4(self.conv4(x3), train), s)
        latent = self.latent_dense(x4.reshape(x4.shape[0], -1), train)
        return latent, skips
