"""The baseline skip-connection convolutional autoencoder.

Counterpart of `contextual_image_compression_tpu/models/autoencoder.py`:
(B, 3, 128, 128) in [0, 1] -> a (B, 64, 32, 32) bottleneck -> sigmoid
output. 3x3 SAME convolutions with ReLU, 2x2 max-pools (SAME, stride 2: an
odd edge pools over what is there), nearest 2x upsampling, and the decoder
concatenates re-convolved encoder features. NCHW here; the submodules are
named like the flax module's, so convert.py carries its variables over.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from contextual_image_compression_tpu_torch.models.layers import KConv


def _pool2(x: torch.Tensor) -> torch.Tensor:
    """flax max_pool (2, 2), strides 2, SAME: the -inf pad of an odd edge
    is ceil_mode's partial window."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """jax.image.resize(..., 'nearest') to twice the size: each pixel repeated."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class Autoencoder(nn.Module):
    def __init__(self, out_channels: int = 3, enc_channels: Tuple[int, int] = (32, 64),
                 in_channels: int = 3):
        super().__init__()
        c1, c2 = enc_channels
        self.enc_conv1 = KConv(in_channels, c1, 3, 1)
        self.enc_conv2 = KConv(c1, c2, 3, 1)
        self.dec_conv1 = KConv(c2, c2, 3, 1)
        self.skip_conv2 = KConv(c2, c2, 3, 1)
        self.dec_conv2 = KConv(2 * c2, c1, 3, 1)
        self.skip_conv1 = KConv(c1, c1, 3, 1)
        self.out_conv = KConv(2 * c1, out_channels, 3, 1)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Glorot-uniform kernels and zero biases (flax's KConv init), in
        the order the submodules are declared."""
        for mod in self.children():
            mod.reset_parameters(gen)

    def _encode(self, x: torch.Tensor):
        x1 = F.relu(self.enc_conv1(x))
        x2 = F.relu(self.enc_conv2(_pool2(x1)))
        return _pool2(x2), x1, x2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) in [0, 1] -> the reconstruction, same shape."""
        encoded, x1, x2 = self._encode(x)
        y = _upsample2(F.relu(self.dec_conv1(encoded)))
        y = torch.cat([y, F.relu(self.skip_conv2(x2))], dim=1)
        y = _upsample2(F.relu(self.dec_conv2(y)))
        y = torch.cat([y, F.relu(self.skip_conv1(x1))], dim=1)
        return torch.sigmoid(self.out_conv(y))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The bottleneck features (for the analytic compression accounting)."""
        return self._encode(x)[0]
