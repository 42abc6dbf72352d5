"""What the photo codecs (models/hific.py, models/tcm.py) share of their
entropy model and their answer, one body for both:

  * `PhotoOutput`: x_hat, the symbols of y and z, bits per image;
  * `quantize(v, offset)`: symbols round(v - offset) and v_hat = symbols +
    offset, in float32 (z against its per-channel offsets, y against mu);
  * `FactorizedPrior`: Balle et al. 2018's factorized density of z (TF-
    Compression's and CompressAI's `EntropyBottleneck`), filters from the
    configuration;
  * `gaussian_likelihood`: the Gaussian conditional's likelihood of y's
    symbols;
  * `bits`: -sum log2 of both likelihoods, each bounded below, per image;
  * `uniform_`: the seeded uniform draw the codecs' `reset_parameters` use.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class PhotoOutput(NamedTuple):
    x_hat: torch.Tensor     # (B, 3, H, W), compute dtype, channels_last
    y_symbols: torch.Tensor  # (B, C_y, H / 16, W / 16) float32 integers
    z_symbols: torch.Tensor  # (B, C_z, H / 64, W / 64) float32 integers
    bits: torch.Tensor      # (B,) float32


def uniform_(t: torch.Tensor, std: float, gen: torch.Generator, mean: float = 0.0):
    """Uniform values of the given mean and standard deviation, drawn in
    float32 and rounded to t's dtype."""
    half = std * math.sqrt(3.0)
    with torch.no_grad():
        draw = torch.empty(t.shape, dtype=torch.float32, device=t.device)
        t.copy_(draw.uniform_(mean - half, mean + half, generator=gen))
    return t


def quantize(v: torch.Tensor, offset: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(symbols, dequantized): round(v - offset) and symbols + offset."""
    symbols = torch.round(v - offset)
    return symbols, symbols + offset


class FactorizedPrior(nn.Module):
    """Balle et al. 2018's factorized density of z, one per channel: the
    cumulative's logits f(v) through layers of widths 1 -> filters -> 1,
    v <- softplus(H_k) v + b_k, then v <- v + tanh(a_k) tanh(v) but after
    the last; the likelihood of an integer-offset value v is
    sigmoid(f(v + 0.5)) - sigmoid(f(v - 0.5)), taken on the side where the
    sigmoids are small. `offset` holds the quantization offsets m (the
    medians of CompressAI's EntropyBottleneck)."""

    def __init__(self, channels: int, filters=(3, 3, 3)):
        super().__init__()
        self.dims = (1,) + tuple(filters) + (1,)
        c = channels
        for k in range(len(self.dims) - 1):
            a, b = self.dims[k], self.dims[k + 1]
            self.register_parameter(f"matrix{k}", nn.Parameter(torch.zeros(c, b, a)))
            self.register_parameter(f"bias{k}", nn.Parameter(torch.zeros(c, b, 1)))
            if k < len(self.dims) - 2:
                self.register_parameter(f"factor{k}", nn.Parameter(torch.zeros(c, b, 1)))
        self.offset = nn.Parameter(torch.zeros(c))

    def reset_parameters(self, gen: torch.Generator, init_scale: float = 10.0) -> None:
        """TF-Compression's initial density (init_scale 10), biases and the
        offsets uniform in +-0.5, small seeded factors."""
        layers = len(self.dims) - 1
        scale = init_scale ** (1.0 / layers)
        for k in range(layers):
            init = math.log(math.expm1(1.0 / scale / self.dims[k + 1]))
            uniform_(getattr(self, f"matrix{k}"), 0.05, gen, mean=init)
            uniform_(getattr(self, f"bias{k}"), 1.0 / math.sqrt(12.0), gen)
            if k < layers - 1:
                uniform_(getattr(self, f"factor{k}"), 0.05, gen)
        uniform_(self.offset, 1.0 / math.sqrt(12.0), gen)

    def _logits(self, v: torch.Tensor) -> torch.Tensor:
        layers = len(self.dims) - 1
        for k in range(layers):
            v = torch.matmul(F.softplus(getattr(self, f"matrix{k}").float()), v)
            v = v + getattr(self, f"bias{k}").float()
            if k < layers - 1:
                v = v + torch.tanh(getattr(self, f"factor{k}").float()) * torch.tanh(v)
        return v

    def likelihood(self, z_hat: torch.Tensor) -> torch.Tensor:
        """Likelihood of each value of z_hat (B, C, h, w), float32."""
        b, c, h, w = z_hat.shape
        v = z_hat.float().transpose(0, 1).reshape(c, 1, -1)
        lower, upper = self._logits(v - 0.5), self._logits(v + 0.5)
        sign = -torch.sign(lower + upper)
        lik = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
        return lik.reshape(c, b, h, w).transpose(0, 1)


def gaussian_likelihood(symbols: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Phi((0.5 - |s|) / sigma) - Phi((-0.5 - |s|) / sigma), float32."""
    v = torch.abs(symbols)
    c = -math.sqrt(0.5)
    upper = 0.5 * torch.erfc(c * (0.5 - v) / sigma)
    lower = 0.5 * torch.erfc(c * (-0.5 - v) / sigma)
    return upper - lower


def bits(lik_y: torch.Tensor, lik_z: torch.Tensor, floor: float) -> torch.Tensor:
    """-sum log2 of both likelihoods, each bounded below at floor, per image."""
    lik_y, lik_z = torch.clamp(lik_y, min=floor), torch.clamp(lik_z, min=floor)
    return -(torch.log2(lik_y).sum(dim=(1, 2, 3)) + torch.log2(lik_z).sum(dim=(1, 2, 3)))
