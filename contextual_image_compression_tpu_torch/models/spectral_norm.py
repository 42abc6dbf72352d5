"""Spectral-normalized dense layer.

Counterpart of `contextual_image_compression_tpu/models/spectral_norm.py`,
which the reference defines and never calls (its discriminator leaves it
out). One power-iteration step per call on the (in, out) kernel W:

    v = l2(u W^T), u' = l2(v W), sigma = v W u'^T, y = x (W / sigma) + b

with l2(z) = z / sqrt(max(sum z^2, 1e-12)). The `u` buffer (1, out) starts
at 1 / sqrt(out) and takes u' only when `update_stats` (the reference
updates it only in training). Gradients flow through v, u' and sigma, as in
the JAX layer; the stored u is detached. The weight is kept (out, in), as
the port's dense layers keep theirs; convert.py maps flax's `kernel`, `bias`
and the `spectral_stats` collection's `u`.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from contextual_image_compression_tpu_torch.models.layers import glorot_uniform_


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.sqrt(torch.clamp(torch.sum(x * x), min=eps))


class SpectralNormDense(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, cin))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("u", self._initial_u(features))

    @staticmethod
    def _initial_u(features: int) -> torch.Tensor:
        # 1 / sqrt(out) in float32 arithmetic, as the JAX initializer computes it
        one = torch.ones((), dtype=torch.float32)
        return torch.full((1, features), float(one / torch.sqrt(one * features)))

    def reset_parameters(self, gen: torch.Generator):
        """Glorot-uniform weight, zero bias, u back to 1 / sqrt(out)."""
        glorot_uniform_(self.weight, self.weight.shape[1], self.weight.shape[0], gen)
        nn.init.zeros_(self.bias)
        with torch.no_grad():
            self.u.copy_(self._initial_u(self.weight.shape[0]))

    def forward(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        w = self.weight.t()  # (in, out), the JAX kernel
        v_hat = _l2_normalize(self.u @ w.t())
        u_new = _l2_normalize(v_hat @ w)
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u_new)
        sigma = (v_hat @ w @ u_new.t())[0, 0]
        return x @ (w / sigma) + self.bias
