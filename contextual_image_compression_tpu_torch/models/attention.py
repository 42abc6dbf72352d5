"""SAGAN self-attention layer, gamma * softmax(QK^T)V + x through kernel K2.

Counterpart of `contextual_image_compression_tpu/models/attention.py`. The
1x1 Q/K/V projections run as matrix products over the (B, HW, C) view of the
input (the parameters keep the 1x1 conv layout); gamma starts at zero, so a
fresh init never shows the attention term. use_pallas=False computes the
block by the JAX package's jnp formula (`attention_block_jnp`): no K2.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from contextual_image_compression_tpu_torch.models.layers import KConv, used
from contextual_image_compression_tpu_torch.ops.attention import attention_block


class SelfAttention(nn.Module):
    def __init__(self, channels: int, use_pallas: bool = True):
        super().__init__()
        self.use_pallas = use_pallas
        inner = channels // 8
        self.query_conv = KConv(channels, inner, 1, 1)
        self.key_conv = KConv(channels, inner, 1, 1)
        self.value_conv = KConv(channels, channels, 1, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def reset_parameters(self, gen: torch.Generator):
        for conv in (self.query_conv, self.key_conv, self.value_conv):
            conv.reset_parameters(gen)
        nn.init.zeros_(self.gamma)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, C, H, W) -> (B, C, H, W)."""
        b, c, h, w = x.shape
        dt = x.dtype
        xf = x.flatten(2).transpose(1, 2)  # (B, HW, C)

        def proj(conv):
            w = used(conv, "weight")
            wm = w.to(dt).reshape(w.shape[0], c)
            return F.linear(xf, wm) + used(conv, "bias").to(dt)

        q, k, v = proj(self.query_conv), proj(self.key_conv), proj(self.value_conv)
        out = attention_block(q, k, v, xf.contiguous(), self.gamma.to(dt)[0],
                              use_pallas=self.use_pallas)
        return out.transpose(1, 2).reshape(b, c, h, w)
