"""Keras-style Adam: per-tensor norm clipping, then Adam with eps 1e-7.

Counterpart of `contextual_image_compression_tpu/train/optimizers.py`
(`optax.chain(clip_per_leaf_norm(clipnorm), optax.adam(...))`). Keras'
`clipnorm` clips each gradient tensor to the norm on its own, not the global
norm of all of them, and floors the norm at 1e-12, which
`torch.nn.utils.clip_grad_norm_` (global norm, divides by norm + 1e-6) does
not do. `torch.optim.Adam(eps=...)` computes optax's update
m_hat / (sqrt(v_hat) + eps), eps outside the root.
"""

from __future__ import annotations

from typing import Iterable, List

import torch


@torch.no_grad()
def clip_per_leaf_norm_(grads: Iterable[torch.Tensor], max_norm: float) -> None:
    """In place, for each tensor: g *= min(1, max_norm / max(||g||_2, 1e-12))."""
    for g in grads:
        norm = torch.linalg.vector_norm(g)
        g.mul_(torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0))


class KerasAdam:
    """Adam over `params` with keras' per-tensor clipnorm (the JAX package's
    `keras_adam` chain). Like optax, it
    updates every parameter of its group each step: a parameter without a
    gradient is stepped with a zero one."""

    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: float,
                 clipnorm: float = 1.0, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-7):
        self.params: List[torch.nn.Parameter] = list(params)
        self.clipnorm = clipnorm
        self.adam = torch.optim.Adam(self.params, lr=learning_rate, betas=(b1, b2), eps=eps)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_per_leaf_norm_([p.grad for p in self.params], self.clipnorm)
        self.adam.step()

