"""Keras-style Adam: per-tensor norm clipping, then Adam with eps 1e-7.

Counterpart of `contextual_image_compression_tpu/train/optimizers.py`
(`optax.chain(clip_per_leaf_norm(clipnorm), optax.adam(...))`). Keras'
`clipnorm` clips each gradient tensor to the norm on its own, not the global
norm of all of them, and floors the norm at 1e-12, which
`torch.nn.utils.clip_grad_norm_` (global norm, divides by norm + 1e-6) does
not do. `torch.optim.Adam(eps=...)` computes optax's update
m_hat / (sqrt(v_hat) + eps), eps outside the root.

A parameter of another dtype than float32 (ModelConfig.param_dtype
'bfloat16') is stepped in optax's order instead, in its own dtype, as optax
does it: the moments mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu
in the parameter's dtype, each constant rounded to that dtype first (JAX's
weakly typed scalars: b2 = 0.999 is 1.0 in bf16), the bias corrections
1 - b^t in float32 and then rounded, u = mu_hat / (sqrt(nu_hat) + eps)
scaled by -lr, and p + u rounded to the parameter's dtype. torch.optim.Adam
would fold the corrections into the step size and the root. The moments
live in the torch Adam's state (`exp_avg`, `exp_avg_sq`, `step`), so
checkpoints carry them either way.

On a mesh, a parameter split over the model axis (parallel/sharding.py)
is clipped by the norm of the whole tensor: the slices' squared norms are
summed over the model group first. Adam itself is elementwise on each
rank's slice.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch

from contextual_image_compression_tpu_torch.models.layers import const


@torch.no_grad()
def clip_per_leaf_norm_(grads: Iterable[torch.Tensor], max_norm: float,
                        shards: Optional[Sequence] = None) -> None:
    """In place, for each tensor: g *= min(1, max_norm / max(||g||_2, 1e-12)).
    `shards`: each tensor's split over the model group (parallel/sharding.py
    `Shard`) or None; a split tensor's norm is the whole tensor's."""
    grads = list(grads)
    norms = [torch.linalg.vector_norm(g) for g in grads]
    split = [i for i, s in enumerate(shards or ()) if s is not None]
    if split:  # one all_reduce for every split leaf (they share the model group)
        sq = torch.stack([norms[i].float() ** 2 for i in split])
        shards[split[0]].group.all_reduce_(sq)
        for j, i in enumerate(split):
            norms[i] = torch.sqrt(sq[j]).to(norms[i].dtype)
    for g, norm in zip(grads, norms):
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
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.adam = torch.optim.Adam(self.params, lr=learning_rate, betas=(b1, b2), eps=eps)
        # each parameter's split over the model group, set when the optimizer
        # is placed on a mesh (parallel/sharding.py shard_state)
        self.shards: List[Optional[object]] = [None] * len(self.params)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_per_leaf_norm_([p.grad for p in self.params], self.clipnorm, self.shards)
        if all(p.dtype == torch.float32 for p in self.params):
            self.adam.step()
            return
        for p in self.params:
            self._optax_step(p)

    @torch.no_grad()
    def _optax_step(self, p: torch.nn.Parameter) -> None:
        """optax.adam's update and apply_updates on one parameter, in its dtype."""
        dt, dev = p.dtype, p.device

        def c(v):
            return const(v, dt, dev)

        st = self.adam.state[p]
        g = p.grad
        mu = st.get("exp_avg", torch.zeros_like(p))
        nu = st.get("exp_avg_sq", torch.zeros_like(p))
        count = int(st["step"]) + 1 if "step" in st else 1
        mu = c(1 - self.b1) * g + c(self.b1) * mu
        nu = c(1 - self.b2) * (g * g) + c(self.b2) * nu
        t = torch.full((), float(count), dtype=torch.float32, device=dev)
        one = torch.ones((), dtype=torch.float32, device=dev)
        bc1 = (one - torch.full_like(one, self.b1) ** t).to(dt)
        bc2 = (one - torch.full_like(one, self.b2) ** t).to(dt)
        update = (mu / bc1) / (torch.sqrt(nu / bc2 + c(0.0)) + c(self.eps))
        p.copy_((p + c(-self.lr) * update).to(dt))
        self.adam.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                              "exp_avg": mu, "exp_avg_sq": nu}
