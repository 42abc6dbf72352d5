"""Differentiable collectives over a mesh group, on all_reduce and all_gather.

One process per device computes what JAX's SPMD step computes on the global
batch, so every place where the global batch meets is one of these. Two
kinds of output differ in their backward:

  * replicated: every member goes on to compute the same thing from the
    output (a global loss, a tensor-parallel product that the whole model
    group uses). Each member's gradient of it is the whole gradient, so the
    backward passes it through (`sum_replicated`) or keeps the member's own
    part (`gather_replicated`).
  * per-member: each member uses the output on its own data (BatchNorm's
    batch statistics, the perceptual z-scores' moments). The gradient is
    the sum over members (`sum_shared`), and a replicated input that each
    member uses a part of gets the sum of the members' gradients
    (`copy_to`).

A group of None, or one without a process group, is one member: every
function is then the identity.
"""

from __future__ import annotations

from typing import Optional

import torch

from contextual_image_compression_tpu_torch.parallel.mesh import Group


def _single(group: Optional[Group]) -> bool:
    return group is None or group.pg is None


def _reduce(t: torch.Tensor, group: Group) -> torch.Tensor:
    return group.all_reduce_(t.contiguous().clone())


class _SumReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group), None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(group.all_gather(x), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.group.size, ctx.dim)[ctx.group.index].contiguous(), None, None


def sum_replicated(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Sum over the group; backward passes the gradient through."""
    return x if _single(group) else _SumReplicated.apply(x, group)


def sum_shared(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Sum over the group; backward sums the members' gradients."""
    return x if _single(group) else _SumShared.apply(x, group)


def copy_to(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    """Identity; backward sums the members' gradients (a replicated input
    of which each member uses a part)."""
    return x if _single(group) else _CopyTo.apply(x, group)


def gather_replicated(x: torch.Tensor, group: Optional[Group], dim: int) -> torch.Tensor:
    """The members' x concatenated along `dim` in mesh order; backward keeps
    this member's part of the gradient."""
    return x if _single(group) else _GatherReplicated.apply(x, group, dim)


@torch.no_grad()
def gather(x: torch.Tensor, group: Optional[Group], dim: int = 0) -> torch.Tensor:
    """The members' x concatenated along `dim`, without gradient."""
    return x if _single(group) else torch.cat(group.all_gather(x), dim=dim)
