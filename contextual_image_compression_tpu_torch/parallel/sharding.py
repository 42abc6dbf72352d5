"""Sharding rules: place the train state and the batches on the mesh.

Counterpart of `contextual_image_compression_tpu/parallel/sharding.py`:

  * Batches: each data index keeps its slice of the batch's leading axis;
    the ranks of one model group keep the same slice (`shard_batch`), and
    `gather_batch` puts the slices back together.
  * Parameters and Adam moments: a leaf of at least `min_shard_elems`
    elements is split over 'model' along its largest axis that the model
    degree divides (`leaf_spec`, JAX's rule verbatim); everything else is
    replicated. The rule reads each parameter's shape in the JAX package's
    layout (conv HWIO, transposed conv (kh, kw, Cin, Cout), dense (in, out)),
    so it picks the same logical axis, ties included; the rank keeps the
    contiguous chunk of that axis at its model index, in the port's layout.
    BatchNorm statistics are replicated.

`shard_state` slices the parameters in place (same Parameter objects, so the
optimizers keep them), records each split once, on the owning module
(`_shards`, which functional_call's tensors see too), and hands every
KBatchNorm the mesh (synchronized batch statistics). The layers
(models/layers.py) gather a split weight at use (its gradient goes back to
the slice), except the codec's latent and fc projections, which compute
row- and column-parallel over the model group.

Where JAX's XLA partitioner inserts the collectives, here they are explicit
(parallel/collectives.py): `reduce_gradients` sums the gradients over the
data group in flat float32 buckets, and `full_state_dict` gathers the split
leaves for a checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from contextual_image_compression_tpu_torch.models.layers import KBatchNorm, KConv, KConvT, KDense
from contextual_image_compression_tpu_torch.parallel import collectives as C
from contextual_image_compression_tpu_torch.parallel.mesh import Group, Mesh
from contextual_image_compression_tpu_torch.train.optimizers import KerasAdam

DEFAULT_MIN_SHARD_ELEMS = 1 << 20  # 1M elements (~4 MB fp32)
BUCKET_ELEMS = 1 << 25             # 128 MB of float32 gradients per all_reduce


def leaf_spec(shape, mesh, min_shard_elems: int = DEFAULT_MIN_SHARD_ELEMS) -> Tuple:
    """The partition of one JAX-layout shape: () for replicated, else a
    tuple with 'model' at the split axis (JAX's PartitionSpec as a tuple)."""
    model_size = mesh.shape.get("model", 1)
    if model_size <= 1 or not shape or int(np.prod(shape)) < min_shard_elems:
        return ()
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for axis in order:
        if shape[axis] % model_size == 0:
            spec = [None] * len(shape)
            spec[axis] = "model"
            return tuple(spec)
    return ()


def jax_layout(module: nn.Module, name: str, shape) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(JAX shape, port dim of each JAX axis) of parameter `name` of
    `module` (convert.py's layout maps)."""
    perm: Tuple[int, ...] = tuple(range(len(shape)))
    if name == "weight":
        if isinstance(module, KConvT):
            perm = (2, 3, 0, 1)
        elif isinstance(module, KConv):
            perm = (2, 3, 1, 0)
        elif len(shape) == 2:  # KDense, SpectralNormDense
            perm = (1, 0)
    return tuple(shape[d] for d in perm), perm


@dataclasses.dataclass(frozen=True)
class Shard:
    """A parameter split over the model group along port dim `dim`; `full`
    is the whole tensor's shape."""

    dim: int
    full: Tuple[int, ...]
    group: Group

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor from this rank's slice; the gradient returns to
        the slice."""
        return C.gather_replicated(t, self.group, self.dim)


def module_shards(module: nn.Module) -> Dict[str, Shard]:
    """{qualified parameter name: Shard} of the module's split leaves, read
    from the one record of a split: the owning module's `_shards`."""
    return {f"{prefix}.{name}" if prefix else name: shard
            for prefix, mod in module.named_modules()
            for name, shard in mod.__dict__.get("_shards", {}).items()}


def _shards_by_param(module: nn.Module) -> Dict[int, Shard]:
    """{id(parameter): Shard} of the module's split leaves."""
    return {id(mod._parameters[name]): shard for mod in module.modules()
            for name, shard in mod.__dict__.get("_shards", {}).items()}


def shard_state(module: nn.Module, mesh: Mesh, optimizers: Iterable = (),
                min_shard_elems: Optional[int] = None) -> nn.Module:
    """Place a module and the optimizers of its parameters on the mesh, in
    place (see the module docstring); returns the module.
    `min_shard_elems`: default DEFAULT_MIN_SHARD_ELEMS, read at the call."""
    if min_shard_elems is None:
        min_shard_elems = DEFAULT_MIN_SHARD_ELEMS
    for mod in module.modules():
        if isinstance(mod, KBatchNorm):
            mod.mesh = mesh
        for name, p in mod._parameters.items():
            if p is None or name in mod.__dict__.get("_shards", {}):
                continue
            jshape, perm = jax_layout(mod, name, tuple(p.shape))
            spec = leaf_spec(jshape, mesh, min_shard_elems)
            if not spec:
                continue
            dim = perm[spec.index("model")]
            mod.__dict__.setdefault("_shards", {})[name] = Shard(dim, tuple(p.shape), mesh.model)
            with torch.no_grad():
                p.data = p.data.chunk(mesh.shape["model"], dim)[mesh.model_index].clone()
    by_param = _shards_by_param(module)
    for opt in optimizers:
        adam = getattr(opt, "adam", opt)  # KerasAdam or a torch optimizer
        if isinstance(opt, KerasAdam):  # the clip takes a split leaf's whole norm
            opt.shards = [by_param.get(id(p)) for p in opt.params]
        for group in adam.param_groups:
            for p in group["params"]:
                shard, st = by_param.get(id(p)), adam.state.get(p)
                if shard is None or not st:
                    continue
                for key in ("exp_avg", "exp_avg_sq"):
                    if key in st and tuple(st[key].shape) == shard.full:
                        st[key] = st[key].chunk(shard.group.size, shard.dim)[
                            shard.group.index].clone()
    return module


def shard_batch(batch, mesh: Mesh, node_local: bool = True):
    """This rank's slice of a batch (a tensor or a tuple of tensors sharing
    the leading axis) over 'data'. node_local=True: `batch` is the
    node-local batch, and the global batch the nodes' local batches
    concatenated in node order, as JAX assembles it from the processes'
    local data; False: every rank holds the whole batch."""
    if isinstance(batch, tuple):
        parts = [shard_batch(t, mesh, node_local) for t in batch]
        return type(batch)(*parts) if hasattr(batch, "_fields") else tuple(parts)
    d = mesh.shape["data"]
    if d == 1:
        return batch
    if not node_local:
        if batch.shape[0] % d:
            _indivisible(batch.shape[0], d)
        return batch.chunk(d, 0)[mesh.data_index]
    node = mesh.nodes[mesh.position]
    m = mesh.shape["model"]
    local = sorted({p // m for p, n in enumerate(mesh.nodes) if n == node})
    if any(mesh.nodes[i * m + j] != node for i in local for j in range(m)):
        raise ValueError("a model group straddles two nodes: the node-local batch "
                         "cannot be split (create_mesh(multihost=True) refuses such a mesh)")
    if batch.shape[0] % len(local):
        _indivisible(batch.shape[0], len(local))
    return batch.chunk(len(local), 0)[local.index(mesh.data_index)]


def gather_batch(batch, group: Optional[Group]):
    """The slices of the group's members concatenated along the leading
    axis (a tensor, a tuple of tensors, or a dict of them); no gradient."""
    if isinstance(batch, dict):
        return {k: gather_batch(v, group) for k, v in batch.items()}
    if isinstance(batch, tuple):
        parts = [gather_batch(t, group) for t in batch]
        return type(batch)(*parts) if hasattr(batch, "_fields") else tuple(parts)
    return C.gather(batch, group, 0)


def _indivisible(n: int, d: int):
    raise ValueError(f"batch of {n} not divisible by the mesh's {d} data indices")


def _bucketed(grads: List[torch.Tensor], collective) -> None:
    """collective(flat) on the gradients packed into flat float32 buckets
    of BUCKET_ELEMS, the results copied back."""
    bucket: List[torch.Tensor] = []
    size = 0

    def flush():
        nonlocal bucket, size
        if not bucket:
            return
        flat = torch.cat([g.reshape(-1).float() for g in bucket])
        collective(flat)
        off = 0
        for g in bucket:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        bucket, size = [], 0

    for g in grads:
        if size + g.numel() > BUCKET_ELEMS:
            flush()
        bucket.append(g)
        size += g.numel()
    flush()


@torch.no_grad()
def reduce_gradients(module: nn.Module, mesh: Mesh) -> None:
    """Sum the gradients of the module's parameters over the data group, in
    flat float32 buckets. Each rank's loss is the global loss, whose
    gradient is the sum of the ranks' parts; the ranks of a model group see
    one batch slice, so the model group is not summed over. Its ranks
    compute a replicated leaf's gradient each, equal but for the order of
    atomic sums (cuDNN's backward), so the model group then takes its first
    rank's, and the replicas stay bitwise equal."""
    if not mesh.distributed:
        return
    params = [p for p in module.parameters() if p.grad is not None]
    _bucketed([p.grad for p in params], mesh.data.all_reduce_)
    if mesh.shape["model"] > 1:
        split = _shards_by_param(module)
        _bucketed([p.grad for p in params if id(p) not in split], mesh.model.broadcast_)


@torch.no_grad()
def full_tensors(module: nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`tensors`, keyed as the module's state dict (its parameters, or
    their moments), with every split leaf gathered to its whole shape. A
    collective: every rank of the mesh calls it."""
    shards = module_shards(module)
    out = {}
    for key, t in tensors.items():
        shard = shards.get(key)
        out[key] = t if shard is None or tuple(t.shape) == shard.full else \
            torch.cat(shard.group.all_gather(t), dim=shard.dim)
    return out


def local_tensors(module: nn.Module, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of full_tensors: this rank's slice of every whole tensor
    whose parameter is split."""
    shards = module_shards(module)
    out = {}
    for key, t in tensors.items():
        shard = shards.get(key)
        out[key] = t if shard is None or tuple(t.shape) != shard.full else \
            t.chunk(shard.group.size, shard.dim)[shard.group.index]
    return out


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's state dict with the split leaves gathered."""
    return full_tensors(module, module.state_dict())


def sharded_shapes(module: nn.Module) -> Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """{parameter name: (whole shape, this rank's shape)} of the split leaves."""
    return {k: (s.full, tuple(module.get_parameter(k).shape))
            for k, s in module_shards(module).items()}
