"""The (data, model) mesh over torch.distributed, one process per device.

Counterpart of `contextual_image_compression_tpu/parallel/mesh.py`. Axes:

  'data'  -- batch parallelism: each data index holds a slice of every batch;
             gradients are summed over the data group (the ranks that share a
             model index).
  'model' -- tensor parallelism: the leaves that parallel/sharding.py's rule
             picks are split over the model group (the ranks that share a data
             index), which sees one batch slice.

Ranks are ordered by (node, rank) and contiguous runs of `model_parallel`
ranks form the model groups, as JAX orders its devices by (process, id); a
node is a host, told apart by its host name.
`multihost=True` refuses a model group that would straddle two nodes.

Bring-up, every argument given by the caller (no cluster is discovered):

    from contextual_image_compression_tpu_torch.parallel import create_mesh, initialize_multihost
    initialize_multihost("env://", backend="nccl")          # under torchrun
    mesh = create_mesh(model_parallel=2, multihost=True)

NCCL needs a card for each rank; ranks that share a card, and the CPU,
take gloo.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from contextual_image_compression_tpu_torch.config import resolve_device

_LOCAL_RANK: Optional[int] = None


def initialize_multihost(init_method: str, world_size: Optional[int] = None,
                         rank: Optional[int] = None, local_rank: Optional[int] = None,
                         *, backend: str) -> Tuple[int, int]:
    """Join the process group: `init_method` is 'tcp://host:port',
    'file://path' or 'env://' (torchrun's variables; world_size, rank and
    local_rank may then be left out). `backend` is the caller's choice:
    'nccl' when each rank has a card of its own, 'gloo' on the CPU and for
    ranks that share a card. Idempotent: a second call returns the same
    (rank, world_size) and joins nothing."""
    global _LOCAL_RANK
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if init_method.startswith("env://"):
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
        if local_rank is None and "LOCAL_RANK" in os.environ:
            local_rank = int(os.environ["LOCAL_RANK"])
    if world_size is None or rank is None:
        raise ValueError(f"{init_method}: give world_size and rank")
    _LOCAL_RANK = local_rank
    if backend == "nccl" and local_rank is not None:
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.get_rank(), dist.get_world_size()


@dataclasses.dataclass
class Group:
    """The members of one mesh axis around this rank, in mesh order, and
    their process group (None on a mesh without one)."""

    ranks: Tuple[int, ...]
    index: int
    pg: Optional[object] = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        if self.pg is not None:
            dist.all_reduce(t, group=self.pg)
        return t

    def broadcast_(self, t: torch.Tensor) -> torch.Tensor:
        """The first member's t (in mesh order), in place on every member."""
        if self.pg is not None:
            dist.broadcast(t, src=self.ranks[0], group=self.pg)
        return t

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every member's `t` (equal shapes), in mesh order."""
        if self.pg is None:
            return [t]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in self.ranks]
        dist.all_gather(parts, t, group=self.pg)
        order = dist.get_process_group_ranks(self.pg)
        return [parts[order.index(r)] for r in self.ranks]


@dataclasses.dataclass
class Mesh:
    """This rank's view of the (data, model) mesh: `shape` {'data': D,
    'model': M}, its (data_index, model_index), the groups of both axes and
    of the whole mesh, and its device."""

    shape: Dict[str, int]
    data_index: int
    model_index: int
    data: Group      # same model index, every data index
    model: Group     # same data index, every model index
    world: Group     # every rank, in mesh order
    device: torch.device
    nodes: Tuple[int, ...]  # node of each mesh position

    @property
    def position(self) -> int:
        return self.world.index

    @property
    def distributed(self) -> bool:
        return self.world.pg is not None

    @property
    def is_writer(self) -> bool:
        """Mesh position 0 writes checkpoints, metadata and artifacts."""
        return self.position == 0

    def barrier(self) -> None:
        """Return when every rank of the mesh has called it (an all_reduce
        of one element)."""
        if self.distributed:
            self.world.all_reduce_(torch.zeros(1, device=self.device))

    def data_parallel_group(self) -> Optional[Group]:
        """The data group where it holds more than one rank, else None: a
        mesh of one data index computes what one device computes."""
        return self.data if self.shape["data"] > 1 else None


def _node_keys(world: int) -> List:
    """The host name of each rank."""
    if world == 1:
        return [socket.gethostname()]
    keys: List = [None] * world
    dist.all_gather_object(keys, socket.gethostname())
    return keys


def create_mesh(model_parallel: int = 1, multihost: bool = False, device=None) -> Mesh:
    """The (data, model) mesh of the process group's ranks (see the module
    docstring); without a process group, a (1, 1) mesh of this process that
    issues no collective. `device`: this rank's device (default
    cuda:<local rank>)."""
    m = max(1, int(model_parallel))
    initialized = dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if world % m:
        raise ValueError(f"{world} ranks not divisible by model_parallel={m}")
    keys = _node_keys(world)
    first = {}
    for r, k in enumerate(keys):
        first.setdefault(k, len(first))
    node_of = [first[k] for k in keys]
    order = sorted(range(world), key=lambda r: (node_of[r], r))
    if multihost:
        for node in sorted(set(node_of)):
            cnt = node_of.count(node)
            if cnt % m:
                raise ValueError(
                    f"model_parallel={m} does not divide node {node}'s {cnt} ranks -- "
                    "the model axis would straddle nodes; use a divisor of the "
                    "per-node rank count")
    d = world // m
    pos = order.index(rank)
    data_index, model_index = divmod(pos, m)

    model_groups = [[order[i * m + j] for j in range(m)] for i in range(d)]
    data_groups = [[order[i * m + j] for i in range(d)] for j in range(m)]
    # every rank creates every group, in one order (torch.distributed's rule)
    made = {}
    for members in model_groups + data_groups:
        pg = dist.new_group(members) if initialized else None
        if rank in members:
            made[tuple(members)] = Group(tuple(members), members.index(rank), pg)
    world_group = Group(tuple(order), pos, dist.group.WORLD if initialized else None)
    if device is None:
        local = _LOCAL_RANK if _LOCAL_RANK is not None else int(os.environ.get("LOCAL_RANK", 0))
        device = f"cuda:{local}"
    return Mesh(
        shape={"data": d, "model": m},
        data_index=data_index,
        model_index=model_index,
        data=made[tuple(data_groups[model_index])],
        model=made[tuple(model_groups[data_index])],
        world=world_group,
        device=resolve_device(device),
        nodes=tuple(node_of[r] for r in order),
    )
