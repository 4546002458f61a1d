"""Host mesh of the port: which ranks share an index arena.

The reference lays its serve tier over a ("data", "model") device mesh
(`make_host_mesh(data, model)`); here each rank is one process with one
device, and the mesh is a small record of that process's place in it.
Ranks are laid out `rank = dp_rank * model + model_rank`: the `data` ranks
that share a model coordinate hold the doc-partitioned shards of one arena
and merge their rows over `dp_group`; the `model` coordinate replicates the
arena to scale query throughput.

Without an initialised `torch.distributed` process group the mesh is one
rank (`data * model` must be 1) and `dp_group` is None: the serve step's
merge is then the identity.  Under `torchrun` (or any caller that
initialises the group, NCCL on the card, gloo on the CPU) every rank calls
`make_host_mesh` with the same arguments.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch.core.executor import resolve_device


@dataclasses.dataclass(frozen=True)
class HostMesh:
    data: int                  # dp shards (doc partitions)
    model: int                 # arena replicas
    dp_rank: int               # this rank's dp shard
    dp_size: int               # == data
    device: torch.device
    dp_group: object = None    # torch.distributed group over this rank's dp
                               # peers; None on the one-rank mesh

    @property
    def distributed(self) -> bool:
        """True when the serve step merges over a process group (always,
        once a group is initialised, even on one rank)."""
        return self.dp_group is not None


def _device(device) -> torch.device:
    """`device`, or the card of this process's local rank (raises without
    CUDA, as the engines do)."""
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        if local is None:
            local = (dist.get_rank() % max(torch.cuda.device_count(), 1)
                     if dist.is_initialized() else 0)
        device = f"cuda:{local}"
    return resolve_device(device)


def make_host_mesh(data: int | None = None, model: int = 1,
                   device=None) -> HostMesh:
    """This rank's place in a (data, model) mesh over the initialised
    process group's ranks (`data` defaults to world // model), or the
    one-rank mesh when no group is initialised.  `device` defaults to the
    card of the local rank; `device="cpu"` is for tests."""
    dev = _device(device)
    if not dist.is_initialized():
        data = 1 if data is None else data
        if data * model != 1:
            raise ValueError(f"a {data} x {model} mesh needs an initialised "
                             "torch.distributed process group")
        return HostMesh(data=1, model=1, dp_rank=0, dp_size=1, device=dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    data = data or world // model
    if data * model != world:
        raise ValueError(f"a {data} x {model} mesh does not cover the "
                         f"{world} ranks of the process group")
    if model == 1:
        group = dist.group.WORLD
    else:
        # every rank creates every group, in the same order
        group = None
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                group = g
    return HostMesh(data=data, model=model, dp_rank=rank // model,
                    dp_size=data, device=dev, dp_group=group)
