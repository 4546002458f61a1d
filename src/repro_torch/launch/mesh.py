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

`make_production_mesh(multi_pod)` is the dry-run's mesh (the reference's
16 x 16 TPU pod becomes H100 nodes): `single` is ("data", "model") =
(32, 8), 32 nodes of 8 H100 SXM with tensor parallelism over NVLink
inside a node; `multi` adds a 2-way "pod" axis, (2, 32, 8).  256 and 512
GPUs, so the registry's global batches still divide.  It is a
`DeviceMesh` over a fake process group ("fake" backend: collectives do
nothing and return at once) that this process joins as rank 0: joining
is process-global, so only the dry-run's own process (or one rank's
program on the card) calls it.  `mesh_shape(multi_pod)`
is the same layout as a plain record, with no process group, for the
placement rules.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from repro_torch.core.executor import resolve_device


PRODUCTION_AXES = {False: ("data", "model"), True: ("pod", "data", "model")}
PRODUCTION_SHAPES = {False: (32, 8), True: (2, 32, 8)}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices: what the placement
    rules (`dist/sharding.py`) read of a mesh."""
    axis_names: tuple
    dims: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n


def mesh_shape(multi_pod: bool = False) -> MeshShape:
    return MeshShape(PRODUCTION_AXES[multi_pod], PRODUCTION_SHAPES[multi_pod])


def mesh_name(multi_pod: bool) -> str:
    return "x".join(map(str, PRODUCTION_SHAPES[multi_pod]))


def _create_fake_pg(common_opts, backend_opts):
    from torch._C._distributed_c10d import FakeProcessGroup
    return FakeProcessGroup._create_internal(
        common_opts.group_rank, common_opts.group_size, backend_opts)


def _register_fake_backend():
    """Register the "fake" c10d backend (PyTorch's FakeProcessGroup, which
    its test utilities register), once per process."""
    if "FAKE" in dist.Backend._plugins:
        return
    try:
        dist.Backend.register_backend(
            "fake", _create_fake_pg, extended_api=True,
            devices=["cpu", "cuda"])
    except ValueError:           # registered by another caller meanwhile
        pass


def make_production_mesh(multi_pod: bool = False):
    """The production `DeviceMesh` (see the module docstring) on `cuda`
    over a fake process group of the mesh's size, this process as rank 0.
    Initialises that group unless one of the same size is already up (then
    the mesh is laid over it)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = PRODUCTION_SHAPES[multi_pod]
    world = 1
    for d in shape:
        world *= d
    if not dist.is_initialized():
        _register_fake_backend()
        dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                                world_size=world)
    elif dist.get_world_size() != world:
        raise RuntimeError(f"a process group of {dist.get_world_size()} "
                           f"ranks is up; the mesh needs {world}")
    return init_device_mesh("cuda", shape,
                            mesh_dim_names=PRODUCTION_AXES[multi_pod])


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
