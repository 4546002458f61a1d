"""Placements on the data-parallel axis: the part of the reference's
src/repro/dist/sharding.py that the data-parallel step, the elastic
restore and the halo-exchange GIN's batch need.

The reference places a leaf with `NamedSharding(mesh, P(...))`; here each
rank is one process with one device (`launch/mesh.py`), and a leaf
placed on one axis is a `Placement`: the dimension split (None when the
leaf is replicated), this rank's block along it, the number of blocks and
the device that holds the block.  The split follows the reference's
`_shard_dim` rule: a dimension is split only when its size is a multiple
of the axis size (and at least it), otherwise the leaf is replicated.

`dp_axis(mesh)` is the mesh's dp group, the process group the
data-parallel step reduces over (the reference's "data" axis, with "pod"
folded in).  The batch of the data-parallel step is split into contiguous
row blocks (`split_rows`), as `P(dp)` splits it, and must divide.

Not ported here: the Megatron, FSDP and recsys `PartitionSpec` rules and
the GIN's edge-partitioned batch specs (`transformer_param_specs`,
`recsys_param_specs`, `gin_batch_specs`, ...): they lay out the dry-run's
cells on multi-axis meshes, which is ROADMAP.md queue 1, item 10d.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def dp_axis(mesh):
    """The data-parallel process group of a `HostMesh` (None on the
    one-rank mesh without a process group)."""
    return mesh.dp_group


def shard_dim(shape, dim: int, n: int) -> Optional[int]:
    """`dim` when it splits into n blocks (the reference's `_shard_dim`
    rule), else None: the leaf is replicated."""
    if dim < len(shape) and shape[dim] % n == 0 and shape[dim] >= n:
        return dim
    return None


@dataclasses.dataclass(frozen=True)
class Placement:
    """One rank's block of a leaf split along `dim` into `count` blocks
    (`dim` None: the whole leaf), held on `device`."""
    dim: Optional[int]
    index: int
    count: int
    device: torch.device

    def block(self, t: torch.Tensor) -> torch.Tensor:
        """This placement's block of the whole tensor `t`, a new contiguous
        tensor on the placement's device."""
        if self.dim is not None:
            size = t.shape[self.dim] // self.count
            t = t.narrow(self.dim, self.index * size, size)
        return t.to(self.device, copy=True).contiguous()


def placement(shape, dim: int, index: int, count: int, device) -> Placement:
    """Block `index` of `count` along `dim` of a leaf shaped `shape`, or
    the whole leaf where `dim` does not split (`shard_dim`)."""
    split = shard_dim(tuple(shape), dim, count)
    if split is None:
        return Placement(None, 0, 1, torch.device(device))
    return Placement(split, index, count, torch.device(device))


def dp_placement(mesh, shape, dim: int = 0) -> Placement:
    """This rank's placement of a leaf split along `dim` over the mesh's
    dp axis (`P(dp)` on that dimension)."""
    return placement(shape, dim, mesh.dp_rank, mesh.dp_size, mesh.device)


def split_rows(tree: dict, index: int, count: int) -> dict:
    """Block `index` of `count` contiguous row blocks of every tensor of
    `tree` (a view; `P(dp)` on the leading dimension).  Raises when a
    leading dimension does not divide by `count`."""
    out = {}
    for k, v in tree.items():
        rows = v.shape[0]
        if rows % count:
            raise ValueError(f"batch leaf {k!r}: {rows} rows do not split "
                             f"into {count} data-parallel blocks")
        size = rows // count
        out[k] = v.narrow(0, index * size, size)
    return out
