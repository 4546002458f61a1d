"""Placements of the port: the data-parallel axis of the data-parallel
step, the elastic restore and the halo-exchange GIN, and the production
rules of the dry-run (src/repro/dist/sharding.py).

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

The production rules (`transformer_param_specs` in the Megatron "2d" and
the ZeRO-3 "fsdp" layout, `transformer_batch_specs`,
`transformer_cache_specs`, `recsys_param_specs`, `recsys_batch_specs`,
`gin_batch_specs`) lay out the dry-run's cells (launch/steps.py) on a
multi-axis mesh: anything with `axis_names` and a `shape` mapping axis ->
size (the reference's `Mesh`, or `launch/mesh.py::MeshShape`), or a
`DeviceMesh` (`mesh_dim_names`, `shape`).  A spec is a tuple with one
entry per dimension, as the reference's `PartitionSpec`: None
(replicated), an axis name, or a tuple of axis names (the first the
major).  The leaf rules are built on `shard_dim`, by each parameter's
name in the port's modules.  The port keeps weights per layer where the
reference stacks them `[L, ...]`, so a rule's dimension sits one lower
here; no rule splits the layer axis on the production meshes, so the
specs are the reference's with that axis dropped
(tests/test_torch_dryrun.py holds them leaf by leaf).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn


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


# ---------------------------------------------------------------------------
# production rules (the dry-run's cells)
# ---------------------------------------------------------------------------

def mesh_axes(mesh) -> tuple[tuple, dict]:
    """(axis names, {axis: size}) of a reference-style mesh or a
    `DeviceMesh`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), dict(zip(names, mesh.shape))
    return tuple(mesh.axis_names), dict(mesh.shape)


def mesh_dp_axis(mesh):
    """The data-parallel axes of a production mesh ('pod' folds into DP
    when present), as the reference's `dp_axis`."""
    names, _ = mesh_axes(mesh)
    return ("pod", "data") if "pod" in names else "data"


def gnn_dp_axis(mesh) -> tuple:
    """GNNs partition rows on ALL axes (no tensor-parallel dimension)."""
    return mesh_axes(mesh)[0]


def axes_size(mesh, axes) -> int:
    _, size = mesh_axes(mesh)
    if axes is None:
        return 1
    if isinstance(axes, str):
        return size[axes]
    n = 1
    for a in axes:
        n *= size[a]
    return n


def _replicated(ndim: int) -> tuple:
    return (None,) * ndim


def _split(shape, dim: int, axes, n: int) -> tuple:
    """`dim` split over `axes` where `shard_dim` allows it, else
    replicated (the reference's `_shard_dim`)."""
    if shard_dim(tuple(shape), dim, n) is None:
        return _replicated(len(shape))
    spec = [None] * len(shape)
    spec[dim] = axes
    return tuple(spec)


def _largest_divisible(shape, axes, n: int) -> tuple:
    """The largest dimension that splits n ways (the first of equals),
    else replicated."""
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shard_dim(tuple(shape), d, n) is not None:
            return _split(shape, d, axes, n)
    return _replicated(len(shape))


def leaf_shapes(module: nn.Module) -> dict:
    """{name: shape} of a module's parameters, in registration order."""
    return {k: tuple(p.shape) for k, p in module.named_parameters()}


# Megatron roles: column-parallel leaves split their output (last)
# dimension, row-parallel ones their input dimension
_TFM_COL = {"wq", "wk", "wv", "wg", "wu", "bq", "bk", "bv"}
_TFM_ROW = {"wo", "wd"}


def transformer_param_specs(cfg, mesh, layout: str = "2d",
                            shapes: Optional[dict] = None) -> dict:
    """{parameter name: spec} of the port's `Transformer(cfg)`.

    "2d": Megatron tensor parallelism on 'model' — wq / wk / wv / wg / wu
    and the qkv biases column-parallel (last dimension), wo and a dense
    wd row-parallel, an MoE layer's wd split on its experts (else its
    d_expert), `embed` and `lm_head` on the vocabulary; norms and the
    router replicated.  As in the reference, an MoE layer's wg / wu take
    the column rule (it is tested first), so they split d_expert.
    "fsdp": every leaf over all axes on its largest divisible dimension.
    `shapes` ({name: shape}) defaults to a meta-device model's."""
    if shapes is None:
        from repro_torch.models.transformer import Transformer
        shapes = leaf_shapes(Transformer(cfg, device="meta"))
    names, size = mesh_axes(mesh)
    if layout == "fsdp":
        n = axes_size(mesh, names)
        return {k: _largest_divisible(s, names, n) for k, s in shapes.items()}
    if layout != "2d":
        raise ValueError(f"unknown layout {layout!r}")
    if "model" not in names:
        return {k: _replicated(len(s)) for k, s in shapes.items()}
    n = size["model"]
    moe = bool(getattr(cfg, "moe", None))
    out = {}
    for k, shape in shapes.items():
        leaf = k.rsplit(".", 1)[-1]
        in_layer = k.startswith("layers.")
        if leaf in ("embed", "lm_head") and not in_layer:
            spec = _split(shape, 0 if leaf == "embed" else 1, "model", n)
        elif in_layer and leaf in _TFM_COL:
            spec = _split(shape, len(shape) - 1, "model", n)
        elif in_layer and leaf in _TFM_ROW and moe and len(shape) == 3:
            spec = _split(shape, 0, "model", n)       # experts, else d_expert
            if spec == _replicated(3):
                spec = _split(shape, 1, "model", n)
        elif in_layer and leaf in _TFM_ROW:
            spec = _split(shape, len(shape) - 2, "model", n)
        else:
            spec = _replicated(len(shape))            # norms, router
        out[k] = spec
    return out


def transformer_batch_specs(mesh) -> dict:
    dp = mesh_dp_axis(mesh)
    return {"tokens": (dp, None), "labels": (dp, None)}


def transformer_cache_specs(cfg, mesh, batch: int) -> dict:
    """KV cache [L, B, S, Hkv, hd]: batch-split on DP when it divides,
    else replicated (serving small batches on big meshes)."""
    dp = mesh_dp_axis(mesh)
    n = axes_size(mesh, dp)
    bspec = dp if (batch % n == 0 and batch >= n) else None
    spec = (None, bspec, None, None, None)
    return {"k": spec, "v": spec}


_REC_TABLES = {"table", "item_table", "w_lin"}


def recsys_param_specs(cfg, mesh, shapes: Optional[dict] = None) -> dict:
    """{parameter name: spec} of the port's `RecSysModel(cfg)`: embedding
    tables (`table`, `item_table`, `w_lin`) row-split over all axes, the
    dense tower replicated."""
    if shapes is None:
        from repro_torch.models.recsys import RecSysModel
        shapes = leaf_shapes(RecSysModel(cfg, device="meta"))
    names, _ = mesh_axes(mesh)
    n = axes_size(mesh, names)
    return {k: (_split(s, 0, names, n) if k.rsplit(".", 1)[-1] in _REC_TABLES
                else _replicated(len(s))) for k, s in shapes.items()}


def recsys_batch_specs(cfg, mesh, retrieval: bool = False) -> dict:
    dp = mesh_dp_axis(mesh)
    out = {"ids": (dp, None), "label": (dp,), "hist": (dp, None),
           "target": (dp,)}
    if retrieval:
        out["cand"] = ()         # candidates replicated
    return out


def gin_batch_specs(mesh) -> dict:
    ax = gnn_dp_axis(mesh)
    return {"nodes": (ax, None), "src": (ax,), "dst": (ax,),
            "edge_mask": (ax,), "labels": (ax,), "label_mask": (ax,),
            "node_mask": (ax,), "send_idx": (ax,), "graph_id": (ax,)}


def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_block(shape, spec, mesh, coord: dict) -> tuple[tuple, tuple]:
    """(local shape, per-dimension start) of the block that the rank at
    mesh coordinate `coord` ({axis: index}) holds of a leaf shaped
    `shape` placed by `spec`."""
    _, size = mesh_axes(mesh)
    local, start = list(shape), [0] * len(shape)
    for d, entry in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        axes = spec_axes(entry)
        if not axes:
            continue
        n, idx = 1, 0
        for a in axes:
            idx = idx * size[a] + coord[a]
            n *= size[a]
        local[d] = shape[d] // n
        start[d] = idx * local[d]
    return tuple(local), tuple(start)
