"""CUDA wrapper of the embedding-bag kernel (csrc/segment_bag.cu).

Replaces src/repro/kernels/segment_bag.py::segment_bag_pallas: weighted
sums of gathered table rows per bag, float32 accumulation in field order,
negative ids as padding, ids >= V clamped to the last row.  A CTA owns a
tile of consecutive bags whose ids (and weights) it stages in shared
memory; its threads own (bag, column group) pairs and keep eight row loads
in flight each.  `bag_tile` plans the tile on the host.  Its bound is device
memory (the distinct rows' sectors, the ids, weights and output); see the
source note for the design.  The plain PyTorch version of the same
function is `ops.segment_bag_plain`, and the mean and the cast to the
table's dtype stay in `ops.segment_bag`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build

# the dtypes the kernel takes, by their code in the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

BAG_THREADS = 256            # threads per CTA the planner fills (at most)
BAG_SMEM_BUDGET = 48 * 1024  # staged ids + weights per CTA: four CTAs per
                             # SM fit the 227 KB, and no opt-in is needed
BAG_LOADS_IN_FLIGHT = 8      # kU in the source: fields per unrolled run


class BagTile(NamedTuple):
    bags: int          # consecutive bags per CTA
    fields: int        # fields staged at a time (>= F: the tile in one run)
    groups: int        # column groups per bag per CTA (grid.y covers more)
    threads: int       # per CTA, a multiple of 32, >= bags * groups
    vec: int           # columns per thread, one load each
    smem_bytes: int    # dynamic shared memory per CTA


def _plane_bytes(bags: int, fields: int, elem_size: int) -> int:
    """One staged plane with the 16 bytes its alignment may take, rounded
    to 16 (csrc/segment_bag.cu, plane_bytes)."""
    return (bags * fields * elem_size + 16 + 15) // 16 * 16


def bag_smem_bytes(bags: int, fields: int, elem_size: int,
                   weighted: bool) -> int:
    return _plane_bytes(bags, fields, 4) + (
        _plane_bytes(bags, fields, elem_size) if weighted else 0)


def bag_vec(D: int, elem_size: int, table_ptr: int = 0) -> int:
    """Columns per thread: 4 or 2 where they divide D and the table's rows
    stay aligned to that many elements, else 1."""
    for v in (4, 2):
        if D % v == 0 and table_ptr % (v * elem_size) == 0:
            return v
    return 1


@functools.lru_cache(maxsize=256)
def bag_tile(B: int, F: int, D: int, elem_size: int, weighted: bool = False,
             vec: int = 1) -> BagTile:
    """The tile of a [B, F] bag call on a [V, D] table of `elem_size`-byte
    elements: as many bags as fill BAG_THREADS threads at `vec` columns a
    thread, every field staged at once unless that passes BAG_SMEM_BUDGET,
    else runs of a multiple of BAG_LOADS_IN_FLIGHT fields.  Every bag falls
    in exactly one tile: tile i holds bags [i * bags, min(B, (i + 1) *
    bags))."""
    if D % vec:
        raise ValueError(f"segment_bag: vec {vec} does not divide D {D}")
    groups = min(D // vec, BAG_THREADS)
    bags = max(1, min(BAG_THREADS // groups, B))
    fields = max(1, F)
    if bag_smem_bytes(bags, fields, elem_size, weighted) > BAG_SMEM_BUDGET:
        per_field = bags * (4 + (elem_size if weighted else 0))
        fields = (BAG_SMEM_BUDGET - 64) // per_field
        fields = max(BAG_LOADS_IN_FLIGHT,
                     fields // BAG_LOADS_IN_FLIGHT * BAG_LOADS_IN_FLIGHT)
    threads = -(-bags * groups // 32) * 32
    return BagTile(bags, fields, groups, threads, vec,
                   bag_smem_bytes(bags, fields, elem_size, weighted))


def segment_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                     weights: Optional[torch.Tensor]) -> torch.Tensor:
    """table [V, D] float32 or bfloat16; ids [B, F] int32 (negative =
    pad); weights [B, F] in table's dtype, or None for all ones -> float32
    [B, D] bag sums, on the card, in the tile `bag_tile` plans.  Adds one
    to `segment_bag_cuda.launches` per launch."""
    named = [("table", table), ("ids", ids)]
    if weights is not None:
        named.append(("weights", weights))
    for name, x in named:
        if not x.is_cuda:
            raise ValueError(f"segment_bag: {name} must be a CUDA tensor, "
                             f"got {x.device}")
        if x.device != table.device:
            raise ValueError(f"segment_bag: {name} on {x.device}, table on "
                             f"{table.device}")
        if not x.is_contiguous():
            raise ValueError(f"segment_bag: {name} must be contiguous")
    if table.dtype not in DTYPE_CODES:
        raise ValueError(f"segment_bag: table dtype {table.dtype} not "
                         f"supported (float32, bfloat16)")
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"segment_bag: table {tuple(table.shape)}, ids "
                         f"{tuple(ids.shape)}: want [V, D] and [B, F]")
    if ids.dtype != torch.int32:
        raise ValueError(f"segment_bag: ids are {ids.dtype}, want int32")
    if weights is not None and (weights.dtype != table.dtype
                                or weights.shape != ids.shape):
        raise ValueError(f"segment_bag: weights {weights.dtype} "
                         f"{tuple(weights.shape)}, want {table.dtype} "
                         f"{tuple(ids.shape)}")
    V, D = table.shape
    B, F = ids.shape
    out = torch.empty((B, D), dtype=torch.float32, device=table.device)
    if B * D == 0:
        return out
    if V == 0:
        raise ValueError("segment_bag: empty table")
    esize = table.element_size()
    tile = bag_tile(B, F, D, esize, weights is not None,
                    bag_vec(D, esize, table.data_ptr()))
    fn = build.load("segment_bag")
    err = fn(table.data_ptr(), V, D, ids.data_ptr(),
             None if weights is None else weights.data_ptr(), B, F,
             out.data_ptr(), DTYPE_CODES[table.dtype], tile.bags,
             tile.fields, tile.groups, tile.threads, tile.vec,
             torch.cuda.current_stream(table.device).cuda_stream)
    build.check(err, "segment_bag")
    build.count_launch(segment_bag_cuda)
    return out


segment_bag_cuda.launches = 0

INFO_FIELDS = ("registers", "local_bytes", "dynamic_smem_bytes",
               "loads_in_flight")


def segment_bag_info(dtype: torch.dtype, tile: BagTile,
                     weighted: bool) -> dict:
    """The compiled kernel that a launch with `dtype`, `tile` and weights
    given or not runs: registers and local (spill) bytes per thread as the
    runtime reports them, its dynamic shared memory and its table loads in
    flight per thread.  Needs the card."""
    out = (ctypes.c_longlong * len(INFO_FIELDS))()
    fn = build.load("segment_bag", "segment_bag_info")
    build.check(fn(DTYPE_CODES[dtype], tile.vec, int(weighted), tile.bags,
                   tile.fields, ctypes.addressof(out)), "segment_bag_info")
    return dict(zip(INFO_FIELDS, out))
