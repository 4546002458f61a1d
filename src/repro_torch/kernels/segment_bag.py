"""CUDA wrapper of the embedding-bag kernel (csrc/segment_bag.cu).

Replaces src/repro/kernels/segment_bag.py::segment_bag_pallas: weighted
sums of gathered table rows per bag, float32 accumulation in field order,
negative ids as padding, ids >= V clamped to the last row.  One thread per
output element; its bound is device memory (the distinct rows' sectors,
the ids, weights and output); see the source note for the design.  The
plain PyTorch version of the same function is `ops.segment_bag_plain`,
and the mean and the cast to the table's dtype stay in `ops.segment_bag`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

# the dtypes the kernel takes, by their code in the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def segment_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                     weights: Optional[torch.Tensor]) -> torch.Tensor:
    """table [V, D] float32 or bfloat16; ids [B, F] int32 (negative =
    pad); weights [B, F] in table's dtype, or None for all ones -> float32
    [B, D] bag sums, on the card.  Adds one to `segment_bag_cuda.launches`
    per launch."""
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
    fn = build.load("segment_bag")
    err = fn(table.data_ptr(), V, D, ids.data_ptr(),
             None if weights is None else weights.data_ptr(), B, F,
             out.data_ptr(), DTYPE_CODES[table.dtype],
             torch.cuda.current_stream(table.device).cuda_stream)
    build.check(err, "segment_bag")
    segment_bag_cuda.launches += 1
    return out


segment_bag_cuda.launches = 0
