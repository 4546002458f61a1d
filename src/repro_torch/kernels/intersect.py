"""CUDA wrapper of the banded row-intersection kernel (csrc/intersect.cu).

Replaces src/repro/kernels/intersect.py::banded_intersect_rows_pallas
(`_kernel_rows`) and, as one row, banded_intersect_pallas.  One thread per
`a` element runs a lower-bound search of its row of `b`; the bound is
device memory, N * (5 * Pa + 4 * Pb) bytes.  See the source note in
csrc/intersect.cu for the design, and `ops.banded_intersect_rows_plain` for
the plain PyTorch version of the same function.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def banded_intersect_rows_cuda(a: torch.Tensor, b_sorted: torch.Tensor,
                               bands: torch.Tensor) -> torch.Tensor:
    """found[n, i] = exists j with |a[n, i] - b_sorted[n, j]| <= bands[n],
    False where a[n, i] is the int32 sentinel; a [N, Pa], b_sorted [N, Pb]
    ascending per row, bands [N], all int32 on the card.  Returns bool
    [N, Pa].  Adds one to `banded_intersect_rows_cuda.launches` per kernel
    launch."""
    for name, x in (("a", a), ("b_sorted", b_sorted), ("bands", bands)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
        if x.device != a.device:
            raise ValueError(f"{name} on {x.device}, a on {a.device}")
    if a.dim() != 2 or b_sorted.dim() != 2 or bands.dim() != 1 \
            or not a.shape[0] == b_sorted.shape[0] == bands.shape[0]:
        raise ValueError(f"bad shapes a {tuple(a.shape)}, b "
                         f"{tuple(b_sorted.shape)}, bands {tuple(bands.shape)}")
    a, b_sorted, bands = a.contiguous(), b_sorted.contiguous(), bands.contiguous()
    N, pa = a.shape
    pb = b_sorted.shape[1]
    found = torch.empty((N, pa), dtype=torch.bool, device=a.device)
    if N * pa:
        fn = build.load("intersect")
        err = fn(a.data_ptr(), b_sorted.data_ptr(), bands.data_ptr(), N, pa,
                 pb, found.data_ptr(),
                 torch.cuda.current_stream(a.device).cuda_stream)
        build.check(err, "banded_intersect_rows")
        banded_intersect_rows_cuda.launches += 1
    return found


banded_intersect_rows_cuda.launches = 0
