"""CUDA wrapper of the packed-postings unpack kernel (csrc/unpack.cu).

Replaces src/repro/kernels/unpack.py::unpack_fields_pallas and the gathers
of src/repro/kernels/ops.py::unpack_postings: one fused gather + shift +
mask per field, one thread per posting ordinal.  Its bound is device memory
(28 B per posting: the ordinal, three lane words, three outputs); see the
source note in csrc/unpack.cu for the design.  The plain PyTorch version of
the same function is `ops.unpack_postings_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def unpack_postings_cuda(lanes: torch.Tensor, blk_meta: torch.Tensor,
                         idx: torch.Tensor):
    """(doc, pos, dist) int32, each shaped like `idx`, for posting ordinals
    `idx` of a packed arena (`lanes` [W] int32, `blk_meta` [NB, 5] int32),
    decoded on the card.  Adds one to `unpack_postings_cuda.launches` per
    kernel launch."""
    for name, x in (("lanes", lanes), ("blk_meta", blk_meta), ("idx", idx)):
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
        if x.device != idx.device:
            raise ValueError(f"{name} on {x.device}, idx on {idx.device}")
    if lanes.dim() != 1 or blk_meta.dim() != 2 or blk_meta.shape[1] != 5:
        raise ValueError(f"bad arena shapes {tuple(lanes.shape)}, "
                         f"{tuple(blk_meta.shape)}")
    if lanes.numel() == 0 or blk_meta.shape[0] == 0:
        raise ValueError("empty packed arena")
    lanes, blk_meta = lanes.contiguous(), blk_meta.contiguous()
    idx = idx.contiguous()
    out = torch.empty((3,) + tuple(idx.shape), dtype=torch.int32,
                      device=idx.device)
    n = idx.numel()
    if n:
        fn = build.load("unpack")
        err = fn(lanes.data_ptr(), lanes.numel(), blk_meta.data_ptr(),
                 blk_meta.shape[0], idx.data_ptr(), n, out[0].data_ptr(),
                 out[1].data_ptr(), out[2].data_ptr(),
                 torch.cuda.current_stream(idx.device).cuda_stream)
        build.check(err, "unpack_postings")
        build.count_launch(unpack_postings_cuda)
    return out[0], out[1], out[2]


unpack_postings_cuda.launches = 0
