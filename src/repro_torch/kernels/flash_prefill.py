"""CUDA wrapper of the flash-prefill attention kernel (csrc/flash_prefill.cu).

Replaces src/repro/kernels/flash_prefill.py::flash_prefill_pallas: causal
GQA attention over a prompt, kv tiles above the diagonal skipped, online
softmax with float32 state.  It takes q in the model's [B, S, Hq, D]
layout (the reference reorders q into (q block, g, q) rows for the TPU).
Its bound is arithmetic.  bfloat16 runs on the tensor cores (wgmma on
TMA-loaded tiles, one CTA per 128-row q tile of one query head); float32
on the CUDA cores (one CTA per 64-row q tile); see the source note in
csrc/flash_prefill.cu.  The plain PyTorch version of the same function is
`ops.flash_prefill_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import DTYPE_CODES, check_attention_inputs


def flash_prefill_cuda(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """q [B, S, Hq, D]; k, v [B, S, Hkv, D] -> [B, S, Hq, D] in q's dtype,
    on the card.  D in {32, 64, 128}, float32 or bfloat16.  Adds one to
    `flash_prefill_cuda.launches` per launch."""
    if q.dim() != 4:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)}: want "
                         f"[B, S, Hq, D]")
    check_attention_inputs("flash_prefill", q, k, v, q.shape[2])
    B, S, Hq, D = q.shape
    if k.shape[:2] != (B, S):
        raise ValueError(f"flash_prefill: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}: want the same B and S")
    out = torch.empty_like(q)
    if B == 0 or S == 0 or Hq == 0:
        return out
    fn = build.load("flash_prefill")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
             Hq, k.shape[2], D, DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_prefill")
    build.count_launch(flash_prefill_cuda)
    return out


flash_prefill_cuda.launches = 0


INFO_FIELDS = ("threads", "registers", "dynamic_smem_bytes", "stages",
               "q_tile_rows", "kv_tile_rows", "local_bytes")


def flash_prefill_info(D: int, dtype: torch.dtype) -> dict:
    """The compiled kernel that a call with head dim D and `dtype` launches
    (bfloat16: the wgmma route; float32: the CUDA-core route): threads per
    CTA, registers and local (spill) bytes per thread as the runtime
    reports them, its dynamic shared memory, K / V ring stages and tile
    rows.  Needs the card."""
    out = (ctypes.c_longlong * len(INFO_FIELDS))()
    fn = build.load("flash_prefill", "flash_prefill_info")
    build.check(fn(D, DTYPE_CODES[dtype], ctypes.addressof(out)),
                "flash_prefill_info")
    return dict(zip(INFO_FIELDS, out))
