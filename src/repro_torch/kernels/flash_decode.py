"""CUDA wrapper of the flash-decode attention kernel (csrc/flash_decode.cu).

Replaces src/repro/kernels/flash_decode.py::flash_decode_pallas: one new
token per batch row against a KV cache, GQA, masked by a per-row `kv_len`,
online softmax with float32 state.  One CTA per (batch row, kv head); its
bound is device memory (the k and v rows below kv_len); see the source
note in csrc/flash_decode.cu for the design.  The plain PyTorch version of
the same function is `ops.flash_decode_plain`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# the dtypes the kernels take, by their code in the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8


def check_attention_inputs(what: str, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, n_q_heads: int):
    """Device, dtype, head-dim, group and contiguity checks shared by the
    two attention kernels; raises on anything they do not take."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"{what}: {name} must be a CUDA tensor, got "
                             f"{x.device}")
        if x.device != q.device:
            raise ValueError(f"{what}: {name} on {x.device}, q on {q.device}")
        if x.dtype != q.dtype:
            raise ValueError(f"{what}: {name} is {x.dtype}, q is {q.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: dtype {q.dtype} not supported "
                         f"(float32, bfloat16)")
    if k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"{what}: k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         f"want equal [B, S, Hkv, D]")
    D, Hkv = q.shape[-1], k.shape[2]
    if D not in HEAD_DIMS or k.shape[3] != D:
        raise ValueError(f"{what}: head dim {D} (k: {k.shape[3]}) not in "
                         f"{HEAD_DIMS}")
    if Hkv < 1 or n_q_heads % Hkv:
        raise ValueError(f"{what}: {n_q_heads} query heads over {Hkv} kv "
                         f"heads")


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kv_len: torch.Tensor) -> torch.Tensor:
    """q [B, Hq, D]; k, v [B, S, Hkv, D]; kv_len int32 [B] -> [B, Hq, D] in
    q's dtype, on the card.  D in {32, 64, 128}, G = Hq / Hkv <= 8, float32
    or bfloat16.  Adds one to `flash_decode_cuda.launches` per launch."""
    if q.dim() != 3:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}: want [B, Hq, D]")
    check_attention_inputs("flash_decode", q, k, v, q.shape[1])
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if k.shape[0] != B or G > MAX_GROUP:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}: want the same B and G <= "
                         f"{MAX_GROUP}")
    if kv_len.dtype != torch.int32 or kv_len.shape != (B,) \
            or kv_len.device != q.device:
        raise ValueError(f"flash_decode: kv_len must be int32 [{B}] on "
                         f"{q.device}")
    kv_len = kv_len.contiguous()
    out = torch.empty_like(q)
    if B == 0 or Hq == 0:
        return out
    fn = build.load("flash_decode")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
             out.data_ptr(), B, S, Hkv, G, D, DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_decode")
    flash_decode_cuda.launches += 1
    return out


flash_decode_cuda.launches = 0
