"""CUDA wrapper of the flash-decode attention kernel (csrc/flash_decode.cu).

Replaces src/repro/kernels/flash_decode.py::flash_decode_pallas: one new
token per batch row against a KV cache, GQA, masked by a per-row `kv_len`,
online softmax with float32 state.  Each (batch row, kv head)'s cache is
split across CTAs (`decode_split`), which write float32 partials to a
workspace that a second kernel merges; its bound is device memory (the k
and v rows below kv_len); see the source note in csrc/flash_decode.cu for
the design.  The plain PyTorch version of the same function is
`ops.flash_decode_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

# the dtypes the kernels take, by their code in the C interface
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8
TILE_ROWS = 64          # cache rows per TMA tile; chunks are multiples of it
MIN_CTAS = 2 * 132      # two CTAs per SM of an H100 SXM (132 SMs)
MAX_CHUNK = 2048        # cache rows per CTA when the grid is large enough
MAX_SPLIT = 4096        # CTAs per (batch row, kv head) the merge kernel takes
                        # (kMergeMaxSplit in csrc/flash_decode.cu)


def decode_split(S: int, B: int, Hkv: int) -> tuple[int, int]:
    """The kernel's split of the cache: (chunk_rows, n_split), n_split CTAs
    of chunk_rows rows (a multiple of TILE_ROWS) for each (batch row, kv
    head), n_split * chunk_rows >= S.  Planned from S, never from kv_len
    (on the card; reading it would cost a host sync per call): the longest
    chunk up to MAX_CHUNK that still gives MIN_CTAS CTAs, halving down to
    one tile (fewer, longer CTAs pay less for filling the ring and for the
    merge); doubled past MAX_CHUNK while a longer cache would need more
    than MAX_SPLIT CTAs."""
    if S < 1 or B < 1 or Hkv < 1:
        raise ValueError(f"decode_split: S {S}, B {B}, Hkv {Hkv}: want >= 1")
    chunk = MAX_CHUNK
    while chunk > TILE_ROWS and B * Hkv * -(-S // chunk) < MIN_CTAS:
        chunk //= 2
    while -(-S // chunk) > MAX_SPLIT:
        chunk *= 2
    return chunk, -(-S // chunk)


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
    or bfloat16.  Adds one to `flash_decode_cuda.launches` per call that
    launches (each call is two CUDA launches: the split kernel and the
    merge)."""
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
    if S == 0:                       # no cache rows: every row reads zeros
        return out.zero_()
    chunk, n_split = decode_split(S, B, Hkv)
    ws = torch.empty((B, Hkv, n_split, G, D + 2), dtype=torch.float32,
                     device=q.device)
    fn = build.load("flash_decode")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
             out.data_ptr(), ws.data_ptr(), B, S, Hkv, G, D,
             DTYPE_CODES[q.dtype], chunk, n_split,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_decode")
    build.count_launch(flash_decode_cuda)
    return out


flash_decode_cuda.launches = 0


INFO_FIELDS = ("threads", "registers", "dynamic_smem_bytes", "stages",
               "tile_rows", "local_bytes")


def flash_decode_info(D: int, dtype: torch.dtype, G: int) -> dict:
    """The compiled split kernel that a call with head dim D, `dtype` and
    group G launches: threads per CTA, registers and local (spill) bytes
    per thread as the runtime reports them, its dynamic shared memory,
    ring stages and rows per tile.  Needs the card."""
    out = (ctypes.c_longlong * len(INFO_FIELDS))()
    fn = build.load("flash_decode", "flash_decode_info")
    build.check(fn(D, DTYPE_CODES[dtype], G, ctypes.addressof(out)),
                "flash_decode_info")
    return dict(zip(INFO_FIELDS, out))
