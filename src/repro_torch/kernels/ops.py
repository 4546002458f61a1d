"""Kernel dispatch and the plain PyTorch versions of the kernels.

Each op dispatches on the device of its tensors: a CUDA tensor launches the
hand-written kernel (unpack.py, intersect.py, flash_decode.py,
flash_prefill.py, segment_bag.py; sources in csrc/) or raises,
a CPU tensor takes the plain version below.  The plain versions are pure
tensor code that runs on either device; the CPU tests hold them against the
reference package, and chip_smoke.py holds the kernels against them on the
card.  The K-word window scan (`delta_mask_t_bits`) runs in the
delta-mask kernel's launch on the card, where the reference's XLA fuses
its jnp into the bucket's program; `kword_window_hits`, the AND of the
scan over constraint groups, is plain tensor code on both devices.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_decode import flash_decode_cuda
from repro_torch.kernels.flash_prefill import flash_prefill_cuda
from repro_torch.kernels.intersect import (banded_delta_mask_rows_cuda,
                                           banded_intersect_rows_cuda,
                                           banded_min_delta_rows_cuda)
from repro_torch.kernels.segment_bag import segment_bag_cuda
from repro_torch.kernels.unpack import unpack_postings_cuda

I32_SENTINEL = 2**31 - 1     # int32 pad key: never matches a banded probe
KW_MAX_BAND = 15             # K-word delta masks: bit (d + band) <= 30

# ranked scoring's composite layout, owned here and read by core: a
# constraint key sorts as (key << SCORE_DELTA_BITS | delta), delta in
# [0, SCORE_DELTA_MASK] (|dist| <= near_window <= 15)
SCORE_DELTA_BITS = 4
SCORE_DELTA_MASK = (1 << SCORE_DELTA_BITS) - 1

# packed-postings block geometry (== core.postings.BLOCK_LOG2 and
# PACK_WIDTH_BITS); literal so the kernel layer stays import-free of core
_BLOCK_LOG2 = 7
_BLOCK = 1 << _BLOCK_LOG2
_WBITS = 6


def _on_cpu(x: torch.Tensor, what: str) -> bool:
    if x.is_cuda:
        return False
    if x.device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {x.device}")
    return True


# ---------------------------------------------------------------------------
# packed-postings unpack
# ---------------------------------------------------------------------------

def unpack_postings_plain(arena: dict, idx: torch.Tensor):
    """(doc, pos, dist) int32 for posting ordinals `idx` of a packed arena
    (`lanes` [W] int32 packed delta words, `blk_meta` [NB, 5] int32:
    base lane word, packed field widths, doc/pos/dist anchors).  The same
    math as the reference's ops.unpack_postings; its gathers clamp out-of-
    range indices, so these clamp the block index and the lane word
    explicitly (a width-0 tail block points one word past the end)."""
    lanes, meta_t = arena["lanes"], arena["blk_meta"]
    blk = (idx >> _BLOCK_LOG2).clamp(0, meta_t.shape[0] - 1).long()
    off = idx & (_BLOCK - 1)
    meta = meta_t[blk]                              # [..., 5] one gather
    base, bw = meta[..., 0], meta[..., 1]
    m = (1 << _WBITS) - 1
    ws = [bw & m, (bw >> _WBITS) & m, (bw >> (2 * _WBITS)) & m]
    fbs = [base, base + (ws[0] << 2), base + ((ws[0] + ws[1]) << 2)]
    out = []
    for f, (w, fb) in enumerate(zip(ws, fbs)):
        bit = off * w
        word = lanes[(fb + (bit >> 5)).clamp(0, lanes.shape[0] - 1).long()]
        mask = torch.where(w >= 32, -1, (1 << w.clamp(max=31)) - 1)
        out.append(meta[..., 2 + f] + ((word >> (bit & 31)) & mask))
    return out[0], out[1], out[2]


def unpack_postings(arena: dict, idx: torch.Tensor):
    """(doc, pos, dist) int32 for posting ordinals `idx` — the CUDA kernel on
    the card, the plain version on the CPU."""
    if _on_cpu(idx, "unpack_postings"):
        return unpack_postings_plain(arena, idx)
    return unpack_postings_cuda(arena["lanes"], arena["blk_meta"], idx)


# ---------------------------------------------------------------------------
# banded intersection
# ---------------------------------------------------------------------------

def banded_intersect_rows_plain(a: torch.Tensor, b_sorted: torch.Tensor,
                                bands: torch.Tensor) -> torch.Tensor:
    """found[n, i] = exists j with |a[n, i] - b_sorted[n, j]| <= bands[n];
    I32_SENTINEL entries of `a` never match.  a [N, Pa], b_sorted [N, Pb]
    ascending per row, bands [N], int32.  Row-batched searchsorted, the
    counterpart of the reference's ref path; bounds are taken in int64 so
    `a ± band` cannot wrap, and both searchsorted operands are cast to the
    same dtype."""
    a64 = a.long()
    b64 = b_sorted.long().contiguous()
    band = bands.long()[:, None]
    lo = torch.searchsorted(b64, a64 - band, side="left")
    hi = torch.searchsorted(b64, a64 + band, side="right")
    return (hi > lo) & (a != I32_SENTINEL)


def banded_intersect_rows(a: torch.Tensor, b_sorted: torch.Tensor,
                          bands: torch.Tensor) -> torch.Tensor:
    """Batched banded membership (see banded_intersect_rows_plain) — the
    CUDA kernel on the card, the plain version on the CPU."""
    if _on_cpu(a, "banded_intersect_rows"):
        return banded_intersect_rows_plain(a, b_sorted, bands)
    return banded_intersect_rows_cuda(a, b_sorted, bands)


def banded_intersect(a: torch.Tensor, b_sorted: torch.Tensor,
                     band: int) -> torch.Tensor:
    """found[i] = exists j with |a[i] - b_sorted[j]| <= band: one row of
    `banded_intersect_rows` with a constant band."""
    bands = torch.full((1,), band, dtype=torch.int32, device=a.device)
    return banded_intersect_rows(a[None], b_sorted[None], bands)[0]


# ---------------------------------------------------------------------------
# banded minimum delta (ranked scoring)
# ---------------------------------------------------------------------------

def banded_min_delta_rows_plain(a: torch.Tensor, bk: torch.Tensor,
                                bd: torch.Tensor,
                                bands: torch.Tensor) -> torch.Tensor:
    """out[n, i] = min over j with |a[n, i] - bk[n, j]| <= bands[n] of
    (|a[n, i] - bk[n, j]| + bd[n, j]), I32_SENTINEL where no j is in band
    or a[n, i] is the sentinel.  a [N, Pa]; bk, bd [N, Pb] with each row
    sorted by (bk, bd) and bd in [0, 15]; bands [N]; int32.

    The general minimum, as the reference's Pallas kernel computes it (rows
    with band > 0 may carry non-zero deltas): for each offset d in
    [-max band, max band] one searchsorted of the composite
    (a + d) << SCORE_DELTA_BITS into the row's (bk, bd) composites finds the first entry at key
    a + d, which carries that key's minimum delta.  O((2W + 1) Pa log Pb),
    in int64 so `a + d` cannot wrap."""
    N, pa = a.shape
    pb = bk.shape[1]
    out = torch.full((N, pa), I32_SENTINEL, dtype=torch.int32,
                     device=a.device)
    if N * pa * pb == 0:
        return out
    a64 = a.long()
    comp = ((bk.long() << SCORE_DELTA_BITS) | bd.long()).contiguous()
    band = bands.long()[:, None]
    best = torch.full((N, pa), I32_SENTINEL, dtype=torch.int64,
                      device=a.device)
    width = max(int(band.max()), -1)
    for d in range(-width, width + 1):
        key = a64 + d
        idx = torch.searchsorted(comp, (key << SCORE_DELTA_BITS).contiguous(),
                                 side="left")
        e = comp.gather(1, idx.clamp(max=pb - 1))
        hit = (idx < pb) & ((e >> SCORE_DELTA_BITS) == key) & (abs(d) <= band)
        best = torch.where(hit, torch.minimum(best, abs(d) + (e & SCORE_DELTA_MASK)), best)
    return torch.where(a == I32_SENTINEL, out, best.int())


def banded_min_delta_rows(a: torch.Tensor, bk: torch.Tensor, bd: torch.Tensor,
                          bands: torch.Tensor) -> torch.Tensor:
    """Batched banded minimum delta (see banded_min_delta_rows_plain) — the
    CUDA kernel on the card, the plain version on the CPU."""
    if _on_cpu(a, "banded_min_delta_rows"):
        return banded_min_delta_rows_plain(a, bk, bd, bands)
    return banded_min_delta_rows_cuda(a, bk, bd, bands)


# ---------------------------------------------------------------------------
# K-word delta masks and window scan
# ---------------------------------------------------------------------------

def banded_delta_mask_rows_plain(a: torch.Tensor, b_sorted: torch.Tensor,
                                 bands: torch.Tensor) -> torch.Tensor:
    """out[n, i] has bit (d + bands[n]) set iff b_sorted[n] holds a[n, i] + d
    for a d with |d| <= bands[n] (d in [-15, 15]; bit indices clip to
    [0, 31]); 0 where a[n, i] is the sentinel.  a [N, Pa], b_sorted
    [N, Pb] ascending per row, bands [N], int32 — the reference's ref
    loop, in int64 so `a + d` cannot wrap."""
    a64 = a.long()
    b64 = b_sorted.long().contiguous()
    band = bands.long()[:, None]
    one = torch.ones((), dtype=torch.int32, device=a.device)
    mask = torch.zeros_like(a)
    for d in range(-KW_MAX_BAND, KW_MAX_BAND + 1):
        lo = torch.searchsorted(b64, a64 + d, side="left")
        hi = torch.searchsorted(b64, a64 + d, side="right")
        present = (hi > lo) & (abs(d) <= band)
        bit = one << (d + band).clamp(0, 31).int()
        mask |= torch.where(present, bit, 0).int()
    return torch.where(a == I32_SENTINEL, 0, mask)


def banded_delta_mask_rows(a: torch.Tensor, b_sorted: torch.Tensor,
                           bands: torch.Tensor, windows: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask, t_bits): the batched signed-delta bitmask (see
    banded_delta_mask_rows_plain) and its window scan at per-row windows
    W = windows[n] (see delta_mask_t_bits), int32 [N, Pa] each — one launch
    of the CUDA kernel on the card, the plain versions on the CPU."""
    if _on_cpu(a, "banded_delta_mask_rows"):
        mask = banded_delta_mask_rows_plain(a, b_sorted, bands)
        return mask, delta_mask_t_bits(mask, windows)
    return banded_delta_mask_rows_cuda(a, b_sorted, bands, windows)


def delta_mask_t_bits(mask: torch.Tensor, bands: torch.Tensor) -> torch.Tensor:
    """Per-group window scan of a delta mask: bit t of the result is set iff
    ((mask >> t) & low(W + 1)) != 0 for t in [0, W], W = bands[n] <= 15 —
    the group has a candidate inside the window starting at offset t - W
    from the anchor.  mask [N, Pa] int32, bands [N] int32."""
    one = torch.ones((), dtype=torch.int32, device=mask.device)
    low = ((one << (bands + 1)) - 1)[:, None]
    bits = torch.zeros_like(mask)
    for t in range(KW_MAX_BAND + 1):
        hit = (((mask >> t) & low) != 0) & (t <= bands)[:, None]
        bits |= torch.where(hit, 1 << t, 0).int()
    return bits


_T_BITS = {}                   # (device) -> int32 [16]: 1 << t


def kword_window_hits(t_bits: torch.Tensor,
                      active: torch.Tensor) -> torch.Tensor:
    """The K-word match bit from per-group window scans: t_bits [G, N, Pa]
    int32 (`delta_mask_t_bits` of each constraint group's mask at the row's
    window W), active [G, N] bool (dead groups never constrain: they count
    as all bits set).  Anchor i matches iff some window start t in [0, W]
    is set in every active group's scan — all K words inside one
    (W + 1)-wide window containing the anchor.  The AND over groups is
    taken bit by bit (torch has no bitwise-AND reduction): four launches
    whatever G.  Returns bool [N, Pa]."""
    if t_bits.shape[0] == 0:
        return torch.zeros(t_bits.shape[1:], dtype=torch.bool,
                           device=t_bits.device)
    dev = t_bits.device
    if dev not in _T_BITS:
        _T_BITS[dev] = (torch.ones((), dtype=torch.int32, device=dev)
                        << torch.arange(KW_MAX_BAND + 1, dtype=torch.int32,
                                        device=dev))
    bits = torch.where(active[:, :, None], t_bits, -1)
    return (bits[..., None] & _T_BITS[dev]).all(dim=0).any(dim=-1)


# ---------------------------------------------------------------------------
# flash prefill attention
# ---------------------------------------------------------------------------

def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Causal GQA prefill attention, the reference's `ref.flash_prefill_ref`:
    q [B, S, Hq, D]; k, v [B, S, Hkv, D]; head = h * G + g; float32
    softmax; output in q's dtype."""
    B, S, Hq, D = q.shape
    G = Hq // k.shape[2]
    kk = torch.repeat_interleave(k, G, dim=2).float()
    vv = torch.repeat_interleave(v, G, dim=2).float()
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) / math.sqrt(D)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv).to(q.dtype)


def flash_prefill(q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Causal GQA prefill attention, q [B, S, Hq, D], k, v [B, S, Hkv, D] —
    the CUDA kernel on the card, the plain version on the CPU."""
    if _on_cpu(q, "flash_prefill"):
        return flash_prefill_plain(q, k, v)
    return flash_prefill_cuda(q, k, v)


# ---------------------------------------------------------------------------
# flash decode attention
# ---------------------------------------------------------------------------

def _kv_len_rows(kv_len, batch: int, device) -> torch.Tensor:
    """kv_len as int32 [batch] on `device` (a scalar is broadcast)."""
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=device)
    if kv_len.dim() == 0:
        kv_len = kv_len.expand(batch)
    return kv_len.contiguous()


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_len) -> torch.Tensor:
    """One-token GQA decode attention, the reference's `ref.flash_decode_ref`:
    q [B, Hq, D]; k, v [B, S, Hkv, D]; kv_len [B] or scalar valid cache
    rows (more than S reads all S).  Float32 softmax; output in q's dtype.
    A row with kv_len <= 0 gives zeros, as the reference's Pallas kernel
    does (`ref.flash_decode_ref` gives NaN there)."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kv_len = _kv_len_rows(kv_len, B, q.device)
    qf = q.float().reshape(B, Hkv, G, D)
    logits = torch.einsum("bhgd,bshd->bhgs", qf, k.float()) / math.sqrt(D)
    mask = torch.arange(S, device=q.device)[None, :] < kv_len[:, None]
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    out = torch.where((kv_len > 0)[:, None, None, None], out, 0.0)
    return out.reshape(B, Hq, D).to(q.dtype)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len) -> torch.Tensor:
    """One-token GQA decode attention, q [B, Hq, D], k, v [B, S, Hkv, D],
    kv_len [B] or scalar — the CUDA kernel on the card, the plain version
    on the CPU."""
    if _on_cpu(q, "flash_decode"):
        return flash_decode_plain(q, k, v, kv_len)
    return flash_decode_cuda(q, k, v, _kv_len_rows(kv_len, q.shape[0],
                                                   q.device))


# ---------------------------------------------------------------------------
# embedding bag
# ---------------------------------------------------------------------------

def _bag_sums_plain(table: torch.Tensor, ids: torch.Tensor,
                    weights: Optional[torch.Tensor]) -> torch.Tensor:
    """The kernel's function: float32 [B, D] sums of table rows (times the
    weights, when given), added field by field f = 0 .. F-1 as the Pallas
    grid does, the product and the sum rounded apart; negative ids are
    skipped and ids >= V read row V - 1 (the reference's clamping
    gather)."""
    B, F = ids.shape
    V, D = table.shape
    out = torch.zeros((B, D), dtype=torch.float32, device=table.device)
    valid = ids >= 0
    rows = ids.clamp(0, V - 1).long()
    for f in range(F):
        x = table[rows[:, f]].float()
        if weights is not None:
            x = weights[:, f, None].float() * x
        out = torch.where(valid[:, f, None], out + x, out)
    return out


def _bag_combine(sums: torch.Tensor, ids: torch.Tensor, combine: str,
                 dtype: torch.dtype) -> torch.Tensor:
    """The reference wrapper's tail: mean divides by the count of valid ids
    (at least 1) in float32; the result takes the table's dtype."""
    if combine == "mean":
        denom = (ids >= 0).sum(dim=1, keepdim=True).clamp(min=1).float()
        sums = sums / denom
    return sums.to(dtype)


def _check_bag_args(table, ids, weights, combine):
    if combine not in ("sum", "mean"):
        raise ValueError(f"segment_bag: combine {combine!r}, want 'sum' or "
                         f"'mean'")
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"segment_bag: table {tuple(table.shape)}, ids "
                         f"{tuple(ids.shape)}: want [V, D] and [B, F]")
    if ids.dtype.is_floating_point or ids.dtype == torch.bool:
        raise ValueError(f"segment_bag: ids are {ids.dtype}, want integers")
    if weights is not None and weights.shape != ids.shape:
        raise ValueError(f"segment_bag: weights {tuple(weights.shape)}, ids "
                         f"{tuple(ids.shape)}")


def segment_bag_plain(table: torch.Tensor, ids: torch.Tensor,
                      weights: Optional[torch.Tensor] = None,
                      combine: str = "sum") -> torch.Tensor:
    """EmbeddingBag(table, ids) -> [B, D] in table's dtype, in plain tensor
    code on any device: table [V, D]; ids [B, F] (negative = pad); weights
    [B, F] (default ones; cast to table's dtype first, so bf16 tables
    round their weights); combine 'sum' or 'mean'.  The reference's
    `ops.segment_bag` around `ref.segment_bag_ref`'s function."""
    _check_bag_args(table, ids, weights, combine)
    w = None if weights is None else weights.to(table.dtype)
    return _bag_combine(_bag_sums_plain(table, ids, w), ids, combine,
                        table.dtype)


def segment_bag(table: torch.Tensor, ids: torch.Tensor,
                weights: Optional[torch.Tensor] = None,
                combine: str = "sum") -> torch.Tensor:
    """EmbeddingBag (see segment_bag_plain) — the CUDA kernel on the card,
    the plain version on the CPU.  On the card the kernel takes int32 ids:
    ids of a wider type are clamped to [-1, V - 1] first, so that none
    wraps in the cast (the kernel clamps int32 ids >= V itself), and the
    float32 sums get the mean and the table's dtype here, as in the
    reference's wrapper."""
    if _on_cpu(table, "segment_bag"):
        return segment_bag_plain(table, ids, weights, combine)
    _check_bag_args(table, ids, weights, combine)
    V = table.shape[0]
    if ids.dtype != torch.int32:
        if V >= 2**31:
            raise ValueError(f"segment_bag: {V} table rows do not fit the "
                             f"kernel's int32 ids")
        ids = ids.clamp(-1, V - 1).to(torch.int32)
    w = None if weights is None else weights.to(table.dtype).contiguous()
    sums = segment_bag_cuda(table.contiguous(), ids.contiguous(), w)
    return _bag_combine(sums, ids, combine, table.dtype)
