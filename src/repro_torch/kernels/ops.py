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

On a CUDA tensor each kernel is one operator of the `repro_torch`
library (`torch.ops.repro_torch.<name>`): its CUDA implementation is the
kernel's launch, its CPU implementation the plain version, and its fake
implementation gives the outputs' shapes and dtypes alone (none of the
plain version's temporaries), so that a `FakeTensorMode` pass on device
`cuda` (the dry-run, launch/dryrun.py) sees each kernel as one op and
launches nothing.  A CPU tensor calls the plain version directly (its
autograd included); a meta tensor takes the operator, as a CUDA one.
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


# ---------------------------------------------------------------------------
# the kernels as operators (see the module docstring)
# ---------------------------------------------------------------------------

_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("unpack_postings(Tensor lanes, Tensor blk_meta, Tensor idx) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.define("banded_intersect_rows(Tensor a, Tensor b_sorted, Tensor bands) "
            "-> Tensor")
_LIB.define("banded_min_delta_rows(Tensor a, Tensor bk, Tensor bd, "
            "Tensor bands) -> Tensor")
_LIB.define("banded_delta_mask_rows(Tensor a, Tensor b_sorted, Tensor bands, "
            "Tensor windows) -> (Tensor, Tensor)")
_LIB.define("flash_decode(Tensor q, Tensor k, Tensor v, Tensor kv_len) "
            "-> Tensor")
_LIB.define("segment_bag_sums(Tensor table, Tensor ids, Tensor? weights) "
            "-> Tensor")
KERNEL_OPS = ("unpack_postings", "banded_intersect_rows",
              "banded_min_delta_rows", "banded_delta_mask_rows",
              "flash_decode", "segment_bag_sums")


def _define(name: str, cuda: str, cpu, fake):
    """Register operator `name`: its CUDA implementation is this module's
    wrapper `cuda`, looked up at each call (so that a caller may replace
    it), its CPU implementation `cpu`, its fake implementation `fake`."""
    _LIB.impl(name, lambda *args: globals()[cuda](*args), "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)


def _on_cpu(x: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (the plain version); False for a CUDA tensor
    and for a meta one, which take the operator (a meta tensor is the
    dry-run's pass on a PyTorch built without CUDA, where autograd cannot
    run on fake CUDA tensors; the operator's fake implementation serves
    it)."""
    if x.is_cuda or x.is_meta:
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
    return torch.ops.repro_torch.unpack_postings(arena["lanes"],
                                                 arena["blk_meta"], idx)


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
    return torch.ops.repro_torch.banded_intersect_rows(a, b_sorted, bands)


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
    return torch.ops.repro_torch.banded_min_delta_rows(a, bk, bd, bands)


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
    return torch.ops.repro_torch.banded_delta_mask_rows(a, b_sorted, bands,
                                                        windows)


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
    return torch.ops.repro_torch.flash_decode(
        q, k, v, _kv_len_rows(kv_len, q.shape[0], q.device))


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


class SegmentBagFn(torch.autograd.Function):
    """The bag's sums under autograd: `apply(table, weights, ids, sums)`
    returns `sums(table, ids, weights)`, float32 [B, D] (on the card
    `segment_bag_cuda`, the kernel; any function of the kernel's contract
    in its place, such as `_bag_sums_plain` in the CPU tests).  The
    backward transposes the gather, as the reference's autodiff of
    `take` does (the reference has no backward kernel): d table is an
    `index_add_` of w * grad over the valid ids (ids >= V go to row V - 1,
    as the forward clamps them; float atomics on the card, so the order
    of the additions varies), d weights the dot of grad with each id's
    row.  Negative ids get no gradient; `weights` may be None."""

    @staticmethod
    def forward(ctx, table, weights, ids, sums):
        ctx.save_for_backward(table, weights, ids)
        return sums(table, ids, weights)

    @staticmethod
    def backward(ctx, grad):
        table, weights, ids = ctx.saved_tensors
        V, D = table.shape
        valid = (ids >= 0)[..., None]                         # [B, F, 1]
        rows = torch.where(valid[..., 0], ids.long().clamp(max=V - 1), 0)
        g = grad.float()[:, None, :]                          # [B, 1, D]
        d_table = d_weights = None
        if ctx.needs_input_grad[0]:
            contrib = g if weights is None else g * weights.float()[..., None]
            contrib = contrib.expand(*ids.shape, D) * valid
            d_table = torch.zeros((V, D), dtype=torch.float32,
                                  device=table.device)
            d_table.index_add_(0, rows.reshape(-1), contrib.reshape(-1, D))
            d_table = d_table.to(table.dtype)
        if weights is not None and ctx.needs_input_grad[1]:
            d_weights = ((g * table[rows].float()).sum(-1)
                         * valid[..., 0]).to(weights.dtype)
        return d_table, d_weights, None, None


def segment_bag(table: torch.Tensor, ids: torch.Tensor,
                weights: Optional[torch.Tensor] = None,
                combine: str = "sum") -> torch.Tensor:
    """EmbeddingBag (see segment_bag_plain) — the CUDA kernel on the card,
    the plain version on the CPU.  On the card the kernel takes int32 ids:
    ids of a wider type are clamped to [-1, V - 1] first, so that none
    wraps in the cast (the kernel clamps int32 ids >= V itself), and the
    float32 sums get the mean and the table's dtype here, as in the
    reference's wrapper.  With grad enabled the kernel runs under
    `SegmentBagFn`, so the sums have a gradient (on the CPU the plain
    version's own)."""
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
    table, ids = table.contiguous(), ids.contiguous()
    sums_op = torch.ops.repro_torch.segment_bag_sums
    if torch.is_grad_enabled():
        sums = SegmentBagFn.apply(table, w, ids, sums_op)
    else:
        sums = sums_op(table, ids, w)
    return _bag_combine(sums, ids, combine, table.dtype)


# ---------------------------------------------------------------------------
# operator registrations: CUDA = the kernel, CPU = the plain version (each
# looked up at call time), fake = the outputs' shapes and dtypes
# ---------------------------------------------------------------------------

def _i32_like(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=torch.int32, device=x.device)


_define("unpack_postings", "unpack_postings_cuda",
        lambda lanes, meta, idx: unpack_postings_plain(
            {"lanes": lanes, "blk_meta": meta}, idx),
        lambda lanes, meta, idx: (_i32_like(idx), _i32_like(idx),
                                  _i32_like(idx)))
_define("banded_intersect_rows", "banded_intersect_rows_cuda",
        lambda *args: banded_intersect_rows_plain(*args),
        lambda a, b, bands: torch.empty(a.shape, dtype=torch.bool,
                                        device=a.device))
_define("banded_min_delta_rows", "banded_min_delta_rows_cuda",
        lambda *args: banded_min_delta_rows_plain(*args),
        lambda a, bk, bd, bands: _i32_like(a))
_define("banded_delta_mask_rows", "banded_delta_mask_rows_cuda",
        lambda a, b, bands, windows: (
            lambda m: (m, delta_mask_t_bits(m, windows)))(
                banded_delta_mask_rows_plain(a, b, bands)),
        lambda a, b, bands, windows: (_i32_like(a), _i32_like(a)))
_define("flash_decode", "flash_decode_cuda",
        lambda *args: flash_decode_plain(*args),
        lambda q, k, v, kv_len: torch.empty_like(q))
_define("segment_bag_sums", "segment_bag_cuda",
        lambda *args: _bag_sums_plain(*args),
        lambda table, ids, weights: torch.empty(
            (ids.shape[0], table.shape[1]), dtype=torch.float32,
            device=table.device))
