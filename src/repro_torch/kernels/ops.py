"""Kernel dispatch and the plain PyTorch versions of the kernels.

Each op dispatches on the device of its tensors: a CUDA tensor launches the
hand-written kernel (unpack.py, intersect.py; sources in csrc/) or raises,
a CPU tensor takes the plain version below.  The plain versions are pure
tensor code that runs on either device; the CPU tests hold them against the
reference package, and chip_smoke.py holds the kernels against them on the
card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.intersect import banded_intersect_rows_cuda
from repro_torch.kernels.unpack import unpack_postings_cuda

I32_SENTINEL = 2**31 - 1     # int32 pad key: never matches a banded probe

# packed-postings block geometry (== core.postings.BLOCK_LOG2 and
# PACK_WIDTH_BITS; literal so the kernel layer stays import-free of core)
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
