"""Least bytes and operations of the search kernels' calls, and the card's
peaks: a kernel's roofline share is the least time its recorded calls
could take over the time the trace gives them.

`unpack_bound` and `band_bound` are frozen copies of chip_smoke.py's; the
peaks are NVIDIA's data sheet for one H100 SXM (dense, 700 W).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
INT_OPS_PER_S = 33.5e12        # 67 TFLOP/s float32 outside the tensor
                               # cores, counted per instruction (int32
                               # runs at the float32 instruction rate)
I32_SENTINEL = 2**31 - 1


def least_seconds(nbytes: int, ops: int) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the instruction rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / INT_OPS_PER_S)


def unpack_bound(torch, blk_meta, idx):
    """Least bytes and int ops of an unpack call on these inputs: each
    ordinal read, each touched metadata row and lane word read once, three
    int32 outputs written."""
    n = idx.numel()
    blk = (idx.reshape(-1) >> 7).clamp(0, blk_meta.shape[0] - 1).long()
    off = (idx.reshape(-1) & 127).long()
    meta = blk_meta[blk].long()
    ws = [meta[:, 1] & 63, (meta[:, 1] >> 6) & 63, (meta[:, 1] >> 12) & 63]
    fb = meta[:, 0]
    words = []
    for w in ws:
        live = w > 0
        words.append((fb + ((off * w) >> 5))[live])
        fb = fb + (w << 2)
    n_words = torch.cat(words).unique().numel()
    n_rows = blk.unique().numel()
    nbytes = 4 * n + 20 * n_rows + 4 * n_words + 12 * n
    return nbytes, 40 * n


def band_bound(torch, a, b, bands, out_bytes, delta_plane=False,
               walk=False, max_band=None):
    """Least bytes and int ops of a banded row kernel (intersect, min delta,
    delta mask) on these inputs.  Bytes: a read and the output written
    (`out_bytes` per a element), bands read, and of b only the 32-byte
    sectors holding what the answer depends on: per live a element the
    b keys inside its band (capped at `max_band`) and the one on each side
    that closes it, plus, with `delta_plane`, the deltas inside the band;
    each sector once per row.  Ops: a lower-bound search per a element,
    and with `walk` three per in-band b entry."""
    N, pa = a.shape
    pb = b.shape[1]
    band = bands.long()[:, None]
    if max_band is not None:
        band = band.clamp(max=max_band)
    b64 = b.long().contiguous()
    live = a != I32_SENTINEL
    lo = torch.searchsorted(b64, (a.long() - band).contiguous())
    hi = torch.searchsorted(b64, (a.long() + band).contiguous(), side="right")

    def sectors(start, end):
        start = torch.where(live, start.clamp(0, pb), 0)
        end = torch.where(live, end.clamp(0, pb), 0).clamp(min=start)
        cover = torch.zeros((N, pb + 1), dtype=torch.int64, device=a.device)
        ones = torch.ones_like(start)
        cover.scatter_add_(1, start, ones)
        cover.scatter_add_(1, end, -ones)
        used = cover.cumsum(1)[:, :pb] > 0
        used = torch.cat([used, used.new_zeros((N, -pb % 8))], dim=1)
        return int(used.reshape(N, -1, 8).any(-1).sum())

    b_sectors = sectors(lo - 1, hi + 1)
    if delta_plane:
        b_sectors += sectors(lo, hi)
    nbytes = N * pa * (4 + out_bytes) + 4 * N + 32 * b_sectors
    ops = N * pa * (2 + 3 * max(1, pb.bit_length()))
    if walk:
        ops += 3 * int(((hi - lo).clamp(min=0) * live).sum())
    return nbytes, ops


def call_bound(torch, kernel: str, args) -> tuple[int, int]:
    """(bytes, ops) of one recorded call: `args` as the kernel's wrapper
    got them."""
    if kernel == "unpack":
        _lanes, blk_meta, idx = args
        return unpack_bound(torch, blk_meta, idx)
    if kernel == "intersect":
        a, b, bands = args
        return band_bound(torch, a, b, bands, 1)
    if kernel == "min_delta":
        a, bk, _bd, bands = args
        return band_bound(torch, a, bk, bands, 4, delta_plane=True, walk=True)
    if kernel == "delta_mask":
        a, b, bands, _windows = args
        # the mask and its window scan written, the windows read
        nbytes, ops = band_bound(torch, a, b, bands, 8, walk=True, max_band=15)
        return nbytes + 4 * a.shape[0], ops
    raise ValueError(f"unknown kernel {kernel!r}")
