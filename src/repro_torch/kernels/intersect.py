"""CUDA wrappers of the banded row kernels (csrc/intersect.cu,
csrc/min_delta.cu, csrc/delta_mask.cu).

They replace the three row kernels of src/repro/kernels/intersect.py:

* `banded_intersect_rows_cuda` — banded_intersect_rows_pallas
  (`_kernel_rows`) and, as one row, banded_intersect_pallas; bound
  N * (5 * Pa + 4 * Pb) bytes;
* `banded_min_delta_rows_cuda` — banded_min_delta_rows_pallas
  (`_kernel_rows_min_delta`), the ranked path's scoring pass; bound
  N * (8 * Pa + 8 * Pb) bytes;
* `banded_delta_mask_rows_cuda` — banded_delta_mask_rows_pallas
  (`_kernel_rows_delta_mask`), the K-word join's per-group masks; bound
  N * (8 * Pa + 4 * Pb) bytes.

Each launches one thread per `a` element, which runs a lower-bound search
of its row of `b` and a short forward walk; the min-delta kernel copies a
fence of every s-th key of its row into shared memory (`fence_stride`
plans s), then a sub-fence and one window of the row, each in one round of
copies.
See the source notes in csrc/ for the designs, and the `*_plain`
functions of `ops` for the plain PyTorch versions of the same functions.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

FENCE_KEYS = 16            # the min-delta fence's keys a row: s = 1024 at
                           # Pb = 16384 (measured against 32-256 keys)
FENCE_MIN_STRIDE = 64      # the window's width: a shorter segment needs no
                           # denser fence


def fence_stride(pb: int) -> int:
    """The min-delta kernel's fence stride s for rows of `pb` keys: the
    smallest power of two >= FENCE_MIN_STRIDE that keeps the fence within
    FENCE_KEYS keys.  The kernel builds no fence when pb <= s (its
    sub-fence and window then cover the row)."""
    s = FENCE_MIN_STRIDE
    while -(-pb // s) > FENCE_KEYS:
        s *= 2
    return s


def _check_rows(a: torch.Tensor, bands: torch.Tensor, **bs: torch.Tensor):
    """Device, dtype and shape checks shared by the row kernels: every
    tensor int32 on a's card, a and each b [N, P], bands [N]; returns the
    contiguous tensors (a, bands, *bs)."""
    named = {"a": a, "bands": bands, **bs}
    for name, x in named.items():
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
        if x.device != a.device:
            raise ValueError(f"{name} on {x.device}, a on {a.device}")
    shapes = {k: tuple(x.shape) for k, x in named.items()}
    if a.dim() != 2 or bands.dim() != 1 or bands.shape[0] != a.shape[0] \
            or any(x.dim() != 2 or x.shape[0] != a.shape[0]
                   for x in bs.values()):
        raise ValueError(f"bad shapes {shapes}")
    if len({x.shape[1] for x in bs.values()}) > 1:
        raise ValueError(f"b planes differ in width: {shapes}")
    return tuple(x.contiguous() for x in named.values())


def banded_intersect_rows_cuda(a: torch.Tensor, b_sorted: torch.Tensor,
                               bands: torch.Tensor) -> torch.Tensor:
    """found[n, i] = exists j with |a[n, i] - b_sorted[n, j]| <= bands[n],
    False where a[n, i] is the int32 sentinel; a [N, Pa], b_sorted [N, Pb]
    ascending per row, bands [N], all int32 on the card.  Returns bool
    [N, Pa].  Adds one to `banded_intersect_rows_cuda.launches` per kernel
    launch."""
    a, bands, b_sorted = _check_rows(a, bands, b_sorted=b_sorted)
    N, pa = a.shape
    found = torch.empty((N, pa), dtype=torch.bool, device=a.device)
    if N * pa:
        fn = build.load("intersect")
        err = fn(a.data_ptr(), b_sorted.data_ptr(), bands.data_ptr(), N, pa,
                 b_sorted.shape[1], found.data_ptr(),
                 torch.cuda.current_stream(a.device).cuda_stream)
        build.check(err, "banded_intersect_rows")
        banded_intersect_rows_cuda.launches += 1
    return found


def banded_min_delta_rows_cuda(a: torch.Tensor, bk: torch.Tensor,
                               bd: torch.Tensor,
                               bands: torch.Tensor) -> torch.Tensor:
    """out[n, i] = min over j with |a[n, i] - bk[n, j]| <= bands[n] of
    (|a[n, i] - bk[n, j]| + bd[n, j]), the int32 sentinel where no j is in
    band or a[n, i] is the sentinel; a [N, Pa], bk and bd [N, Pb] with bk
    ascending per row and bd >= 0, bands [N], all int32 on the card; the
    fence stride is `fence_stride(Pb)`.  Returns int32 [N, Pa].  Adds one
    to `banded_min_delta_rows_cuda.launches` per kernel launch."""
    a, bands, bk, bd = _check_rows(a, bands, bk=bk, bd=bd)
    N, pa = a.shape
    out = torch.empty((N, pa), dtype=torch.int32, device=a.device)
    if N * pa:
        pb = bk.shape[1]
        fn = build.load("min_delta")
        err = fn(a.data_ptr(), bk.data_ptr(), bd.data_ptr(), bands.data_ptr(),
                 N, pa, pb, fence_stride(pb), out.data_ptr(),
                 torch.cuda.current_stream(a.device).cuda_stream)
        build.check(err, "banded_min_delta_rows")
        banded_min_delta_rows_cuda.launches += 1
    return out


def banded_delta_mask_rows_cuda(a: torch.Tensor, b_sorted: torch.Tensor,
                                bands: torch.Tensor) -> torch.Tensor:
    """out[n, i] has bit (d + bands[n]) set iff some b_sorted[n, j] ==
    a[n, i] + d with |d| <= min(bands[n], 15); 0 where a[n, i] is the int32
    sentinel; a [N, Pa], b_sorted [N, Pb] ascending per row, bands [N], all
    int32 on the card.  Returns int32 [N, Pa].  Adds one to
    `banded_delta_mask_rows_cuda.launches` per kernel launch."""
    a, bands, b_sorted = _check_rows(a, bands, b_sorted=b_sorted)
    N, pa = a.shape
    out = torch.empty((N, pa), dtype=torch.int32, device=a.device)
    if N * pa:
        fn = build.load("delta_mask")
        err = fn(a.data_ptr(), b_sorted.data_ptr(), bands.data_ptr(), N, pa,
                 b_sorted.shape[1], out.data_ptr(),
                 torch.cuda.current_stream(a.device).cuda_stream)
        build.check(err, "banded_delta_mask_rows")
        banded_delta_mask_rows_cuda.launches += 1
    return out


banded_intersect_rows_cuda.launches = 0
banded_min_delta_rows_cuda.launches = 0
banded_delta_mask_rows_cuda.launches = 0

MIN_DELTA_INFO_FIELDS = ("threads", "registers", "local_bytes",
                         "dynamic_smem_bytes", "window", "sub_fence_keys",
                         "int4_window")


def banded_min_delta_rows_info(pb: int) -> dict:
    """The compiled min-delta kernel that rows of `pb` keys launch: its
    fence stride and keys (`fence_stride`), threads per CTA, registers and
    local (spill) bytes per thread as the runtime reports them, its shared
    memory, the window's entries, the sub-fence's keys and whether the
    window is copied in 16-byte chunks.  Needs the card."""
    s = fence_stride(pb)
    out = (ctypes.c_longlong * len(MIN_DELTA_INFO_FIELDS))()
    fn = build.load("min_delta", "banded_min_delta_rows_info")
    build.check(fn(pb, ctypes.addressof(out)), "banded_min_delta_rows_info")
    return {"fence_stride": s, "fence_keys": -(-pb // s) if pb > s else 0,
            **dict(zip(MIN_DELTA_INFO_FIELDS, out))}
