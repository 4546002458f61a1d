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
  (`_kernel_rows_delta_mask`), the K-word join's per-group masks, with the
  reference's `delta_mask_t_bits` window scan of each mask in the same
  launch; bound N * (12 * Pa + 4 * Pb) bytes.

Each launches one thread per `a` element, 128 to a CTA, which searches its
row of `b` for the first key at or above `a - band` (csrc/row_search.cuh).
All three copy a fence of every s-th key of the row into shared memory
(`fence_stride` plans s); the min-delta kernel then copies a sub-fence and
one window of the row, each in one round of copies, and the intersect and
delta-mask kernels search the fence's segment in device memory.  Rows of
up to ROW_STAGE_KEYS keys the intersect and delta-mask kernels copy whole
into shared memory instead, in one round (`row_plan`).
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


ROW_STAGE_KEYS = 512       # the intersect and delta-mask kernels copy a
                           # row of up to this many keys (2 KB) whole into
                           # shared memory: per Pb class of the main path's
                           # calls, staging was fastest up to here and lost
                           # from 1024 up (csrc/intersect.cu)


def row_plan(pb: int) -> int:
    """The intersect and delta-mask kernels' plan for rows of `pb` keys: 0
    to copy the whole row into shared memory (pb <= ROW_STAGE_KEYS), else
    the fence stride `fence_stride(pb)` of min delta's search."""
    return 0 if pb <= ROW_STAGE_KEYS else fence_stride(pb)


def _check_rows(a: torch.Tensor, rows: dict, planes: dict):
    """Device, dtype and shape checks shared by the row kernels: every
    tensor int32 on a's card, a and each of `planes` [N, P], each of
    `rows` (bands, windows) [N]; returns the contiguous tensors (a,
    *rows, *planes)."""
    named = {"a": a, **rows, **planes}
    for name, x in named.items():
        if not x.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
        if x.device != a.device:
            raise ValueError(f"{name} on {x.device}, a on {a.device}")
    shapes = {k: tuple(x.shape) for k, x in named.items()}
    if a.dim() != 2 \
            or any(x.dim() != 1 or x.shape[0] != a.shape[0]
                   for x in rows.values()) \
            or any(x.dim() != 2 or x.shape[0] != a.shape[0]
                   for x in planes.values()):
        raise ValueError(f"bad shapes {shapes}")
    if len({x.shape[1] for x in planes.values()}) > 1:
        raise ValueError(f"b planes differ in width: {shapes}")
    return tuple(x.contiguous() for x in named.values())


def banded_intersect_rows_cuda(a: torch.Tensor, b_sorted: torch.Tensor,
                               bands: torch.Tensor) -> torch.Tensor:
    """found[n, i] = exists j with |a[n, i] - b_sorted[n, j]| <= bands[n],
    False where a[n, i] is the int32 sentinel; a [N, Pa], b_sorted [N, Pb]
    ascending per row, bands [N], all int32 on the card; the regime is
    `row_plan(Pb)`.  Returns bool [N, Pa].  Adds one to
    `banded_intersect_rows_cuda.launches` per kernel launch."""
    a, bands, b_sorted = _check_rows(a, {"bands": bands},
                                     {"b_sorted": b_sorted})
    N, pa = a.shape
    found = torch.empty((N, pa), dtype=torch.bool, device=a.device)
    if N * pa:
        pb = b_sorted.shape[1]
        fn = build.load("intersect")
        err = fn(a.data_ptr(), b_sorted.data_ptr(), bands.data_ptr(), N, pa,
                 pb, row_plan(pb), found.data_ptr(),
                 torch.cuda.current_stream(a.device).cuda_stream)
        build.check(err, "banded_intersect_rows")
        build.count_launch(banded_intersect_rows_cuda)
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
    a, bands, bk, bd = _check_rows(a, {"bands": bands}, {"bk": bk, "bd": bd})
    N, pa = a.shape
    out = torch.empty((N, pa), dtype=torch.int32, device=a.device)
    if N * pa:
        pb = bk.shape[1]
        fn = build.load("min_delta")
        err = fn(a.data_ptr(), bk.data_ptr(), bd.data_ptr(), bands.data_ptr(),
                 N, pa, pb, fence_stride(pb), out.data_ptr(),
                 torch.cuda.current_stream(a.device).cuda_stream)
        build.check(err, "banded_min_delta_rows")
        build.count_launch(banded_min_delta_rows_cuda)
    return out


def banded_delta_mask_rows_cuda(a: torch.Tensor, b_sorted: torch.Tensor,
                                bands: torch.Tensor, windows: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(mask, t_bits), int32 [N, Pa] each, from one launch: mask[n, i] has
    bit (d + bands[n]) set iff some b_sorted[n, j] == a[n, i] + d with
    |d| <= min(bands[n], 15); t_bits[n, i] has bit t set iff t <=
    windows[n] and ((mask[n, i] >> t) & low(windows[n] + 1)) != 0 (the
    reference's `delta_mask_t_bits`); both 0 where a[n, i] is the int32
    sentinel.  a [N, Pa], b_sorted [N, Pb] ascending per row, bands and
    windows [N], all int32 on the card; the regime is `row_plan(Pb)`.
    Adds one to `banded_delta_mask_rows_cuda.launches` per kernel
    launch."""
    a, bands, windows, b_sorted = _check_rows(
        a, {"bands": bands, "windows": windows}, {"b_sorted": b_sorted})
    N, pa = a.shape
    out = torch.empty((2, N, pa), dtype=torch.int32, device=a.device)
    if N * pa:
        pb = b_sorted.shape[1]
        fn = build.load("delta_mask")
        err = fn(a.data_ptr(), b_sorted.data_ptr(), bands.data_ptr(),
                 windows.data_ptr(), N, pa, pb, row_plan(pb),
                 out[0].data_ptr(), out[1].data_ptr(),
                 torch.cuda.current_stream(a.device).cuda_stream)
        build.check(err, "banded_delta_mask_rows")
        build.count_launch(banded_delta_mask_rows_cuda)
    return out[0], out[1]


banded_intersect_rows_cuda.launches = 0
banded_min_delta_rows_cuda.launches = 0
banded_delta_mask_rows_cuda.launches = 0

MIN_DELTA_INFO_FIELDS = ("threads", "registers", "local_bytes",
                         "dynamic_smem_bytes", "window", "sub_fence_keys",
                         "int4_window")
ROW_INFO_FIELDS = ("threads", "registers", "local_bytes",
                   "dynamic_smem_bytes", "int4_copies")


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


def _row_info(source: str, pb: int) -> dict:
    s = row_plan(pb)
    out = (ctypes.c_longlong * len(ROW_INFO_FIELDS))()
    entry = f"banded_{source}_rows_info"
    fn = build.load(source, entry)
    build.check(fn(pb, s, ctypes.addressof(out)), entry)
    return {"regime": "row_staged" if s == 0 else "fenced",
            "staged_keys": pb if s == 0 else 0, "fence_stride": s,
            "fence_keys": -(-pb // s) if s and pb > s else 0,
            **dict(zip(ROW_INFO_FIELDS, out))}


def banded_intersect_rows_info(pb: int) -> dict:
    """The compiled intersect kernel that rows of `pb` keys launch: its
    regime (`row_plan`: the staged row's keys, or the fence's stride and
    keys), threads per CTA, registers and local (spill) bytes per thread
    as the runtime reports them, its shared memory and whether the staged
    row is copied in 16-byte chunks.  Needs the card."""
    return _row_info("intersect", pb)


def banded_delta_mask_rows_info(pb: int) -> dict:
    """The compiled delta-mask kernel that rows of `pb` keys launch, as
    `banded_intersect_rows_info` reports it.  Needs the card."""
    return _row_info("delta_mask", pb)
