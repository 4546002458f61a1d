"""Seeded edge cases of the redesigned kernels, shared by the card tests
(tests/test_torch_kernels.py), the CPU tests that hold the plain versions
against the reference on them, and chip_smoke.py's kernel phases.

* `md_edge_case(name)` — min-delta rows that put runs, probes and row
  widths where the kernel's fence search has its edges;
* `row_edge_case(name)` — intersect and delta-mask rows that put row
  widths, runs, probes and sentinels where the two kernels' regimes (the
  staged row, the fence) have their edges;
* `bag_edge_case(name)` — embedding bags that put ragged tiles, unaligned
  tile starts, staged fields and all-pad bags where the kernel's tiles
  have their edges;
* `bag_past_4gib(device)` — bags that read a 4.6 GB table past its first
  4 GiB;
* `offset_view(x)` — a tensor as a view 4 bytes past a 16-byte boundary.

Each case is made from its own seed, with numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.intersect import (ROW_STAGE_KEYS, fence_stride,
                                           row_plan)
from repro_torch.kernels.segment_bag import bag_tile, bag_vec

I32_MAX = np.iinfo(np.int32).max
SDB, SDM = 4, 15           # the (key, delta) layout: ops.SCORE_DELTA_BITS


MD_EDGE_CASES = ("pb_not_stride_multiple", "pb_within_one_stride",
                 "run_straddles_fence", "key_equals_fence_key",
                 "unsorted_a_segments", "all_sentinel_row")
MD_BANDS = np.array([0, 1, 8, 15], np.int32)
# the row widths each case is made at: the first is the case's own (the
# CPU tests hold the plain version against the reference there); with
# the others the stride that `fence_stride` plans reaches the search's
# other paths: pb 4096 (s 256, a sub-fence of three keys), 16384 (s 1024,
# fifteen, the main path's width) and 30000 or 32768 (s 2048: binary steps
# in device memory down to the window)
MD_EDGE_WIDTHS = {"pb_not_stride_multiple": (1000, 4000, 30000),
                  "pb_within_one_stride": (40,),
                  "run_straddles_fence": (256, 4096, 32768),
                  "key_equals_fence_key": (512, 16384),
                  "unsorted_a_segments": (512, 16384),
                  "all_sentinel_row": (512, 4096)}
MD_WINDOW, MD_SUB_KEYS = 64, 16   # csrc/min_delta.cu's W and kSub


def md_sub_stride(s):
    """The sub-fence's stride inside an s-entry segment (min_delta.cu's
    s2)."""
    return max(s // MD_SUB_KEYS, MD_WINDOW)


def composite_rows(rng, keys, pb):
    """bk, bd [len(keys), pb]: each row's keys with a delta in [0, 15]
    beside each, sorted by (key, delta), sentinel tails with delta 0."""
    bk = np.full((len(keys), pb), I32_MAX, np.int32)
    bd = np.zeros((len(keys), pb), np.int32)
    for r, k in enumerate(keys):
        comp = np.sort((np.asarray(k, np.int64) << SDB)
                       | rng.integers(0, 16, len(k)))
        bk[r, :len(k)] = comp >> SDB
        bd[r, :len(k)] = comp & SDM
    return bk, bd


def probes(rng, bk_row, band, n):
    """n probes about the row's keys: keys, keys +- band, +- (band + 1),
    keys off by up to 20 either way, and some past the last key by more
    than any band; none negative, as in the rebased key domain (the Pallas
    kernel's int32 |a - b| wraps for a negative probe against a sentinel
    pad)."""
    live = bk_row[bk_row != I32_MAX].astype(np.int64)
    k = live[rng.integers(0, len(live), n)]
    off = rng.choice([0, band, -band, band + 1, -band - 1, 1, -1], n)
    off = np.where(rng.random(n) < 0.25, rng.integers(-20, 21, n), off)
    far = live[-1] + 16 + rng.integers(0, 1000, n)
    return np.where(rng.random(n) < 0.15, far,
                    np.maximum(k + off, 0)).astype(np.int32)


def md_edge_case(name, pb=None):
    """(a, bk, bd, bands) of one fence edge case at row width `pb` (default
    the case's own, MD_EDGE_WIDTHS), four rows with bands 0, 1, 8 and 15,
    keys dense enough that bands hold several keys and equal keys form
    runs; s is the planned stride, `fence_stride(pb)`:
    pb_not_stride_multiple  pb 1000 (s 64), 4000 or 30000: no multiple of s;
    pb_within_one_stride    pb 40: no fence, one search of the row;
    run_straddles_fence     runs of one key across the fence keys s, 2s and
                            3s, each the last entry of a segment, and
                            across the sub-fence keys and the window's end
                            after the first;
    key_equals_fence_key    probes at fence keys and at fence keys +- band,
                            runs that start at a fence key;
    unsorted_a_segments     a as four doc-shard segments of 32 sorted keys,
                            sentinel-padded, in random order (the batch
                            executor's layout);
    all_sentinel_row        an all-sentinel a row, an all-sentinel b row and
                            a b row of one key."""
    pb = MD_EDGE_WIDTHS[name][0] if pb is None else pb
    rng = np.random.default_rng(MD_EDGE_CASES.index(name) + 100 + pb)
    pa = 128
    s = fence_stride(pb)
    keys = [np.sort(rng.integers(0, 2 * pb, pb - int(rng.integers(0, pb // 8))))
            for _ in range(4)]
    if name in ("run_straddles_fence", "key_equals_fence_key"):
        s2 = md_sub_stride(s)
        edges = sorted({s, 2 * s, 3 * s, s + s2, s + 2 * s2, s + MD_WINDOW})
        for k in keys:
            for e in edges:
                if e + 9 <= len(k):
                    k[e - 8:e + 9] = k[e - 8]
            k.sort()
    if name == "all_sentinel_row":
        keys[2] = keys[2][:0]
        keys[3] = keys[3][:1]
    bk, bd = composite_rows(rng, keys, pb)
    a = np.full((4, pa), I32_MAX, np.int32)
    for r in range(4):
        if not len(keys[r]):
            a[r] = rng.integers(0, 2 * pb, pa)
            continue
        a[r] = probes(rng, bk[r], int(MD_BANDS[r]), pa)
        if name == "key_equals_fence_key":
            fence = bk[r, :len(keys[r]):s].astype(np.int64)
            band = int(MD_BANDS[r])
            at = np.concatenate([fence, fence + band,
                                 np.maximum(fence - band, 0)])[:pa]
            a[r, :len(at)] = at
        if name == "unsorted_a_segments":
            seg = np.full((4, 32), I32_MAX, np.int32)
            for s_ in range(4):
                n = int(rng.integers(8, 33))
                seg[s_, :n] = np.sort(a[r, s_ * 32:s_ * 32 + n])
            a[r] = seg[rng.permutation(4)].reshape(-1)
    if name == "all_sentinel_row":
        a[1] = I32_MAX
    return a, bk, bd, MD_BANDS.copy()


ROW_EDGE_CASES = ("pb_at_stage_threshold", "pb_not_stride_multiple",
                  "run_straddles_edges", "long_in_band_run", "near_int32_max",
                  "unsorted_a_segments", "all_sentinel_rows_and_slices")
# six rows: bands 0, 1, 8 and 15, then two inactive pads of a K-word task
# (band 0) whose windows are the task's W, not their band
ROW_BANDS = np.array([0, 1, 8, 15, 0, 0], np.int32)
ROW_WINDOWS = np.array([0, 1, 8, 15, 8, 15], np.int32)
ROW_PA = 256               # two 128-thread slices a row
# the row widths each case is made at, the first its own (the CPU tests
# hold the plain versions against the reference there); `row_plan`
# stages rows of up to ROW_STAGE_KEYS keys (by 16-byte copies where the
# width is a multiple of 4, else 4-byte ones) and fences wider ones:
# 513 and 1000 at stride 64, 16384 at 1024 (the main path's delta-mask
# width), 30000 and 32768 at 2048
ROW_EDGE_WIDTHS = {
    "pb_at_stage_threshold": (ROW_STAGE_KEYS, ROW_STAGE_KEYS + 1),
    "pb_not_stride_multiple": (301, 1000, 30000),
    "run_straddles_edges": (ROW_STAGE_KEYS, 16384, 32768),
    "long_in_band_run": (256, 16384),
    "near_int32_max": (256, 16384),
    "unsorted_a_segments": (ROW_STAGE_KEYS, 16384),
    "all_sentinel_rows_and_slices": (ROW_STAGE_KEYS, 16384),
}
ROW_RUN = 80               # long_in_band_run's in-band entries: past two
                           # 128-byte lines


def row_regime(pb):
    """The regime of the two kernels' search that rows of `pb` keys take:
    'row staged, 16-byte copies', 'row staged, 4-byte copies' or
    'fenced'."""
    if row_plan(pb):
        return "fenced"
    return f"row staged, {16 if pb % 4 == 0 else 4}-byte copies"


def row_edge_case(name, pb=None):
    """(a, b, bands, windows) of one regime edge case of the intersect and
    delta-mask kernels at row width `pb` (default the case's own,
    ROW_EDGE_WIDTHS): a [6, 256] (two slices a row), b [6, pb] ascending
    with dense keys (bands hold several, equal keys form runs) and a
    sentinel tail, bands ROW_BANDS, windows ROW_WINDOWS:
    pb_at_stage_threshold         pb ROW_STAGE_KEYS (the last staged row)
                                  and one key past it (fenced);
    pb_not_stride_multiple        pb 301 (staged by 4-byte copies), 1000
                                  and 30000: no multiple of the stride;
    run_straddles_edges           full rows (no tail) whose last 9 entries
                                  are one key (the staged row's end), and
                                  runs of one key across the fence keys
                                  s, 2s and 3s, with probes at the fence
                                  keys +- the band;
    long_in_band_run              a run of ROW_RUN in-band entries (keys
                                  x .. x + min(band, 15)) and probes in it:
                                  the delta mask's walk crosses lines;
    near_int32_max                full rows of keys up to INT32_MAX - 16,
                                  probes up to INT32_MAX - 1 (a + band
                                  wraps in int32);
    unsorted_a_segments           a as doc-shard segments of sorted keys,
                                  sentinel-padded, in random order;
    all_sentinel_rows_and_slices  an all-sentinel a row, an all-sentinel b
                                  row, a b row of one key, and rows whose
                                  second slice of a is all sentinels."""
    pb = ROW_EDGE_WIDTHS[name][0] if pb is None else pb
    rng = np.random.default_rng(ROW_EDGE_CASES.index(name) + 200 + pb)
    n, pa = len(ROW_BANDS), ROW_PA
    full = name in ("run_straddles_edges", "near_int32_max")
    if name == "near_int32_max":
        top = I32_MAX - 16
        keys = [np.sort(rng.integers(top - 2 * pb, top + 1, pb))
                for _ in range(n)]
    else:
        keys = [np.sort(rng.integers(
            0, 2 * pb, pb - (0 if full else int(rng.integers(1, pb // 8 + 2)))))
            for _ in range(n)]
    s = row_plan(pb) or fence_stride(pb)
    if name == "run_straddles_edges":
        edges = (s, 2 * s, 3 * s)
        for k in keys:
            for e in edges:
                if e + 9 <= len(k) - 10:
                    k[e - 8:e + 9] = k[e - 8]
            k[-9:] = k[-9]
            k.sort()
    run_at = []
    if name == "long_in_band_run":
        for r, k in enumerate(keys):
            w = min(int(ROW_BANDS[r]), 15)
            p = len(k) // 3
            x = int(k[p])
            k[p:p + ROW_RUN] = x + np.arange(ROW_RUN) * (w + 1) // ROW_RUN
            k.sort()
            run_at.append(x)
    if name == "all_sentinel_rows_and_slices":
        keys[2] = keys[2][:0]
        keys[3] = keys[3][:1]
    b = np.full((n, pb), I32_MAX, np.int32)
    for r, k in enumerate(keys):
        b[r, :len(k)] = k
    a = np.full((n, pa), I32_MAX, np.int32)
    for r in range(n):
        band = int(ROW_BANDS[r])
        if not len(keys[r]):
            a[r] = rng.integers(0, 2 * pb, pa)
            continue
        if name == "near_int32_max":
            k = keys[r][rng.integers(0, len(keys[r]), pa)].astype(np.int64)
            off = rng.choice([0, band, -band, band + 1, -band - 1, 1, -1], pa)
            a[r] = np.clip(k + off, 0, I32_MAX - 1)
            a[r, :4] = [I32_MAX - 1, I32_MAX - 1 - band, keys[r][-1],
                        min(keys[r][-1] + band + 1, I32_MAX - 1)]
            a[r, 4:8] = keys[r][0] - band - 1 - np.array([0, 5, 50, 100])
            continue
        a[r] = probes(rng, b[r], band, pa)
        if name == "run_straddles_edges":
            fence = b[r, :len(keys[r]):s].astype(np.int64)
            at = np.concatenate([fence, fence + band,
                                 np.maximum(fence - band, 0)])[:pa // 2]
            a[r, :len(at)] = at
        if name == "long_in_band_run":
            x, w = run_at[r], min(band, 15)
            a[r, :6] = [x, x + w // 2, x + w, x - w, x + 2 * w + 1, x - 1]
        if name == "unsorted_a_segments":
            seg = np.full((8, 32), I32_MAX, np.int32)
            for s_ in range(8):
                m = int(rng.integers(8, 33))
                seg[s_, :m] = np.sort(a[r, s_ * 32:s_ * 32 + m])
            a[r] = seg[rng.permutation(8)].reshape(-1)
    if name == "all_sentinel_rows_and_slices":
        a[1] = I32_MAX
        a[4:, 128:] = I32_MAX
    return a, b, ROW_BANDS.copy(), ROW_WINDOWS.copy()


BAG_EDGE_CASES = ("ragged_last_tile", "odd_F_unaligned_tiles",
                  "F_past_one_stage", "D_1", "all_pad_bags_at_tile_edges")


def bag_edge_case(name):
    """(table, ids, weights or None, tile) of one tile edge case of the
    embedding-bag kernel, float32 numpy, `tile` the planner's for an
    aligned table: ~10% pads, bag 0 all pads, an id past the table;
    ragged_last_tile            B 53 at D 10: 51 bags a tile, the last of 2;
    odd_F_unaligned_tiles       F 13: tiles start off 16-byte boundaries;
    F_past_one_stage            F 50 at D 1, weighted: the ids and weights
                                of 256 bags pass the shared-memory budget,
                                so the fields go in stages, the last one
                                short;
    D_1                         FM's linear term's shape, B 70;
    all_pad_bags_at_tile_edges  the first and last bag of every tile all
                                pads."""
    B, F, D, weighted = {"ragged_last_tile": (53, 39, 10, False),
                         "odd_F_unaligned_tiles": (120, 13, 10, True),
                         "F_past_one_stage": (300, 50, 1, True),
                         "D_1": (70, 39, 1, False),
                         "all_pad_bags_at_tile_edges": (120, 39, 10, False)}[name]
    rng = np.random.default_rng(BAG_EDGE_CASES.index(name) + 40)
    V = 500
    table = rng.normal(size=(V, D)).astype(np.float32)
    ids = rng.integers(0, V, (B, F)).astype(np.int32)
    ids[rng.random((B, F)) < 0.1] = -1
    ids[0] = -1
    ids[-1, -1] = V + 2
    tile = bag_tile(B, F, D, 4, weighted, bag_vec(D, 4))
    if name == "all_pad_bags_at_tile_edges":
        for t in range(0, B, tile.bags):
            ids[t] = ids[min(B, t + tile.bags) - 1] = -1
    w = rng.normal(size=(B, F)).astype(np.float32) if weighted else None
    return table, ids, w, tile


def bag_past_4gib(device):
    """(table, ids) on `device`: a float32 [4500000, 256] table, 4.6 GB,
    zero but for the rows that 64 bags of 9 ids read: most ids among the
    last 400,000 rows (past the first 4 GiB) or past the table, one field
    of each bag among the first 64 rows, and one pad."""
    rng = np.random.default_rng(3)
    V, D = 4_500_000, 256
    ids = rng.integers(V - 400_000, V + 3, (64, 9)).astype(np.int32)
    ids[:, 0] = np.arange(64)
    ids[1, 3] = -1
    rows = np.unique(np.clip(ids, 0, V - 1))
    table = torch.zeros((V, D), dtype=torch.float32, device=device)
    table[torch.from_numpy(rows).to(device)] = torch.from_numpy(
        rng.normal(size=(len(rows), D)).astype(np.float32)).to(device)
    return table, torch.from_numpy(ids).to(device)


def offset_view(x):
    """A copy of `x` on its device that starts 4 bytes past a 16-byte
    boundary, as a view into a larger buffer can (for elements of 1, 2 or
    4 bytes)."""
    k = 4 // x.element_size()
    return torch.cat([x.new_zeros(k), x.reshape(-1)])[k:].view(x.shape)
