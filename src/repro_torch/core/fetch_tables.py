"""Tensorized fetch tables — the plan→device schema of the batched executor.

The planner resolves every posting fetch to an explicit (start, length) slice
(planner.py); the batched executor (core/batch_executor.py) consumes those
plans as fixed-shape integer tables instead of Python loops.  The schema is
the reference package's, column for column, so both packages cut a batch
into the same rows.

Every subplan of every query becomes one or more *rows* (one per doc shard
the seed list touches — the shard-segmented gather), with F fetch slots per
group carrying unions of morphological forms / expanded orientations /
stop-phrase parts / multi-component key lookups (QTYPE_MULTI windowed
near+stop plans: (s, v) pairs ride `pivot_from_dist` + `max_abs`, (s1, s2,
v) triples anchor at the pivot with `max_abs` alone) / long-list splits:

    start/length/offset/req_dist/max_abs : int32 [T, G, F]
    pivot_from_dist                      : bool  [T, G, F]
    score_from_dist                      : bool  [T, G, F] (ranked: slot delta
                                                            = |dist| payload)
    band                                 : int32 [T, G]
    active                               : bool  [T, G]
    doc_task                             : bool  [T]       (doc-level fallback)
    shard_base                           : int32 [T]       (row's first doc)
    score_bias                           : f32   [T]       (ranked: per-task
                                                            n_slots - n_groups)
    ns_packed                            : int16 [T, C, M]
    ns_valid                             : bool  [T, C, M]

Fetch `start`/`length` are POSTING ORDINALS into the unified device arena, a
bit-packed block store (core/postings.PackedPostings).  Postings are grouped
into blocks of 128; ordinal `i` lives in block `i >> 7` at offset `i & 127`.
Per block and per field (doc, pos, dist) the arena holds an int32 *anchor*
(the block minimum) and a *width class* w ∈ {0, 1, 2, 4, 8, 16, 32} bits,
with the 128 deltas bit-packed into `lanes`; one `blk_meta` [NB, 5] row and
one lane word per field are read per posting by kernels/ops.unpack_postings.

The intersect key domain is compact per-shard int32

    key = (doc - shard_base) << TABLE_POS_BITS | (pos - offset + TABLE_BIAS)

DOCS_PER_SHARD bounds the shard size so packed keys stay below 2**30.

Group 0 is always the seed (the pivot / rarest band-0 list, or the
near-stop-checked pivot); groups 1..G-1 constrain it via banded-key
membership (band 0 = precise phrase, band W = word-set window).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.postings import NS_SHIFT
# ranked scoring: constraint keys sort as (key << SCORE_DELTA_BITS | delta)
# int64 composites, so the FIRST entry of an equal-key run carries the run's
# minimum slot delta (|dist| <= near_window <= 15 fits 4 bits); the kernel
# layer owns the layout
from repro_torch.kernels.ops import SCORE_DELTA_BITS  # noqa: F401

TABLE_POS_BITS = 17            # in-doc position < 131072
TABLE_BIAS = 64                # headroom so (pos - offset) never underflows
NO_DIST = np.int32(-128)       # req_dist wildcard (int8 dist can't reach it)
NO_MAX_ABS = np.int32(2**20)   # |dist| cap wildcard (always satisfied)

# doc_local must fit (30 - TABLE_POS_BITS) bits so packed keys stay < 2**30
DOCS_PER_SHARD = 1 << (30 - TABLE_POS_BITS)


def batch_table_specs(T: int, G: int, F: int, C: int, M: int,
                      owner: bool = False) -> dict:
    """{name: (shape, torch dtype)} matching alloc_batch_tables, plus the
    serve tier's per-row `owner` column (the row's dp shard) when asked."""
    i32, b8 = torch.int32, torch.bool
    specs = {
        "start": ((T, G, F), i32),
        "length": ((T, G, F), i32),
        "offset": ((T, G, F), i32),
        "req_dist": ((T, G, F), i32),
        "max_abs": ((T, G, F), i32),
        "pivot_from_dist": ((T, G, F), b8),
        "score_from_dist": ((T, G, F), b8),
        "band": ((T, G), i32),
        "active": ((T, G), b8),
        "doc_task": ((T,), b8),
        "shard_base": ((T,), i32),
        "score_bias": ((T,), torch.float32),
        "ns_packed": ((T, C, M), torch.int16),
        "ns_valid": ((T, C, M), b8),
    }
    if owner:
        specs["owner"] = ((T,), i32)
    return specs


def alloc_batch_tables(T: int, G: int, F: int, C: int, M: int) -> dict:
    """Zero-initialized numpy tables per the batch-executor schema."""
    return {
        "start": np.zeros((T, G, F), np.int32),
        "length": np.zeros((T, G, F), np.int32),
        "offset": np.zeros((T, G, F), np.int32),
        "req_dist": np.full((T, G, F), NO_DIST, np.int32),
        "max_abs": np.full((T, G, F), NO_MAX_ABS, np.int32),
        "pivot_from_dist": np.zeros((T, G, F), bool),
        "score_from_dist": np.zeros((T, G, F), bool),
        "band": np.zeros((T, G), np.int32),
        "active": np.zeros((T, G), bool),
        "doc_task": np.zeros((T,), bool),
        "shard_base": np.zeros((T,), np.int32),
        "score_bias": np.zeros((T,), np.float32),
        "ns_packed": np.full((T, C, M), -1, np.int16),
        "ns_valid": np.zeros((T, C, M), bool),
    }


def pack_ns_checks(tables: dict, ti: int, stop_checks, max_distance: int):
    """Fill ns_packed/ns_valid row `ti` from planner (delta, ids) checks."""
    C, M = tables["ns_packed"].shape[1:]
    for ci, (delta, ids) in enumerate(stop_checks[:C]):
        for mi, sid in enumerate(ids[:M]):
            tables["ns_packed"][ti, ci, mi] = ((delta + max_distance) << NS_SHIFT) | sid
            tables["ns_valid"][ti, ci, mi] = True
