"""Batched plan-compiled execution: a whole query batch per shape bucket.

The flexible `Executor` (executor.py) walks plans in Python — one device
dispatch per fetch, one host↔device round trip per query.  This module is
the engine's batched path, and it keeps the reference package's tables,
bucket keys and padding, so row cuts and postings accounting are identical.

1. **Tensorize + segment** — every supported subplan of every query becomes
   one or more *rows* of fixed-shape fetch tables (schema in
   core/fetch_tables.py): `start/length/offset/req_dist/max_abs : [T, G, F]`,
   `band/active : [T, G]`, `shard_base : [T]`, near-stop checks `[T, C, M]`.
   Group 0 is the seed (the near-stop-checked pivot when present, else the
   smallest band-0 group); groups 1..G-1 constrain it.  F fetch slots per
   group carry unions over morphological forms / expanded orientations /
   stop-phrase parts / long-list splits.  Posting slices are split host-side
   at doc-shard boundaries, one row per (task, doc shard), so each row
   gathers and intersects only its own shard's postings.

2. **Execute** — one eager `bucket_step_math` per shape bucket on the
   engine's device: gather posting ordinals from the unified packed arena
   (basic | expanded | stop | first | ordinary | multi) → unpack
   (kernels/ops.unpack_postings: the CUDA unpack kernel on the card) →
   global 63-bit keys → per-row int32 re-basing against `shard_base` →
   sort (`torch.sort`) → banded intersection of every constraint group
   (kernels/ops.banded_intersect_rows: the CUDA intersect kernel on the
   card).  Near-stop (type 4) checks mask the seed's keys in the same step.
   Ranked buckets also score every seed anchor: one banded min-(key
   distance + |dist|) pass over (key, delta)-sorted constraint keys
   (ops.banded_min_delta_rows: the CUDA min-delta kernel on the card).
   K-word buckets decide `found` with the K-way span join over per-group
   delta masks and their window scans (ops.banded_delta_mask_rows: one
   launch of the CUDA delta-mask kernel on the card, then
   ops.kword_window_hits).

3. **Merge** — host-side, mirroring `Executor.execute` exactly: row keys are
   unioned per task, task results per query; a subplan with no positional
   hits falls back to its distance-disregarding doc-only task (paper step 3),
   with fallback postings counted only when triggered.

Queries that exceed the table caps (> G_CAP groups, > F_CAP unioned forms,
splits overflowing F_SPLIT_CAP slots, K-word windows wider than
KW_DEVICE_MAX_WINDOW) or an index whose positions overflow the 17-bit
packed domain fall back to the flexible executor per plan — identical
results, just not batched.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.api import SearchRequest, SearchResponse
from repro_torch.core.builder import IndexSet
from repro_torch.core.executor import (SENTINEL, Executor, _next_pow2,
                                       arena_tensors, merge_subplan_results,
                                       order_groups_seed_first, proximity_w)
from repro_torch.core.fetch_tables import (DOCS_PER_SHARD, NO_DIST,
                                           TABLE_POS_BITS, alloc_batch_tables,
                                           pack_ns_checks)
from repro_torch.core.kword import KW_DEVICE_MAX_WINDOW, MODE_KWORD
from repro_torch.core.planner import MODE_PHRASE, QueryPlan
from repro_torch.core.postings import (BLOCK, PHRASE_BIAS, POS_BITS,
                                       concat_packed, pad_block_multiple)
from repro_torch.core.trace import Trace
from repro_torch.kernels.ops import (I32_SENTINEL, SCORE_DELTA_BITS,
                                     SCORE_DELTA_MASK, banded_delta_mask_rows,
                                     banded_intersect_rows,
                                     banded_min_delta_rows, kword_window_hits,
                                     unpack_postings)

# table caps: a task exceeding these routes its whole plan to the flexible
# executor (rare: >8 AND-groups or >8 unioned form fetches per slot).
# Fetches longer than P_CAP are split across extra F slots (up to
# F_SPLIT_CAP per group) by the segmented-gather tensorizer.
G_CAP = 8
F_CAP = 8
F_SPLIT_CAP = 64
P_CAP = 1 << 15
P_FLOOR = 128
GATHER_BUDGET = 1 << 23        # max T*G*F*P elements per bucket step

def ensure_packed_streams(index: IndexSet) -> dict:
    """The six per-stream packed stores, packing any the builder didn't
    (hand-assembled IndexSets in tests).  "multi" is the pairs-then-triples
    concatenation, matching MultiKeyIndex.arena_columns ordinals."""
    from repro_torch.core.builder import _pack_stream
    b, mk = index.basic, index.multi_key
    if index.ordinary_packed is None:
        index.ordinary_packed = _pack_stream(index.ordinary)
    if b.packed_occ is None:
        b.packed_occ = _pack_stream(b.occurrences)
        b.packed_first = _pack_stream(b.first_occ)
    if index.expanded.packed is None:
        index.expanded.packed = _pack_stream(index.expanded.pairs)
    if index.stop_phrase.packed is None:
        index.stop_phrase.packed = _pack_stream(index.stop_phrase.phrases)
    if mk.packed_pairs is None:
        mk.packed_pairs = _pack_stream(mk.pairs)
        mk.packed_triples = _pack_stream(mk.triples)
    return {
        "basic": b.packed_occ,
        "expanded": index.expanded.packed,
        "stop": index.stop_phrase.packed,
        "first": b.packed_first,
        "ordinary": index.ordinary_packed,
        "multi": concat_packed([mk.packed_pairs, mk.packed_triples]),
    }


class BatchDeviceIndex:
    """All six posting streams concatenated into one bit-packed block arena:
    `lanes` (int32 packed deltas) plus the `blk_meta` [NB, 5] per-block
    metadata matrix (base lane word, packed widths, per-field anchors),
    decoded on the device by ops.unpack_postings.  Each stream is padded to
    a BLOCK multiple so stream bases stay block-aligned; the raw
    `arena_*_np` columns are kept host-side only (shard segmentation and
    build stats, and the serve tier's per-dp-shard re-packing) and never
    shipped.  The device copy (`device_arena`) is made at first use: the
    serve tier builds its per-shard arenas from the numpy columns and never
    holds the global arena on the device.

    `docs_per_shard` sets the doc-shard granularity of the segmented gather
    (≤ fetch_tables.DOCS_PER_SHARD so packed int32 keys can't overflow);
    smaller shards only add rows, never change results.

    `doc_base` is the index's first GLOBAL doc id (0 for a standalone
    index).  A segment or doc shard built from a corpus slice
    (core/segments.py, serve/front.py) stores LOCAL doc ids in its arena,
    but its execution rows are laid on the GLOBAL shard grid: row shard ids
    are global, and each row's `shard_base` is the local re-basing origin
    `shard * dps - doc_base` (may be negative), so the rebased int32 keys
    stay in [0, dps) exactly as for an unsegmented index.  Output keys are
    unaffected (still local doc ids); only the row cuts move.
    """

    def __init__(self, index: IndexSet, device,
                 docs_per_shard: int | None = None, doc_base: int = 0):
        packed = ensure_packed_streams(index)
        b = index.basic.occurrences
        e = index.expanded.pairs
        s = index.stop_phrase.phrases
        f = index.basic.first_occ
        m = index.multi_key.arena_columns()
        o = index.ordinary

        docs, poss, dists, reals = [], [], [], []
        self.bases = {}
        off = 0
        for name, doc, pos, dist in (
                ("basic", b.columns["doc"], b.columns["pos"], None),
                ("expanded", e.columns["doc"], e.columns["pos"], e.columns["dist"]),
                ("stop", s.columns["doc"], s.columns["pos"], None),
                ("first", f.columns["doc"], f.columns["pos"], None),
                ("ordinary", o.columns["doc"], o.columns["pos"], None),
                ("multi", m["doc"], m["pos"], m["dist"])):
            self.bases[name] = off
            n_pad = packed[name].n_padded
            assert n_pad >= len(doc)
            off += n_pad
            docs.append(pad_block_multiple(np.asarray(doc, np.int32), n_pad))
            poss.append(pad_block_multiple(np.asarray(pos, np.int32), n_pad))
            dists.append(pad_block_multiple(
                np.asarray(dist, np.int8) if dist is not None
                else np.zeros(len(doc), np.int8), n_pad))
            real = np.zeros(n_pad, bool)
            real[:len(doc)] = True
            reals.append(real)
        self.arena_doc_np = np.concatenate(docs)
        self.arena_pos_np = np.concatenate(poss)
        self.arena_dist_np = np.concatenate(dists)
        # pads (stream tails, and the multi stream's internal pair pad) never
        # enter a serve dp shard's selection
        self.arena_real_np = np.concatenate(reals)
        self.arena_real_np[self.bases["multi"]:
                           self.bases["multi"]
                           + index.multi_key.pair_pad][
            index.multi_key.pairs.n_postings:] = False
        self.packed = concat_packed([packed[n] for n in self.bases])
        self.near_stop_np = np.asarray(index.basic.near_stop, np.int16)
        self.device = torch.device(device)
        self._dev_arena = None
        self.max_distance = int(index.basic.max_distance)
        self.n_docs = int(max((int(d.max()) + 1 for d in docs if len(d)),
                              default=0))
        self.max_pos = int(max((int(p.max()) for p in poss if len(p)),
                               default=0))
        # widest |dist| any pivot_from_dist fetch can add to a position
        # (expanded reach / multi-key NeighborDistance) — part of the
        # 17-bit packed-key safety budget
        self.max_shift = int(np.abs(self.arena_dist_np.astype(np.int32))
                             .max(initial=0))
        if docs_per_shard is None:
            # auto-pick the segmentation grain from posting-list stats:
            # results are identical at any grain
            from repro_torch.core.builder import auto_docs_per_shard
            docs_per_shard = auto_docs_per_shard(self.n_docs,
                                                 index.max_posting_run())
        self.docs_per_shard = max(1, min(docs_per_shard, DOCS_PER_SHARD))
        # global shard grid: shard ids count from GLOBAL doc 0 so every
        # segment of a growing corpus buckets on the same boundaries
        self.doc_base = int(doc_base)
        self.n_shards = max(1, -(-(self.doc_base + self.n_docs)
                                 // self.docs_per_shard))

    @property
    def device_arena(self) -> dict:
        """The packed block arena (`lanes`, `blk_meta`) and the stream-3
        `near_stop` slots as tensors on the device, copied at first use."""
        if self._dev_arena is None:
            self._dev_arena = arena_tensors(self.packed, self.device)
            self._dev_arena["near_stop"] = torch.from_numpy(
                self.near_stop_np).to(self.device)
        return self._dev_arena

    def device_nbytes(self) -> int:
        """Bytes the device arena holds (packed lanes + block metadata +
        stream-3 slots)."""
        return self.packed.nbytes() + self.near_stop_np.nbytes


@dataclasses.dataclass
class _Task:
    """One subplan (or its doc-only fallback): the host-side merge unit."""
    plan_i: int            # which plan in the batch
    subplan_i: int
    fallback: bool         # doc-only fallback task (stream-1)
    stop_checks: tuple     # seed group's near-stop checks
    mode: str = MODE_PHRASE
    ranked: bool = False   # proximity scoring rides the bucket step
    score_bias: float = 0.0   # n_slots - n_groups (see SubPlan.n_slots)
    rows: list = dataclasses.field(default_factory=list)

    def collect_keys(self) -> np.ndarray:
        parts = [r.keys for r in self.rows if r.keys is not None and len(r.keys)]
        return np.concatenate(parts) if parts else np.empty(0, np.int64)

    def collect_scores(self) -> np.ndarray:
        parts = [r.scores for r in self.rows
                 if r.scores is not None and len(r.scores)]
        return np.concatenate(parts) if parts else np.empty(0, np.float32)


@dataclasses.dataclass
class _RowGroup:
    band: int
    slots: list            # [(ResolvedFetch, arena_start, length)] — absolute


@dataclasses.dataclass
class _Row:
    """One (task × doc shard) execution row of the fetch tables."""
    task: _Task
    shard: int             # doc-shard id (0 when unsharded)
    shard_base: int        # first doc of the shard (re-basing origin)
    groups: list           # seed-first ordered _RowGroups, shard-clipped
    sortfree: bool = False  # constraint keys already ascending (see below)
    # filled after execution:
    keys: np.ndarray | None = None
    scores: np.ndarray | None = None   # ranked rows only, aligned with keys


def kword_found(a_rows: torch.Tensor, b_rows: torch.Tensor,
                bands: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """K-way windowed span join of a K-word bucket (core/kword.py): per-group
    signed delta masks and their window start scans, from one delta-mask
    launch, ANDed across groups.  a_rows [T * (G - 1), Pa] int32 (each
    task's seed keys, once per constraint group), b_rows [T * (G - 1), Pb]
    int32 sorted, bands and active [T, G - 1].  Every active constraint
    group of a kword task is banded at the task's window W, so the task's
    W is the max over its group bands (inactive pads are band 0 and never
    constrain).  Returns bool [T, Pa]."""
    T, G1 = bands.shape
    windows = bands.max(dim=1, keepdim=True).values.expand(T, G1)
    _, t_bits = banded_delta_mask_rows(a_rows, b_rows, bands.reshape(-1),
                                       windows.reshape(-1))
    t_bits = t_bits.reshape(T, G1, -1).transpose(0, 1)
    return kword_window_hits(t_bits, active.transpose(0, 1))


def bucket_step_math(arena: dict, t: dict, *, P0: int, P: int,
                     presorted: bool = False, ranked: bool = False,
                     kword: bool = False):
    """One shape bucket of segmented rows: gather posting ordinals → unpack
    (ops.unpack_postings over the bit-packed block arena) → keys → per-row
    int32 rebase against `shard_base` → sort → banded rows intersection.
    The seed (group 0) gets its own pad P0 — the planner seeds with the
    RAREST list, so the membership probe side stays narrow while constraint
    groups pad to P.  `arena` is BatchDeviceIndex.device_arena, `t` the
    bucket's tables as tensors on the same device.  Returns (seed global
    keys [T, F*P0] int64, found [T, F*P0] bool) — plus proximity scores
    [T, F*P0] float32 when `ranked` (api.py: bias + w(seed delta) + the sum
    over constraint groups of w(banded min key distance + stored |dist|
    delta)).  `kword` buckets decide `found` with the K-way span join."""
    T, G, F = t["start"].shape
    near_stop = arena["near_stop"]
    A = arena["blk_meta"].shape[0] * BLOCK
    dt1 = t["doc_task"]
    base = t["shard_base"].long()
    dev = t["start"].device

    def gather(lo: int, hi: int, Pw: int):
        """Posting ordinals, keys and (ranked) per-posting score deltas of
        groups [lo, hi) padded to Pw: [T, g, F, Pw]."""
        start, length = t["start"][:, lo:hi], t["length"][:, lo:hi]
        offset, req = t["offset"][:, lo:hi], t["req_dist"][:, lo:hi]
        maxab, pfd = t["max_abs"][:, lo:hi], t["pivot_from_dist"][:, lo:hi]
        iota = torch.arange(Pw, dtype=torch.int32, device=dev)
        # the reference's gathers clamp; clamp explicitly (pads are masked)
        idx = (start[..., None] + iota).clamp(0, A - 1)
        valid = iota < length[..., None]
        doc, pos, dist = unpack_postings(arena, idx)
        valid &= (req[..., None] == int(NO_DIST)) | (dist == req[..., None])
        valid &= dist.abs() <= maxab[..., None]
        valid &= t["active"][:, lo:hi, None, None]
        # global 63-bit keys (identical to the flexible executor's packing)
        pos_eff = pos + torch.where(pfd[..., None], dist, 0)
        low = pos_eff.long() - offset[..., None] + PHRASE_BIAS
        doc64 = doc.long()
        gk = torch.where(dt1[:, None, None, None], doc64,
                         (doc64 << POS_BITS) | low)
        delta = None
        if ranked:
            sfd = t["score_from_dist"][:, lo:hi]
            delta = torch.where(sfd[..., None], dist.abs(), 0)
        return idx, torch.where(valid, gk, SENTINEL), delta

    idx0, gk0, delta0 = gather(0, 1, P0)
    gk0 = gk0[:, 0]                                            # [T, F, P0]

    # near-stop verification on the seed group (type-4 pivot checks)
    C = t["ns_packed"].shape[1]
    if C > 0:
        nb = near_stop.shape[0]
        ns = near_stop[idx0[:, 0].clamp(0, nb - 1).long()]     # [T, F, P0, K]
        ok = torch.ones((T, F, P0), dtype=torch.bool, device=dev)
        Mns = t["ns_packed"].shape[2]
        for c in range(C):
            hit_c = torch.zeros((T, F, P0), dtype=torch.bool, device=dev)
            for m in range(Mns):
                tgt = t["ns_packed"][:, c, m][:, None, None, None]
                val = t["ns_valid"][:, c, m][:, None, None]
                hit_c |= (ns == tgt).any(dim=-1) & val
            has_check = t["ns_valid"][:, c].any(dim=-1)[:, None, None]
            ok &= hit_c | ~has_check
        gk0 = torch.where(ok, gk0, SENTINEL)

    m26 = (1 << POS_BITS) - 1

    def rebase(gk, dt_b, b):
        """Row-local int32 re-basing (doc-only keys ARE doc ids: globally
        comparable in int32, no re-basing needed)."""
        dglob = torch.where(dt_b, gk, gk >> POS_BITS)
        k32 = torch.where(dt_b, gk, ((dglob - b) << TABLE_POS_BITS) | (gk & m26))
        return torch.where(gk < SENTINEL, k32, I32_SENTINEL).to(torch.int32)

    a64 = gk0.reshape(T, F * P0)
    a32 = rebase(gk0, dt1[:, None, None], base[:, None, None]).reshape(T, F * P0)
    found = torch.ones((T, F * P0), dtype=torch.bool, device=dev)
    if ranked:
        # proximity scores in the reference's accumulation order: per-task
        # bias, the seed's own delta, then each constraint group seed-first
        score = t["score_bias"][:, None] \
            + proximity_w(delta0[:, 0].reshape(T, F * P0))
    if G == 1:
        # no constraint group (the reference's `G > 1` guard): every valid
        # seed key is a hit
        found &= a32 != I32_SENTINEL
        return (a64, found, torch.where(found, score, 0.0)) if ranked \
            else (a64, found)
    _, gkc, deltac = gather(1, G, P)                           # [T, G-1, F, P]
    b32 = rebase(gkc, dt1[:, None, None, None],
                 base[:, None, None, None]).reshape(T, G - 1, F * P)
    bands = t["band"][:, 1:]                                   # [T, G-1]
    active_c = t["active"][:, 1:]
    a_rows = a32[:, None].expand(T, G - 1, F * P0).reshape(T * (G - 1), F * P0)

    if ranked:
        # Constraint keys sort as (key, delta) composites (pads 1 << 40 sort
        # last and never fall inside a band of a real key < 2**30), split
        # back into key and delta planes for one min-delta pass per bucket.
        dl = deltac.reshape(T, G - 1, F * P)
        pad = 1 << 40
        comp = torch.sort(torch.where(
            b32 == I32_SENTINEL, pad,
            (b32.long() << SCORE_DELTA_BITS) | dl.long()), dim=-1).values
        bk = torch.where(comp >= pad, I32_SENTINEL,
                         comp >> SCORE_DELTA_BITS).to(torch.int32)
        bd = (comp & SCORE_DELTA_MASK).to(torch.int32)
        delta_g = banded_min_delta_rows(
            a_rows, bk.reshape(T * (G - 1), F * P),
            bd.reshape(T * (G - 1), F * P),
            bands.reshape(-1)).reshape(T, G - 1, F * P0)
        for gi in range(G - 1):
            hit_g = delta_g[:, gi] < I32_SENTINEL
            live = hit_g & active_c[:, gi, None]
            score = score + torch.where(live, proximity_w(delta_g[:, gi]), 0.0)
            found &= hit_g | ~active_c[:, gi, None]
        if kword:
            # found is the span join; a span match implies an in-band hit
            # for every group, so the score above is exact for every
            # survivor (and zeroed below for the rest)
            found = kword_found(
                a_rows, torch.sort(b32, dim=-1).values.reshape(
                    T * (G - 1), F * P), bands, active_c)
        found &= a32 != I32_SENTINEL
        return a64, found, torch.where(found, score, 0.0)
    if not presorted:
        b32 = torch.sort(b32, dim=-1).values
    if kword:
        found = kword_found(a_rows, b32.reshape(T * (G - 1), F * P), bands,
                            active_c)
    else:
        hit = banded_intersect_rows(a_rows, b32.reshape(T * (G - 1), F * P),
                                    bands.reshape(-1))
        found = (hit.reshape(T, G - 1, F * P0) | ~active_c[:, :, None]).all(dim=1)
    return a64, found & (a32 != I32_SENTINEL)


class BatchExecutor:
    """Executes a batch of QueryPlans with result parity vs. the flexible
    `Executor` (same doc/pos sets, same postings accounting, same fallback
    semantics), in O(#shape-buckets) device steps instead of
    O(#queries * #groups) — and O(arena) gather/sort work total regardless
    of the doc-shard count (segmented rows).

    `trace` (core/trace.py) holds the path's spans and counters:
    `timings` accumulates host seconds per span (plan, rows, tensorize,
    merge, flex and the spans nested in and between them; `batch` and
    `plan` are added by `search_batch`) and `counts` the batches, rows,
    buckets, steps, copies and flexible plans; callers reset them as they
    like.  `timings["device"]` is host seconds from a step's first launch
    until its results are on the host, `launch` + `d2h`, not device
    time."""

    def __init__(self, index: IndexSet, device, flex: Executor | None = None,
                 docs_per_shard: int | None = None, doc_base: int = 0):
        self.index = index
        self.device = torch.device(device)
        self.dev = BatchDeviceIndex(index, self.device,
                                    docs_per_shard=docs_per_shard,
                                    doc_base=doc_base)
        self.flex = flex or Executor(index, self.device)
        self.trace = Trace()
        self.timings = self.trace.seconds
        self.counts = self.trace.counts
        # packed-key safety: positions (plus bias, the widest dist shift,
        # and the widest band) must fit the 17-bit in-doc field or
        # cross-doc false positives appear
        self._pos_budget = (1 << TABLE_POS_BITS) - PHRASE_BIAS \
            - self.dev.max_pos - max(self.dev.max_distance,
                                     self.dev.max_shift)

    # -- tensorization ------------------------------------------------------

    def _caps(self):
        """(g_cap, f_cap, split_cap, p0_cap, p_cap): the module globals,
        read at call time so that tests can shrink them; the serve executor
        returns its fixed table limits (p0_cap the seed pad, p_cap the
        constraint pad)."""
        return G_CAP, F_CAP, F_SPLIT_CAP, P_CAP, P_CAP

    def _task_fits(self, groups, kword: bool = False) -> bool:
        g_cap, f_cap, _, _, _ = self._caps()
        if len(groups) > g_cap:
            return False
        for g in groups:
            if len(g.fetches) > f_cap:
                return False
            if int(g.band) > self._pos_budget:
                return False
            # kword delta masks are int32 bitfields over d in [-W, W]: wider
            # windows ride the flexible escape path (int64 masks, W <= 31)
            if kword and int(g.band) > KW_DEVICE_MAX_WINDOW:
                return False
            for f in g.fetches:
                if f.stream == "first" and not _is_first_group(g):
                    return False
        return True

    def _build_rows(self, task: _Task, ordered) -> list | None:
        """Segment a task at doc-shard boundaries: one row per shard the
        SEED group touches, every fetch clipped to the shard's sub-slice
        (the arena is doc-sorted per fetch, so a shard's rows are one
        `searchsorted` away).  Fetches longer than the seed's p0_cap or a
        constraint's p_cap split across extra F slots of the same group
        (slot unions).  None => plan goes flex."""
        d = self.dev
        dps = d.docs_per_shard
        base = d.doc_base
        _, _, split_cap, p0_cap, p_cap = self._caps()
        p0_cap, p_cap = max(1, p0_cap), max(1, p_cap)
        # arena doc ids are LOCAL; shard ids live on the GLOBAL grid
        sh_lo = base // dps
        sh_hi = (base + max(d.n_docs - 1, 0)) // dps
        if sh_lo == sh_hi:                        # one shard
            per_group = [{sh_lo: [(f, d.bases[f.stream] + f.start, f.length)
                                  for f in g.fetches]} for g in ordered]
            seed_shards = [sh_lo]
        else:
            per_group = []
            for g in ordered:
                m: dict = {}
                for f in g.fetches:
                    s0 = d.bases[f.stream] + f.start
                    arr = d.arena_doc_np[s0:s0 + f.length]
                    lo = (int(arr[0]) + base) // dps
                    hi = (int(arr[-1]) + base) // dps
                    if lo == hi:
                        m.setdefault(lo, []).append((f, s0, f.length))
                        continue
                    cuts = np.searchsorted(
                        arr, np.arange(lo + 1, hi + 1) * dps - base)
                    edges = np.concatenate(([0], cuts, [f.length]))
                    for i in range(len(edges) - 1):
                        ln = int(edges[i + 1] - edges[i])
                        if ln:
                            m.setdefault(lo + i, []).append(
                                (f, s0 + int(edges[i]), ln))
                per_group.append(m)
            seed_shards = sorted(per_group[0])
        rows = []
        for sh in seed_shards:
            groups, sortfree = [], True
            for gi in range(len(ordered)):
                cap = p0_cap if gi == 0 else p_cap
                slots = []
                for f, s, ln in per_group[gi].get(sh, ()):
                    while ln > cap:
                        slots.append((f, s, cap))
                        s += cap
                        ln -= cap
                    slots.append((f, s, ln))
                if len(slots) > split_cap:
                    return None
                if gi > 0:
                    # sort-free: a single unsplit slot gathers ascending keys
                    # (the arena is (doc, pos)-sorted per fetch and the key
                    # packings are monotone); dist/pivot masks punch holes
                    # mid-row and multi-slot unions interleave — both break
                    # order.  Trailing pads sort last, so they are harmless.
                    if len(slots) > 1:
                        sortfree = False
                    for f, _, _ in slots:
                        if (f.required_dist is not None
                                or f.max_abs_dist is not None
                                or f.pivot_from_dist):
                            sortfree = False
                groups.append(_RowGroup(band=int(ordered[gi].band), slots=slots))
            rows.append(_Row(task=task, shard=sh,
                             shard_base=sh * dps - base,  # local origin
                             groups=groups, sortfree=sortfree))
        return rows

    def _build_tasks(self, plan_i: int, plan: QueryPlan, tasks: list,
                     ranked: bool = False) -> bool:
        """Append tasks (with segmented rows) for one plan; False => route
        plan to the flexible executor (table caps exceeded).  Ranked main
        tasks seed with the first band-0 group in plan order (see
        order_groups_seed_first) and carry their score bias."""
        if self._pos_budget <= 0:
            return False
        out = []
        for sp_i, sp in enumerate(plan.subplans):
            if not sp.supported:
                continue
            main_dead = (not sp.groups) or any(not g.fetches for g in sp.groups)
            if not main_dead:
                ordered = order_groups_seed_first(sp.groups, ranked=ranked)
                if ordered is None or not self._task_fits(
                        ordered, kword=sp.mode == MODE_KWORD):
                    return False
                checks = ordered[0].fetches[0].stop_checks
                if any(f.stop_checks != checks for f in ordered[0].fetches) or \
                   any(f.stop_checks for g in ordered[1:] for f in g.fetches):
                    return False
                task = _Task(plan_i, sp_i, False, checks, mode=sp.mode,
                             ranked=ranked,
                             score_bias=float(sp.n_slots - len(sp.groups)))
                task.rows = self._build_rows(task, ordered)
                if task.rows is None:
                    return False
                out.append(task)
            if sp.fallback_groups:
                fb_dead = any(not g.fetches for g in sp.fallback_groups)
                if not fb_dead:
                    ordered = order_groups_seed_first(sp.fallback_groups)
                    if ordered is None or not self._task_fits(ordered):
                        return False
                    # fallback tasks are validated eagerly (the flex-routing
                    # decision must not depend on results) but executed
                    # lazily: only when the main task comes back empty
                    task = _Task(plan_i, sp_i, True, (), mode=MODE_PHRASE)
                    task.rows = self._build_rows(task, ordered)
                    if task.rows is None:
                        return False
                    out.append(task)
        tasks.extend(out)
        return True

    def _bucket_key(self, row: _Row):
        G = max(2, _next_pow2(len(row.groups), floor=2))
        F = _next_pow2(max(len(g.slots) for g in row.groups), floor=1)
        P0 = _next_pow2(max((ln for _, _, ln in row.groups[0].slots),
                            default=1), floor=P_FLOOR)
        P = _next_pow2(max((ln for g in row.groups[1:] for _, _, ln in g.slots),
                           default=1), floor=P_FLOOR)
        # near-stop slots are padded to coarse buckets (invalid slots are
        # inert) so check-count variation doesn't multiply bucket shapes
        checks = row.task.stop_checks
        if checks:
            C = _next_pow2(len(checks), floor=4)
            M = _next_pow2(max(len(ids) for _, ids in checks), floor=2)
        else:
            C = M = 0
        # only big slabs are worth a separate sort-free bucket; for small P
        # the sort is cheap and splitting buckets costs more steps (ranked
        # rows always sort: scoring needs the composite order)
        sortfree = row.sortfree and P >= 2048 and not row.task.ranked
        return (G, F, P0, P, C, M, sortfree, row.task.ranked,
                row.task.mode == MODE_KWORD)

    def _tensorize_bucket(self, rows: list, G: int, F: int, C: int, M: int,
                          T_pad: int) -> dict:
        t = alloc_batch_tables(T_pad, G, F, C, M)
        for ti, row in enumerate(rows):
            task = row.task
            t["doc_task"][ti] = task.fallback
            t["shard_base"][ti] = row.shard_base
            t["score_bias"][ti] = task.score_bias
            if task.stop_checks:
                pack_ns_checks(t, ti, task.stop_checks, self.dev.max_distance)
            for gi, g in enumerate(row.groups):
                t["band"][ti, gi] = g.band
                t["active"][ti, gi] = True
                for fi, (f, s, ln) in enumerate(g.slots):
                    t["start"][ti, gi, fi] = s
                    t["length"][ti, gi, fi] = ln
                    # mirror Executor._fetch_keys key selection
                    if f.stream == "first":
                        continue                        # doc key: no offset
                    phrase_keyed = (
                        f.stream == "stop"
                        or (f.stream == "expanded" and f.required_dist is not None)
                        or (f.stream in ("basic", "ordinary")
                            and task.mode == MODE_PHRASE))
                    if phrase_keyed:
                        t["offset"][ti, gi, fi] = f.offset
                    if f.required_dist is not None:
                        t["req_dist"][ti, gi, fi] = f.required_dist
                    if f.max_abs_dist is not None:
                        t["max_abs"][ti, gi, fi] = f.max_abs_dist
                    t["pivot_from_dist"][ti, gi, fi] = bool(f.pivot_from_dist)
                    t["score_from_dist"][ti, gi, fi] = \
                        bool(f.score_delta_from_dist)
        return t

    # -- execution ----------------------------------------------------------

    @staticmethod
    def _scatter_row_keys(part: list, a64: np.ndarray, found: np.ndarray,
                          scores: np.ndarray | None = None):
        """Assign each row its found seed keys (and scores, when ranked) —
        one pass over the hit mask instead of T boolean-indexings."""
        hit_rows, cols = np.nonzero(found)
        keys = a64[hit_rows, cols]
        splits = np.searchsorted(hit_rows, np.arange(1, len(part)))
        for ti, row_keys in enumerate(np.split(keys, splits)):
            part[ti].keys = row_keys
        if scores is not None:
            svals = scores[hit_rows, cols].astype(np.float32)
            for ti, row_scores in enumerate(np.split(svals, splits)):
                part[ti].scores = row_scores

    def _to_device(self, t: dict, ranked: bool) -> dict:
        """A chunk's tables on the device, counted.  The score columns are
        read only by ranked steps: they stay off the copies of unranked
        ones."""
        with self.trace.span("h2d"):
            tt = {k: torch.from_numpy(v).to(self.device)
                  for k, v in t.items()
                  if ranked or k not in ("score_bias", "score_from_dist")}
        c = self.counts
        c["h2d_copies"] += len(tt)
        c["h2d_bytes"] += sum(t[k].nbytes for k in tt)
        return tt

    def _finish_step(self, part: list, launch):
        """One step of a chunk whose tables are on the device: `launch()`
        enqueues it, its results come back to the host, and each row of
        `part` takes its keys."""
        tr, c = self.trace, self.counts
        with tr.span("device"):
            with tr.span("launch"):
                out = launch()
            with tr.span("d2h"):
                out = [x.cpu().numpy() for x in out]
        c["steps"] += 1
        c["d2h_copies"] += len(out)
        c["d2h_bytes"] += sum(x.nbytes for x in out)
        with tr.span("scatter"):
            self._scatter_row_keys(part, *out)

    def _run_rows(self, rows: list):
        tr = self.trace
        with tr.span("bucket"):
            buckets: dict = {}
            for row in rows:
                buckets.setdefault(self._bucket_key(row), []).append(row)
        self.counts["buckets"] += len(buckets)
        d = self.dev
        for (G, F, P0, P, C, M, sortfree, ranked, kword), rs in buckets.items():
            per_task = F * P0 + (G - 1) * F * P
            if C > 0:                  # near-stop gather adds an [F, P0, K] slab
                per_task += F * P0 * int(d.near_stop_np.shape[1])
            chunk = max(1, GATHER_BUDGET // per_task)
            for lo in range(0, len(rs), chunk):
                part = rs[lo:lo + chunk]
                with tr.span("tensorize"):
                    # tight T padding: big-P buckets usually hold 1-4 rows
                    T_pad = _next_pow2(len(part), floor=4)
                    t = self._tensorize_bucket(part, G, F, C, M, T_pad)
                    tt = self._to_device(t, ranked)
                self._finish_step(part, lambda: bucket_step_math(
                    d.device_arena, tt, P0=P0, P=P, presorted=sortfree,
                    ranked=ranked, kword=kword))

    # -- merge (mirrors Executor.execute) -----------------------------------

    def _merge_plan(self, plan: QueryPlan, task_map: dict,
                    request: SearchRequest) -> SearchResponse:
        all_keys, all_scores, doc_only_keys = [], [], []
        postings = 0
        used_fallback = False
        types = []
        for sp_i, sp in enumerate(plan.subplans):
            if not sp.supported:
                continue
            types.append(sp.qtype)
            postings += sp.postings_read
            main = task_map.get((sp_i, False))
            keys = main.collect_keys() if main is not None else np.empty(0, np.int64)
            scores = (main.collect_scores() if request.rank and main is not None
                      else np.empty(0, np.float32))
            if len(keys) == 0 and sp.fallback_groups:
                used_fallback = True
                postings += sum(g.postings_read for g in sp.fallback_groups)
                fb = task_map.get((sp_i, True))
                dkeys = fb.collect_keys() if fb is not None else np.empty(0, np.int64)
                doc_only_keys.append(dkeys)
                keys, scores = keys[:0], scores[:0]
            all_keys.append(keys)
            all_scores.append(scores)
        return merge_subplan_results(all_keys, doc_only_keys, postings,
                                     used_fallback, tuple(types), request,
                                     all_scores=all_scores)

    # -- public API ---------------------------------------------------------

    def execute_batch(self, plans: list[QueryPlan],
                      requests: list[SearchRequest]) -> list[SearchResponse]:
        """Requests align 1:1 with plans and carry ranking / top_k; plans
        stay the executor's input so escape routing and table building see
        resolved fetches only."""
        tr, c = self.trace, self.counts
        tasks: list[_Task] = []
        flex_plans: dict[int, QueryPlan] = {}
        plan_tasks: dict[int, list] = {}
        with tr.span("rows"):
            for i, plan in enumerate(plans):
                start = len(tasks)
                if self._build_tasks(i, plan, tasks, ranked=requests[i].rank):
                    plan_tasks[i] = tasks[start:]
                else:
                    flex_plans[i] = plan
        c["flex_plans"] += len(flex_plans)
        # round 1: main rows; round 2: only the fallback rows whose main
        # result came back empty (mirrors the flexible executor, which never
        # touches stream 1 when the positional search hits)
        main = [r for t in tasks if not t.fallback for r in t.rows]
        self._run_rows(main)
        with tr.span("collect"):
            main_keys = {(t.plan_i, t.subplan_i): t.collect_keys()
                         for t in tasks if not t.fallback}
            fallback = [r for t in tasks if t.fallback
                        and len(main_keys.get((t.plan_i, t.subplan_i),
                                              np.empty(0))) == 0
                        for r in t.rows]
        self._run_rows(fallback)
        c["rows"] += len(main) + len(fallback)
        c["fallback_rows"] += len(fallback)
        out: list[SearchResponse | None] = [None] * len(plans)
        for i, plan in enumerate(plans):
            if i in flex_plans:
                with tr.span("flex"):
                    out[i] = self.flex.execute(plan, request=requests[i])
            else:
                with tr.span("merge"):
                    task_map = {(t.subplan_i, t.fallback): t
                                for t in plan_tasks[i]}
                    out[i] = self._merge_plan(plan, task_map, requests[i])
        return out


def _is_first_group(g) -> bool:
    return all(f.stream == "first" for f in g.fetches)
