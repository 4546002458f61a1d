"""Batched phrase-query serving over a document-partitioned index.

This tier runs the same execution engine as the in-process engines: plans
are tensorized into the batch executor's row tables (core/fetch_tables.py,
core/batch_executor.py) — full subplan unions, all lemma forms, doc-only
fallbacks, near-stop checks — and executed by the same `bucket_step_math`,
so serve results are bit-identical to `engine.search_batch`.

Layout: documents are partitioned contiguously over the mesh's `data` ranks
(launch/mesh.py).  Each rank holds only its own dp shard of the posting
arena (all six streams concatenated so a fetch is one gather), re-packed
into its own bit-packed block store, plus the matching near-stop rows.
Host-side tensorization is shard-segmented: each execution row targets
exactly one doc shard, so a row's fetches lie wholly inside one dp shard's
arena, and the row carries an `owner` column.  Every rank tensorizes the
whole batch, executes only its own rows (the others are masked inactive)
and the per-row results — each produced on exactly one rank — are combined
by one `all_reduce(MIN)` of the int64 keys over the dp group (and, for
ranked rows, one `all_reduce(MAX)` of the scores).  The `model` coordinate
replicates the arena to scale query throughput.

On one rank with no process group the merge is the identity and is
skipped; once a group is initialised the collective always runs.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.api import SearchRequest, SearchResponse
from repro_torch.core.batch_executor import (P_FLOOR, BatchExecutor,
                                             bucket_step_math)
from repro_torch.core.builder import IndexSet
from repro_torch.core.executor import SENTINEL, _next_pow2
from repro_torch.core.fetch_tables import batch_table_specs
from repro_torch.core.kword import MODE_KWORD
from repro_torch.core.planner import MODE_PHRASE, Planner, QueryPlan
from repro_torch.core.postings import BLOCK, PackedPostings

__all__ = ["SearchServeConfig", "SearchServe", "arena_specs",
           "query_table_specs", "make_search_serve_step"]


@dataclasses.dataclass(frozen=True)
class SearchServeConfig:
    name: str = "veretennikov-serve"
    # groups/fetch_slots/postings_pad/seed_pad are CAPS: they size the
    # dry-run shapes and bound tensorization, but live steps run through a
    # <= 3-tier (G, F, P0, P) ladder derived from the first batch's rows
    # (plus pow2-tight T)
    queries: int = 64              # query batch size (sizing hint for rows)
    rows: int = 0                  # T cap: execution rows per step; 0 = 2*queries
    groups: int = 8                # G cap: fetch groups per row (seed + G-1)
    fetch_slots: int = 8           # F cap: union slots per group (forms + splits)
    postings_pad: int = 32768      # P cap: padded postings per constraint slot
    seed_pad: int = 0              # P0: seed slot pad; 0 = postings_pad (the
                                   # planner seeds with the RAREST list)
    check_slots: int = 4           # C: near-stop checks on the pivot group
    check_forms: int = 2           # M: stop forms per near-stop check
    ns_k: int = 20                 # stream-3 slots per posting
    # per-shard arena sizes (basic|expanded|stop|first|multi segments
    # concatenated), in POSTINGS: the packed block store's block count, and
    # its lane-word budget from `lane_words`
    n_basic: int = 10_000_000
    n_expanded: int = 17_000_000
    n_stop: int = 23_000_000
    n_first: int = 4_000_000
    n_multi: int = 12_000_000      # multi-component key postings (pairs+triples)
    lane_words: int = 0            # int32 words of packed deltas per shard;
                                   # 0 = n_arena (~32 bits a posting)
    ranked: bool = False           # dry-run shapes: the proximity-scored step
                                   # variant (serving builds both as ranked
                                   # requests arrive)

    @property
    def n_arena(self) -> int:
        return (self.n_basic + self.n_expanded + self.n_stop + self.n_first
                + self.n_multi)

    @property
    def n_blocks(self) -> int:
        """Packed blocks per shard (BLOCK postings each)."""
        return max(1, -(-self.n_arena // BLOCK))

    @property
    def n_lane_words(self) -> int:
        return self.lane_words or self.n_arena

    @property
    def p_seed(self) -> int:
        return self.seed_pad or self.postings_pad

    @property
    def task_rows(self) -> int:
        return self.rows or 2 * self.queries


def arena_specs(cfg: SearchServeConfig, n_shards: int) -> dict:
    """{name: (shape, torch dtype)} of the stacked per-shard arenas (dp
    shard first; a rank holds its own row): the packed block store (lanes
    and per-block base / width / anchor metadata, core/postings.py) plus
    the raw stream-3 near-stop slots."""
    return {
        "lanes": ((n_shards, cfg.n_lane_words), torch.int32),
        "blk_meta": ((n_shards, cfg.n_blocks, 5), torch.int32),
        "basic_ns": ((n_shards, cfg.n_basic, cfg.ns_k), torch.int16),
    }


def query_table_specs(cfg: SearchServeConfig) -> dict:
    """{name: (shape, torch dtype)} of one serve row batch (the same on
    every rank): the batch-executor schema plus the per-row `owner`."""
    return batch_table_specs(cfg.task_rows, cfg.groups, cfg.fetch_slots,
                             cfg.check_slots, cfg.check_forms, owner=True)


# ---------------------------------------------------------------------------
# the serve step: bucket math on this rank's rows + one all_reduce merge
# ---------------------------------------------------------------------------


def make_search_serve_step(cfg: SearchServeConfig, mesh,
                           ranked: bool | None = None,
                           p_seed: int | None = None,
                           postings_pad: int | None = None,
                           kword: bool = False):
    """Returns step(arena, tables) -> (keys [T, F*P0] int64, found bool),
    plus proximity scores [T, F*P0] float32 when `ranked` (default
    cfg.ranked), computed by the same bucket math as the engine's and
    merged right after the keys.

    `arena`: this rank's shard, keyed as `arena_specs` without the leading
    dp dim (`lanes`, `blk_meta`, `basic_ns`), on `mesh.device`; `tables`:
    `query_table_specs` tensors on the same device, alike on every rank,
    each row's fetch starts local to its owner's arena.  Rows this rank
    does not own are masked inactive; keys become SENTINEL and scores -1.0
    where this rank does not own the hit, then `all_reduce` MIN / MAX over
    `mesh.dp_group` keeps the owner's value (every row has one owner).
    Outputs are alike on every rank.  `step.collectives` counts the
    all_reduce calls made."""
    if ranked is None:
        ranked = cfg.ranked
    # cfg gives the CAP pads (the dry-run shapes); the serve executor's tier
    # ladder asks for tighter variants
    P0 = p_seed or cfg.p_seed
    Pc = postings_pad or cfg.postings_pad

    def merge(x, op):
        if mesh.distributed:
            dist.all_reduce(x, op=op, group=mesh.dp_group)
            step.collectives += 1
        return x

    def step(arena: dict, tables: dict):
        own = (tables["owner"] == mesh.dp_rank)[:, None]
        t = {k: v for k, v in tables.items() if k != "owner"}
        t["active"] = tables["active"] & own
        out = bucket_step_math(
            {"lanes": arena["lanes"], "blk_meta": arena["blk_meta"],
             "near_stop": arena["basic_ns"]}, t,
            P0=P0, P=Pc, ranked=ranked, kword=kword)
        mine = out[1] & own
        a64 = merge(torch.where(mine, out[0], SENTINEL), dist.ReduceOp.MIN)
        if not ranked:
            return a64, a64 < SENTINEL
        scores = merge(torch.where(mine, out[2], -1.0), dist.ReduceOp.MAX)
        hit = a64 < SENTINEL
        return a64, hit, torch.where(hit, scores, 0.0)

    step.collectives = 0
    return step


# ---------------------------------------------------------------------------
# host side: doc-partitioned arenas + the serve batch executor
# ---------------------------------------------------------------------------


class _ServeBatchExecutor(BatchExecutor):
    """BatchExecutor whose rows execute through the serve step.

    Inherits tensorization (seed ordering, shard segmentation, long-list
    splitting), flex-escape routing and the merge, and overrides the caps
    (fixed table limits from cfg) and `_run_rows` (tiered chunks through the
    serve step, fetch starts remapped into each owner shard's arena).
    `timings` and `counts` keep the base executor's spans and counters
    (`timings["device"]` is host seconds from a step's launch until its
    results are on the host, `launch` + `d2h`, not device time);
    `slab_stats` counts steps and the live share of their rows and
    elements."""

    def __init__(self, index: IndexSet, cfg: SearchServeConfig, mesh,
                 docs_per_shard: int | None = None):
        self.cfg = cfg
        self.mesh = mesh
        self.n_dp = mesh.dp_size
        super().__init__(index, mesh.device, docs_per_shard=docs_per_shard)
        # re-grain the segmentation so every doc shard nests inside one dp
        # shard (a row never straddles two ranks' arenas)
        d = self.dev
        dps = min(d.docs_per_shard, max(1, -(-d.n_docs // self.n_dp)))
        d.docs_per_shard = dps
        d.n_shards = max(1, -(-d.n_docs // dps))
        self.shards_per_dp = max(1, -(-d.n_shards // self.n_dp))
        self.docs_per_dp = dps * self.shards_per_dp
        self._build_dp_arenas()
        self._tiers: list | None = None
        self.slab_stats = {"steps": 0, "slab_rows": 0, "live_rows": 0,
                           "slab_elems": 0, "live_elems": 0}
        self._steps: dict = {}

    @property
    def collectives(self) -> int:
        """all_reduce calls made by this executor's serve steps."""
        return sum(s.collectives for s in self._steps.values())

    def _step_for(self, ranked: bool, p_seed: int, postings_pad: int,
                  kword: bool = False):
        key = (ranked, kword, p_seed, postings_pad)
        if key not in self._steps:
            self._steps[key] = make_search_serve_step(
                self.cfg, self.mesh, ranked=ranked, p_seed=p_seed,
                postings_pad=postings_pad, kword=kword)
        return self._steps[key]

    # -- tier-ladder persistence (warm restarts) ----------------------------

    def dump_tiers(self, path) -> bool:
        """Write the learned (G, F, P0, P) tier ladder to `path` (JSON), so
        a fresh executor can start from it instead of its first batch.
        False before the ladder exists."""
        if self._tiers is None:
            return False
        with open(path, "w") as fh:
            json.dump({"tiers": [list(t) for t in self._tiers]}, fh)
        return True

    def load_tiers(self, path) -> bool:
        """Adopt a dumped tier ladder: shapes clipped to this config's caps
        (the caps stay the emergency tier), junk entries dropped, deduped
        and sorted by volume — a stale file can cost padding, never
        correctness."""
        if not os.path.exists(path):
            return False
        with open(path) as fh:
            state = json.load(fh)
        cfg = self.cfg
        cap = (cfg.groups, cfg.fetch_slots, cfg.p_seed, cfg.postings_pad)
        tiers = []
        for t in state.get("tiers", ()):
            if len(t) != 4 or any(int(x) < 1 for x in t):
                continue
            t = tuple(min(int(x), c) for x, c in zip(t, cap))
            if t not in tiers:
                tiers.append(t)
        if not tiers:
            return False
        self._tiers = sorted(tiers, key=self._tier_volume)
        return True

    def _build_dp_arenas(self):
        """Bucket the global arena by owning dp shard on the host: shard d
        keeps exactly the real postings of docs [d*docs_per_dp,
        (d+1)*docs_per_dp), in global order, so every stream stays a
        contiguous local segment and a global fetch slice maps to one local
        slice.  Every rank keeps every shard's selection (the start remap);
        it re-packs only its own into a block store and puts only that, and
        its near-stop rows, on its device."""
        d = self.dev
        own = d.arena_doc_np // self.docs_per_dp
        self._sel = [np.nonzero(d.arena_real_np & (own == dd))[0]
                     for dd in range(self.n_dp)]
        sel = self._sel[self.mesh.dp_rank]
        p = PackedPostings.from_columns(
            {"doc": d.arena_doc_np[sel], "pos": d.arena_pos_np[sel],
             "dist": d.arena_dist_np[sel]}, fields=("doc", "pos", "dist"))
        # the basic stream leads the arena: its selected postings are the
        # local arena's first nb rows, which the near-stop slots follow
        nb = int(np.searchsorted(sel, d.near_stop_np.shape[0]))
        ns = np.full((max(nb, 1), d.near_stop_np.shape[1]), -1, np.int16)
        ns[:nb] = d.near_stop_np[sel[:nb]]
        dev = self.device
        self.arenas = {
            "lanes": torch.from_numpy(p.lanes).to(dev),
            "blk_meta": torch.from_numpy(p.meta_matrix()).to(dev),
            "basic_ns": torch.from_numpy(ns).to(dev),
        }

    def arena_nbytes(self) -> int:
        """Bytes of this rank's arena on its device."""
        return sum(t.numel() * t.element_size() for t in self.arenas.values())

    def _caps(self):
        cfg = self.cfg
        return (cfg.groups, cfg.fetch_slots, cfg.fetch_slots,
                cfg.p_seed, cfg.postings_pad)

    def _task_fits(self, groups, kword: bool = False) -> bool:
        if not super()._task_fits(groups, kword=kword):
            return False
        # fixed near-stop slots: checks that do not fit cannot be dropped
        # (that would loosen type-4 verification), so the plan goes flex
        cfg = self.cfg
        for g in groups:
            for f in g.fetches:
                if len(f.stop_checks) > cfg.check_slots:
                    return False
                if any(len(ids) > cfg.check_forms for _, ids in f.stop_checks):
                    return False
        return True

    def _run_rows(self, rows: list):
        # ranked / unranked and K-word / pairwise rows run through separate
        # step variants (scoring and the span join are other programs)
        for ranked in (False, True):
            for kword in (False, True):
                self._run_rows_variant(
                    [r for r in rows if r.task.ranked == ranked
                     and (r.task.mode == MODE_KWORD) == kword],
                    ranked, kword)

    def _row_shape(self, row) -> tuple:
        """Pow2-padded (G, F, P0, P) the row needs, clipped to the cfg caps
        (tensorization already keeps the raw needs inside them)."""
        cfg = self.cfg
        G = max(2, _next_pow2(len(row.groups), floor=2))
        F = _next_pow2(max(len(g.slots) for g in row.groups), floor=1)
        P0 = _next_pow2(max((ln for _, _, ln in row.groups[0].slots),
                            default=1), floor=P_FLOOR)
        Pc = _next_pow2(max((ln for g in row.groups[1:] for _, _, ln in g.slots),
                            default=1), floor=P_FLOOR)
        return (min(G, cfg.groups), min(F, cfg.fetch_slots),
                min(P0, cfg.p_seed), min(Pc, cfg.postings_pad))

    @staticmethod
    def _tier_volume(s: tuple) -> int:
        G, F, P0, Pc = s
        return F * P0 + (G - 1) * F * Pc

    def _tier_ladder(self, rows: list) -> list:
        """<= 3 nested (G, F, P0, P) tiers from the first batch's rows:
        shapes sorted by volume, the elementwise max over each tertile, a
        running max keeping the ladder monotone.  The cfg caps stay the
        emergency tier for later rows that outgrow the ladder."""
        if self._tiers is None:
            shapes = sorted((self._row_shape(r) for r in rows),
                            key=self._tier_volume)
            n = len(shapes)
            tiers, prev = [], (0, 0, 0, 0)
            for third in (shapes[:max(n // 3, 1)],
                          shapes[max(n // 3, 1):max(2 * n // 3, 1)],
                          shapes[max(2 * n // 3, 1):]):
                if not third:
                    continue
                t = tuple(max(prev[i], max(s[i] for s in third))
                          for i in range(4))
                prev = t
                if t not in tiers:
                    tiers.append(t)
            self._tiers = tiers
        return self._tiers

    def _run_rows_variant(self, rows: list, ranked: bool, kword: bool):
        if not rows:
            return
        cfg = self.cfg
        cap = (cfg.groups, cfg.fetch_slots, cfg.p_seed, cfg.postings_pad)
        tr = self.trace
        with tr.span("bucket"):
            tiers = self._tier_ladder(rows)
            assign: dict = {}
            for row in rows:
                need = self._row_shape(row)
                tier = next((t for t in tiers
                             if all(a <= b for a, b in zip(need, t))), cap)
                assign.setdefault(tier, []).append(row)
        self.counts["buckets"] += len(assign)
        for (G, F, P0, Pc), rs in assign.items():
            step = self._step_for(ranked, P0, Pc, kword)
            for lo in range(0, len(rs), cfg.task_rows):
                part = rs[lo:lo + cfg.task_rows]
                with tr.span("tensorize"):
                    tt = self._serve_tables(part, G, F, P0, Pc, ranked)
                self._finish_step(part, lambda: step(self.arenas, tt))

    def _serve_tables(self, part: list, G: int, F: int, P0: int, Pc: int,
                      ranked: bool) -> dict:
        """A chunk's serve tables on the device: the base tables at the
        tier's shape, fetch starts remapped into each owner shard's arena,
        the owner column; counted in `slab_stats`."""
        cfg = self.cfg
        # tight T: pow2 chunks instead of the full task_rows slab
        T = min(cfg.task_rows, _next_pow2(len(part), floor=4))
        t = self._tensorize_bucket(part, G, F, cfg.check_slots,
                                   cfg.check_forms, T)
        owner = np.zeros(T, np.int32)
        owner[:len(part)] = [row.shard // self.shards_per_dp
                             for row in part]
        # global fetch starts -> each owner shard's local arena: one
        # searchsorted per dp shard touched
        live = t["length"] > 0
        for dd in np.unique(owner[:len(part)]):
            m = (owner == dd)[:, None, None] & live
            t["start"][m] = np.searchsorted(self._sel[dd],
                                            t["start"][m])
        t["owner"] = owner
        st = self.slab_stats
        st["steps"] += 1
        st["slab_rows"] += T
        st["live_rows"] += len(part)
        st["slab_elems"] += T * self._tier_volume((G, F, P0, Pc))
        st["live_elems"] += sum(
            ln for row in part for g in row.groups
            for _, _, ln in g.slots)
        return self._to_device(t, ranked)


class SearchServe:
    """Serving facade: SearchRequests -> plans -> serve tables -> serve
    step on every dp rank -> merged SearchResponses, bit-identical to
    `engine.search_batch`, ranked top-k included.  Plans that exceed the
    fixed table shapes run through the flexible executor (the engine's
    escape path).  `mesh` is a `launch.mesh.make_host_mesh`; every rank of
    its dp group calls `search_batch` with the same requests."""

    def __init__(self, index: IndexSet, cfg: SearchServeConfig, mesh,
                 docs_per_shard: int | None = None, occ_counts=None):
        self.index = index
        self.cfg = cfg
        self.mesh = mesh
        # occ_counts: cluster-wide occurrence statistics when this tier
        # holds one doc shard / segment of a larger corpus (see Planner)
        self.planner = Planner(index, occ_counts=occ_counts)
        self.executor = _ServeBatchExecutor(index, cfg, mesh,
                                            docs_per_shard=docs_per_shard)

    @property
    def n_dp(self) -> int:
        return self.executor.n_dp

    def refresh_occ_counts(self, occ_counts=None):
        """Re-snapshot planner pivot statistics (see
        Planner.refresh_occ_counts)."""
        self.planner.refresh_occ_counts(occ_counts)

    def plan_request(self, request: SearchRequest) -> QueryPlan:
        return self.planner.plan(list(request.surface_ids),
                                 mode=request.mode, window=request.window,
                                 ranked=request.rank)

    def plan(self, surface_ids, mode: str = MODE_PHRASE,
             window: int | None = None, ranked: bool = False) -> QueryPlan:
        """Host-side plan introspection (not a search entry point)."""
        return self.planner.plan(list(surface_ids), mode=mode, window=window,
                                 ranked=ranked)

    def execute_batch(self, plans, requests) -> list[SearchResponse]:
        return self.executor.execute_batch(plans, requests=requests)

    def search(self, request: SearchRequest) -> SearchResponse:
        return self.search_batch([request])[0]

    def search_batch(self, requests) -> list[SearchResponse]:
        """A batch of SearchRequests through the serve step."""
        requests = list(requests)
        ex = self.executor
        tr = ex.trace
        with tr.span("batch", batch=ex.counts["batches"],
                     requests=len(requests)):
            ex.counts["batches"] += 1
            with tr.span("plan"):
                for r in requests:
                    if not isinstance(r, SearchRequest):
                        raise TypeError(
                            f"expected a SearchRequest, got {type(r)}")
                plans = [self.plan_request(r) for r in requests]
            return self.execute_batch(plans, requests)
