"""Incremental ingestion: immutable LSM-style index segments + background merge.

The builder (builder.py) is one-shot: adding a single document rebuilds every
stream (basic, expanded, stop-phrase, multi-key pairs/triples, packed twins).
This module makes the corpus GROWABLE while serving: documents arrive in
batches, each batch becomes a small immutable segment (its own `IndexSet` +
packed arenas over a contiguous doc-id range), and a background merger
re-packs accumulated small segments into one large segment.  Search unions
results across live segments through the exact machinery the doc-sharded
front door already uses (`serve.front.merge_shard_responses`) — segments ARE
doc shards from the executor's point of view: contiguous doc ranges whose
per-(task, shard) rows ride the global shard grid (`BatchDeviceIndex`'s
`doc_base`), so `bucket_step_math` is untouched.  Index builds are host
code (numpy); each segment's engine runs on the card unless the manager
was made with `device="cpu"`.

Segment state machine
---------------------
::

    ingest(batch)                       merger picks sources
      │                                   │
      ▼                                   ▼
    FRESH ──────────────────────────► MERGING ──── build_all(concat) ok ──► RETIRED
      ▲                                   │                                (dropped from
      └────── merge failed (crash /      │                                 the live list;
              injected fault): revert ◄──┘                                 generation++)
              to FRESH, generation
              UNCHANGED, serving
              continues on the old
              segment set

    Every transition that changes the LIVE segment set bumps `generation`
    (monotonically increasing) and notifies subscribers — the front door's
    cache-invalidation + occ-refresh hook.  A failed merge changes nothing
    observable: the sources revert to FRESH, `merge_failures` increments,
    and queries keep unioning the old segments (chaos-tested in
    tests/test_torch_segments.py).

Determinism
-----------
A merge rebuilds the merged segment with `builder.build_all` over the
concatenation of the source corpora — the same pure-numpy stream
construction, chunk by chunk, the one-shot build runs — so a fully merged
manager holds an index BIT-IDENTICAL to the one-shot build of the same
corpus: same stream contents, same packed blocks, same postings accounting.
Before full merge, multi-segment unions return identical doc/pos/score
results (doc ranges partition the corpus; shard-ascending concatenation is
the proven front-door merge), while `postings_read` accounting follows the
plan the union was EXECUTED with — pass `plan_index=` (e.g. the one-shot
index) to `search_batch` to replay accounting against a reference plan, the
same mechanism `serve.front` uses for its global plan.

Pivot invariance: every segment engine plans with CLUSTER-GLOBAL occurrence
counts (additive across segments: `occ_counts()` sums
`index.base_occ_counts()` over live segments), refreshed on every generation
bump — the `Planner.refresh_occ_counts` bugfix this module forced.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.core.builder import IndexParams, IndexSet, build_all
from repro_torch.core.corpus import Corpus
from repro_torch.core.planner import Planner

SEG_FRESH = "fresh"
SEG_MERGING = "merging"
SEG_RETIRED = "retired"


# ---------------------------------------------------------------------------
# corpus slicing helpers
# ---------------------------------------------------------------------------


def concat_corpora(parts: list[Corpus]) -> Corpus:
    """Concatenate doc-range corpora (doc ids renumber contiguously)."""
    parts = [p for p in parts if p.n_docs]
    if not parts:
        return Corpus(doc_offsets=np.zeros(1, np.int64),
                      tokens=np.empty(0, np.int32))
    offs = [np.asarray(parts[0].doc_offsets, np.int64)]
    base = int(parts[0].doc_offsets[-1])
    for p in parts[1:]:
        offs.append(np.asarray(p.doc_offsets[1:], np.int64) + base)
        base += int(p.doc_offsets[-1])
    return Corpus(doc_offsets=np.concatenate(offs),
                  tokens=np.concatenate([p.tokens for p in parts]))


def corpus_batches(corpus: Corpus, k: int) -> list[Corpus]:
    """Split a corpus into k contiguous doc-range batches (ingest feed;
    `concat_corpora(corpus_batches(c, k))` round-trips bit-exactly)."""
    k = max(1, min(int(k), corpus.n_docs)) if corpus.n_docs else 1
    offs = corpus.doc_offsets
    edges = [round(i * corpus.n_docs / k) for i in range(k + 1)]
    return [Corpus(doc_offsets=(offs[lo:hi + 1] - offs[lo]).copy(),
                   tokens=corpus.tokens[offs[lo]:offs[hi]].copy())
            for lo, hi in zip(edges[:-1], edges[1:])]


# ---------------------------------------------------------------------------
# segments
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IndexSegment:
    """One immutable index over docs [doc_base, doc_base + n_docs).

    The corpus slice is retained: it is the merge input (merges REBUILD from
    text for bit-identity with the one-shot build, see module docstring) —
    the in-memory analogue of the stored fields every real engine keeps."""
    seg_id: int
    doc_base: int
    corpus: Corpus
    index: IndexSet
    state: str = SEG_FRESH

    @property
    def n_docs(self) -> int:
        return self.corpus.n_docs


class SegmentManager:
    """Mutable-corpus facade over immutable segments: `ingest()` appends doc
    batches as fresh segments, a background merger compacts them, and
    `search_batch()` serves the union — identical doc/pos/score results to
    the one-shot build at every generation (see module docstring).

    Thread safety: the segment list only ever changes under `_lock` and
    readers take an O(1) snapshot; segments themselves are immutable, so an
    in-flight search over a pre-merge snapshot stays valid after the swap
    (retired segments are dropped from the live list, not mutated).

    `device` places every segment engine (the card unless `device="cpu"`)."""

    def __init__(self, lexicon, analyzer, params: IndexParams | None = None,
                 *, merge_threshold: int = 4, auto_merge: bool = True,
                 device=None):
        self.lexicon = lexicon
        self.analyzer = analyzer
        self.params = params if params is not None else IndexParams()
        self.merge_threshold = max(2, int(merge_threshold))
        self.device = device
        self._lock = threading.RLock()
        self._segments: list[IndexSegment] = []
        self._retired: list[IndexSegment] = []
        self._generation = 0
        self._next_seg_id = 0
        self._listeners: list = []
        self._backends: dict = {}        # seg_id -> serve.front.ShardBackend
        self._backends_gen = -1
        self._occ = None                 # cached global occ (per generation)
        self._planner = None             # cached union planner (per generation)
        self._planner_gen = -1
        self.merge_failures = 0
        self.merges_completed = 0
        # test hook: callable invoked at the top of every merge attempt —
        # raise to simulate a merger crash, sleep to widen the merge window
        self.merge_fault = None
        self._wake = threading.Event()
        self._closed = False
        self._merger = None
        if auto_merge:
            self._merger = threading.Thread(target=self._merge_loop,
                                            daemon=True,
                                            name="segment-merger")
            self._merger.start()

    # -- introspection -------------------------------------------------------

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    @property
    def segments(self) -> list[IndexSegment]:
        """Snapshot of the live segment list (doc_base ascending)."""
        with self._lock:
            return list(self._segments)

    @property
    def retired_segments(self) -> list[IndexSegment]:
        with self._lock:
            return list(self._retired)

    @property
    def n_docs(self) -> int:
        with self._lock:
            return sum(s.n_docs for s in self._segments)

    def occ_counts(self) -> np.ndarray:
        """Cluster-global occurrence counts: the elementwise sum of every
        live segment's `base_occ_counts()` (occurrences are additive over a
        doc partition) — what every segment planner pivots on."""
        with self._lock:
            return self._occ_locked().copy()

    def subscribe(self, fn) -> None:
        """`fn(generation)` is called after every generation bump (ingest or
        completed merge), outside the manager lock."""
        with self._lock:
            self._listeners.append(fn)

    # -- ingest --------------------------------------------------------------

    def ingest(self, batch: Corpus) -> int:
        """Index one document batch as a fresh segment; returns the new
        generation.  Doc ids continue from the current corpus end."""
        if batch.n_docs == 0:
            return self.generation
        index = build_all(batch, self.lexicon, self.analyzer, self.params)
        with self._lock:
            seg = IndexSegment(seg_id=self._next_seg_id,
                               doc_base=sum(s.n_docs for s in self._segments),
                               corpus=batch, index=index)
            self._next_seg_id += 1
            self._segments.append(seg)
            gen = self._bump_locked()
        self._notify(gen)
        self._wake.set()
        return gen

    # -- merge ---------------------------------------------------------------

    def merge_now(self) -> bool:
        """Synchronously merge ALL fresh segments into one (True when a merge
        ran and succeeded; False when <2 fresh segments, a merge is already
        in flight, or the merge failed — `merge_failures` tells which)."""
        return self._merge_once(min_sources=2)

    def _merge_once(self, min_sources: int) -> bool:
        with self._lock:
            if any(s.state == SEG_MERGING for s in self._segments):
                return False                  # one merge at a time
            srcs = [s for s in self._segments if s.state == SEG_FRESH]
            if len(srcs) < min_sources:
                return False
            for s in srcs:
                s.state = SEG_MERGING
        try:
            if self.merge_fault is not None:
                self.merge_fault()
            corpus = concat_corpora([s.corpus for s in srcs])
            index = build_all(corpus, self.lexicon, self.analyzer, self.params)
        except Exception:
            # crash containment: revert the sources, keep serving the old
            # generation — nothing observable changed, no results dropped
            with self._lock:
                for s in srcs:
                    s.state = SEG_FRESH
                self.merge_failures += 1
            return False
        with self._lock:
            merged = IndexSegment(seg_id=self._next_seg_id,
                                  doc_base=srcs[0].doc_base,
                                  corpus=corpus, index=index)
            self._next_seg_id += 1
            for s in srcs:
                s.state = SEG_RETIRED
            self._retired.extend(srcs)
            # segments ingested DURING the merge sit after the sources with
            # already-consistent doc bases: splice [merged] + tail
            self._segments = [merged] + [s for s in self._segments
                                         if s not in srcs]
            self.merges_completed += 1
            gen = self._bump_locked()
        self._notify(gen)
        return True

    def _merge_loop(self):
        while not self._closed:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            if self._closed:
                return
            try:
                while not self._closed \
                        and self._merge_once(min_sources=self.merge_threshold):
                    pass
            except Exception:                  # pragma: no cover
                pass                           # a merger bug must not die spinning

    def close(self):
        self._closed = True
        self._wake.set()
        if self._merger is not None:
            self._merger.join(timeout=30.0)

    # -- generation plumbing -------------------------------------------------

    def _bump_locked(self) -> int:
        self._generation += 1
        self._occ = None                       # occ is additive: re-sum lazily
        return self._generation

    def _notify(self, gen: int):
        for fn in list(self._listeners):
            try:
                fn(gen)
            except Exception:                  # pragma: no cover
                pass                           # listeners must not break ingest

    def _occ_locked(self) -> np.ndarray:
        if not self._segments:
            raise RuntimeError("SegmentManager has no segments — ingest first")
        if self._occ is None:
            occ = self._segments[0].index.base_occ_counts().astype(np.int64)
            for s in self._segments[1:]:
                occ = occ + s.index.base_occ_counts()
            self._occ = occ
        return self._occ

    # -- search --------------------------------------------------------------

    def current_planner(self) -> Planner:
        """A planner for the CURRENT generation: plans against the largest
        live segment's streams with cluster-global occ counts.  Plan
        STRUCTURE (tier splits, subplan count, pivot slots) is
        segment-invariant under the global-occ contract; resolved fetch
        lengths are that segment's — pass the result to
        `merge_shard_responses` as the union's accounting plan."""
        with self._lock:
            if self._planner_gen != self._generation:
                seg = max(self._segments, key=lambda s: s.n_docs)
                self._planner = Planner(seg.index,
                                        occ_counts=self._occ_locked())
                self._planner_gen = self._generation
            return self._planner

    def engine_backends(self) -> list:
        """One `serve.front.ShardBackend` per live segment (doc_base
        ascending), planning with cluster-global occ counts — directly
        pluggable into `FrontDoor(backends=...)` / `ShardDispatcher`.
        Backends are cached per segment and their occ snapshots refreshed on
        every generation bump; retired segments' backends are dropped."""
        from repro_torch.serve.front import ShardBackend
        with self._lock:
            segs = list(self._segments)
            occ = self._occ_locked()
            live = {s.seg_id for s in segs}
            for sid in [sid for sid in self._backends if sid not in live]:
                del self._backends[sid]
            out = []
            for s in segs:
                b = self._backends.get(s.seg_id)
                if b is None:
                    b = ShardBackend(s.index, doc_base=s.doc_base,
                                     occ_counts=occ, device=self.device)
                    self._backends[s.seg_id] = b
                out.append(b)
            if self._backends_gen != self._generation:
                for b in self._backends.values():
                    b.engine.refresh_occ_counts(occ)
                self._backends_gen = self._generation
            return out

    def serve_backends(self, cfg, mesh) -> list:
        """One `SearchServe`-backed segment backend per live segment — the
        distributed serve tier unioned across segments exactly like the
        engine path (built fresh per call; serve tables are heavyweight).
        `mesh` (launch.mesh.make_host_mesh) places them."""
        from repro_torch.serve.search_serve import SearchServe
        with self._lock:
            segs = list(self._segments)
            occ = self._occ_locked()
        return [SegmentServeBackend(
            SearchServe(s.index, cfg, mesh, occ_counts=occ), s.doc_base)
            for s in segs]

    def search_batch(self, requests, backends=None, plan_index=None) -> list:
        """Union search across live segments: every segment answers every
        request (global-occ planning), responses merge shard-style.

        `plan_index` picks the index the ACCOUNTING plan is computed
        against (default: the largest live segment via `current_planner`) —
        pass the one-shot index to replay `postings_read` against it, the
        front-door mechanism for exact accounting parity.  `backends`
        overrides the engine backends (e.g. `serve_backends(...)`)."""
        from repro_torch.serve.front import merge_shard_responses
        requests = list(requests)
        if backends is None:
            backends = self.engine_backends()
        if plan_index is None:
            planner = self.current_planner()
        else:
            planner = Planner(plan_index, occ_counts=self.occ_counts())
        plans = [planner.plan(list(r.surface_ids), mode=r.mode,
                              window=r.window, ranked=r.rank)
                 for r in requests]
        per_backend = [b(requests) for b in backends]
        out = []
        for qi, (r, plan) in enumerate(zip(requests, plans)):
            per_shard = [(si, per_backend[si][qi])
                         for si in range(len(backends))]
            out.append(merge_shard_responses(r, plan, per_shard))
        return out


class SegmentServeBackend:
    """Callable shard-backend adapter over one segment's `SearchServe`:
    answers for docs [doc_base, doc_base + n_docs), re-based globally."""

    def __init__(self, serve, doc_base: int):
        self.serve = serve
        self.doc_base = int(doc_base)

    def __call__(self, requests) -> list:
        resps = self.serve.search_batch(list(requests))
        if self.doc_base:
            base = np.int32(self.doc_base)
            for r in resps:
                r.doc = r.doc + base
                if r.doc_ids is not None:
                    r.doc_ids = r.doc_ids + base
        return resps
