"""Serving front door: deadline-aware micro-batching, admission control,
and graceful degradation over doc-sharded search engines.

The paper's traffic model (arXiv:1801.09079) is heavy concurrent phrase
traffic from millions of users; this module is the path from concurrent
single `SearchRequest`s to the batched engine.  Individual requests are
coalesced into deadline-bounded micro-batches, routed by plan shape (so
one flex-escape straggler cannot drag a whole batch off the batched
path), fanned out over document shards through
`dist.fault_tolerance.ShardDispatcher`, and merged bit-identically to
`engine.search_batch` — or degraded *explicitly* when shards die or
deadlines pass.  Every shard is an `AdditionalIndexEngine` on the card
unless the caller passes `device="cpu"`; the front door itself is host
code (numpy and threads).

Request state machine
---------------------
::

    submit(request, client)
      │
      ├─ client token bucket dry ────────────► SHED   (rate_limited)
      ├─ result cache hit (plan signature) ──► SERVED_EXACT  (cached=True)
      ├─ queue full ─────────────────────────► SHED   (queue_full)
      ▼
    QUEUED ── deadline passed before dispatch ─► SHED (deadline)
      │   dispatcher thread coalesces ≤ max_batch requests within
      │   batch_window_ms, window clipped to the earliest admitted deadline
      ▼
    ROUTED ── per-request shape bucket:
      │         · batched-unranked  ─┐ the batched executor's pow2
      │         · batched-ranked   ─┘ shape buckets
      │         · flex escape (over-cap plans), admitted only while the
      │           remaining deadline slack covers flex_budget_ms
      ▼
    EXECUTE ── ShardDispatcher fan-out (timeout + replica re-dispatch),
      │        then ≤ max_retries bounded re-dispatches of still-missing
      │        shards with exponential backoff
      ├─ every shard contributed, on time ───► SERVED_EXACT  (+ cache fill)
      ├─ partial shards or past deadline ────► SERVED_DEGRADED
      │                                        (`shards` = contributors,
      │                                         shed_reason = shards|late)
      └─ no shard contributed ───────────────► SERVED_DEGRADED (empty,
                                               shed_reason = no_shards)

Every `submit()` returns a ticket whose `result()` resolves with exactly one
of the three statuses — no request is ever silently dropped (the chaos suite
in tests/test_torch_front.py floods, stalls, fails, and clock-skews this
machine to prove it).

Bit-identity across shards
--------------------------
`SERVED_EXACT` responses are bit-identical to `engine.search_batch` on the
unsharded index.  Three mechanisms make that true with doc-sharded backends:

  * every shard plans with CLUSTER-GLOBAL occurrence counts
    (`Planner(occ_counts=...)`), so pivot selection agrees everywhere;
  * ranked seed ordering is plan-order deterministic
    (`order_groups_seed_first(ranked=True)`), so float32 score accumulation
    agrees everywhere despite shard-local posting lengths;
  * the merge reconstructs the *global* fallback decision from per-subplan
    positional-hit counts (`SearchResponse.subplan_pos_hits`): a subplan
    falls back iff it has fallback groups and zero positional keys across
    ALL shards — shard-local fallback verdicts are never trusted.  Postings
    accounting replays the same rule against the front's own global plan,
    so even `postings_read` matches the unsharded engine.

Document ranges partition the corpus, so shard-ascending concatenation of
(doc, pos)-sorted anchors is globally sorted, per-doc score sums live wholly
inside one shard, and per-shard top-k always contains the global top-k.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

import repro_torch.core.batch_executor as bx
from repro_torch.core.api import (STATUS_SERVED_DEGRADED, STATUS_SERVED_EXACT,
                                  STATUS_SHED, SearchRequest, SearchResponse)
from repro_torch.core.builder import IndexSet, build_all
from repro_torch.core.corpus import Corpus
from repro_torch.core.engine import AdditionalIndexEngine
from repro_torch.core.executor import _rank_docs
from repro_torch.core.kword import KW_DEVICE_MAX_WINDOW
from repro_torch.core.planner import Planner, QueryPlan
from repro_torch.dist.fault_tolerance import ShardDispatcher


@dataclasses.dataclass(frozen=True)
class FrontDoorConfig:
    """Admission, batching, and degradation knobs of the front door."""
    max_queue: int = 512           # bounded queue; overflow => SHED
    max_batch: int = 64            # micro-batch size cap
    batch_window_ms: float = 2.0   # coalescing window (clipped to deadlines)
    default_deadline_ms: float = 1000.0   # when request.deadline_ms is None
    cache_capacity: int = 1024     # hot-query result cache entries; 0 = off
    rate_per_s: float = 0.0        # per-client token refill; 0 = unlimited
    rate_burst: int = 64           # per-client bucket depth
    shard_timeout_s: float = 5.0   # ShardDispatcher per-phase timeout
    max_retries: int = 1           # bounded re-dispatch of missing shards
    retry_backoff_ms: float = 20.0  # backoff base (doubles per retry)
    flex_budget_ms: float = 250.0  # min deadline slack to admit a flex plan


class TokenBucket:
    """Per-client rate limiter: `rate` tokens/s, `burst` depth."""

    def __init__(self, rate: float, burst: float, clock: Callable[[], float]):
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self.tokens = float(burst)
        self.last = clock()
        self._lock = threading.Lock()

    def take(self) -> bool:
        with self._lock:
            now = self.clock()
            self.tokens = min(self.burst,
                              self.tokens + (now - self.last) * self.rate)
            self.last = now
            if self.tokens >= 1.0:
                self.tokens -= 1.0
                return True
            return False


@dataclasses.dataclass
class FrontStats:
    """Counters + latency and queue-wait reservoirs; the no-silent-drop
    ledger (submitted == served_exact + served_degraded + shed, always)."""
    submitted: int = 0
    served_exact: int = 0
    served_degraded: int = 0
    shed: int = 0
    cache_hits: int = 0
    stale_cache_hits: int = 0   # pre-invalidation entry served post-bump
                                # (structurally 0: the CI staleness gate)
    backfilled: int = 0         # late-shard results re-merged into the cache
    generation_bumps: int = 0   # segment-manager invalidations observed
    flex_routed: int = 0
    batches: int = 0
    retries: int = 0
    shed_reasons: dict = dataclasses.field(default_factory=dict)
    latencies_ms: list = dataclasses.field(default_factory=list)
    queue_wait_ms: list = dataclasses.field(default_factory=list)
                                # each dispatched ticket's arrival to its
                                # batch's dispatch

    @property
    def responded(self) -> int:
        return self.served_exact + self.served_degraded + self.shed

    @property
    def shed_rate(self) -> float:
        return self.shed / max(self.submitted, 1)

    def percentile(self, p: float) -> float:
        if not self.latencies_ms:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_ms), p))


class _Ticket:
    """One in-flight request: resolves exactly once with a SearchResponse."""

    __slots__ = ("request", "client", "arrival", "deadline", "plan",
                 "response", "_event")

    def __init__(self, request: SearchRequest, client: str, arrival: float,
                 deadline: float):
        self.request = request
        self.client = client
        self.arrival = arrival
        self.deadline = deadline
        self.plan: QueryPlan | None = None
        self.response: SearchResponse | None = None
        self._event = threading.Event()

    def result(self, timeout: float | None = None) -> SearchResponse:
        if not self._event.wait(timeout):
            raise TimeoutError("front door ticket not resolved in time")
        return self.response

    def done(self) -> bool:
        return self._event.is_set()


# ---------------------------------------------------------------------------
# doc-shard backends
# ---------------------------------------------------------------------------


class ShardBackend:
    """One document partition: its own index + engine, answering for docs
    [doc_base, doc_base + index.n_docs).  Callable with a list of
    SearchRequests (the ShardDispatcher contract); responses come back with
    doc ids re-based into the global space.

    `occ_counts` MUST be the cluster-global counts when more than one shard
    exists — see the module docstring's bit-identity contract.  The engine
    runs on the card unless `device="cpu"`."""

    def __init__(self, index: IndexSet, doc_base: int = 0, occ_counts=None,
                 device=None):
        self.doc_base = int(doc_base)
        self.n_docs = index.n_docs
        # doc_base reaches the engine too: its batched rows then sit on the
        # GLOBAL doc-shard grid (same bucket boundaries for every shard /
        # segment of the corpus) — results are identical at any grid
        self.engine = AdditionalIndexEngine(index, device=device,
                                            occ_counts=occ_counts,
                                            doc_base=doc_base)

    def __call__(self, requests: Sequence[SearchRequest]) -> list[SearchResponse]:
        resps = self.engine.search_batch(list(requests))
        if self.doc_base:
            base = np.int32(self.doc_base)
            for r in resps:
                r.doc = r.doc + base
                if r.doc_ids is not None:
                    r.doc_ids = r.doc_ids + base
        return resps


def build_doc_shards(corpus: Corpus, index: IndexSet, n_shards: int,
                     replicate: bool = False, device=None):
    """Split `corpus` into `n_shards` contiguous doc ranges, build a full
    IndexSet per range, and wrap each in a ShardBackend planning with the
    GLOBAL index's occurrence counts.  Returns (backends, replicas) —
    replicas answer for the same ranges (shared per-range index, separate
    engine) or None when `replicate` is False."""
    n_shards = max(1, min(int(n_shards), corpus.n_docs))
    occ = index.base_occ_counts()
    edges = [round(i * corpus.n_docs / n_shards) for i in range(n_shards + 1)]
    backends, replicas = [], [] if replicate else None
    for lo, hi in zip(edges[:-1], edges[1:]):
        offs = corpus.doc_offsets
        sub = Corpus(doc_offsets=(offs[lo:hi + 1] - offs[lo]).copy(),
                     tokens=corpus.tokens[offs[lo]:offs[hi]].copy())
        idx = build_all(sub, index.lexicon, index.analyzer, index.params)
        backends.append(ShardBackend(idx, doc_base=lo, occ_counts=occ,
                                     device=device))
        if replicate:
            replicas.append(ShardBackend(idx, doc_base=lo, occ_counts=occ,
                                         device=device))
    return backends, replicas


# ---------------------------------------------------------------------------
# shard merge (bit-identical to executor.merge_subplan_results)
# ---------------------------------------------------------------------------


def merge_shard_responses(request: SearchRequest, plan: QueryPlan,
                          per_shard: list) -> SearchResponse:
    """Merge one query's per-shard responses (list of (shard_i, resp),
    shard-ascending) into the response the unsharded engine would return.

    Mirrors `merge_subplan_results` exactly: positional hits (anywhere) win
    over doc-only fallback docs; the fallback decision and postings
    accounting replay per-subplan against the GLOBAL plan using the summed
    `subplan_pos_hits`; concatenation in shard order preserves global
    (doc, pos) key order because shards partition contiguous doc ranges."""
    sup = [sp for sp in plan.subplans if sp.supported]
    ranked = request.rank
    top_k = request.top_k
    hits = [0] * len(sup)
    for _i, r in per_shard:
        h = r.subplan_pos_hits
        if len(h) != len(sup):      # shard planned a different structure —
            raise RuntimeError(     # the global-occ-counts contract is broken
                f"shard subplan mismatch: {len(h)} != {len(sup)}")
        for j, n in enumerate(h):
            hits[j] += int(n)
    used_fallback = any(sp.fallback_groups and hits[j] == 0
                        for j, sp in enumerate(sup))
    postings = sum(sp.postings_read for sp in sup)
    postings += sum(sum(g.postings_read for g in sp.fallback_groups)
                    for j, sp in enumerate(sup)
                    if sp.fallback_groups and hits[j] == 0)
    resp = SearchResponse(
        doc=np.empty(0, np.int32), pos=np.empty(0, np.int32),
        postings_read=postings, used_fallback=used_fallback, doc_only=False,
        subplan_types=tuple(sp.qtype for sp in sup), ranked=ranked,
        request=request, subplan_pos_hits=tuple(hits))
    if ranked:
        resp.anchor_scores = np.empty(0, np.float32)
        resp.doc_ids = np.empty(0, np.int32)
        resp.doc_scores = np.empty(0, np.float32)
    if any(hits):
        parts = [r for _i, r in per_shard if len(r.doc) and not r.doc_only]
        if parts:
            resp.doc = np.concatenate([r.doc for r in parts])
            resp.pos = np.concatenate([r.pos for r in parts])
            if ranked:
                resp.anchor_scores = np.concatenate(
                    [r.anchor_scores for r in parts])
                masks = [r.anchor_subplans for r in parts]
                if all(m is not None for m in masks):
                    resp.anchor_subplans = np.concatenate(masks)
                d = np.concatenate([r.doc_ids for r in parts])
                s = np.concatenate([r.doc_scores for r in parts])
                # per-shard top-k always contains the global top-k (each doc
                # is whole within one shard); re-ranking the doc-ascending
                # union reproduces the global _rank_docs order bit-exactly
                order = np.argsort(d, kind="stable")
                resp.doc_ids, resp.doc_scores = _rank_docs(
                    d[order], s[order], top_k)
            elif top_k is not None:
                resp.doc, resp.pos = resp.doc[:top_k], resp.pos[:top_k]
        return resp
    if used_fallback:
        parts = [r for _i, r in per_shard if r.doc_only and len(r.doc)]
        docs = (np.concatenate([r.doc for r in parts]) if parts
                else np.empty(0, np.int32))
        resp.doc = docs.astype(np.int32)
        resp.pos = np.full(len(resp.doc), -1, dtype=np.int32)
        resp.doc_only = True
        if ranked:
            resp.anchor_scores = np.full(
                len(resp.doc), request.ranking.doc_only_score, np.float32)
            resp.doc_ids = resp.doc.copy()
            resp.doc_scores = resp.anchor_scores.copy()
            if top_k is not None:
                resp.doc_ids = resp.doc_ids[:top_k]
                resp.doc_scores = resp.doc_scores[:top_k]
        elif top_k is not None:
            resp.doc, resp.pos = resp.doc[:top_k], resp.pos[:top_k]
    return resp


# ---------------------------------------------------------------------------
# the front door
# ---------------------------------------------------------------------------


class FrontDoor:
    """See the module docstring for the full state machine.

    `backends`/`replicas` default to one ShardBackend over the whole index
    (the bench configuration: single-shard fronts are bit-identical to the
    engine INCLUDING postings accounting).  `clock` is injectable
    (dist.chaos.SkewedClock) for the clock-skew chaos scenario.

    `segments` plugs in a `core.segments.SegmentManager` instead of a fixed
    index: backends and planner come from the manager's live segments, and
    the front subscribes to generation bumps — every ingest/merge
    invalidates the result cache (the stale-cache bugfix) and re-syncs
    backends + cluster-global occ counts before the next micro-batch.

    `device` places the default backend's engine (the card unless
    `device="cpu"`); given `backends` or `segments` carry their own."""

    def __init__(self, index: IndexSet | None = None,
                 backends: Optional[Sequence[ShardBackend]] = None,
                 replicas: Optional[Sequence[ShardBackend]] = None,
                 cfg: FrontDoorConfig = FrontDoorConfig(),
                 clock: Callable[[], float] = time.monotonic,
                 device=None, segments=None):
        self.cfg = cfg
        self.clock = clock
        self.segments = segments
        if segments is not None:
            if not segments.segments:
                raise ValueError(
                    "FrontDoor(segments=...) needs >= 1 ingested segment")
            backends = segments.engine_backends()
            replicas = None       # segment backends re-sync; no replica tier
            self.planner = segments.current_planner()
        else:
            if backends is None:
                backends = [ShardBackend(index, device=device)]
            self.planner = Planner(index)
        self.backends = list(backends)
        self.n_shards = len(self.backends)
        self.dispatcher = ShardDispatcher(
            self.backends, replica_fns=replicas, timeout=cfg.shard_timeout_s)
        self.stats = FrontStats()
        self._stats_lock = threading.Lock()
        self._queue: queue.Queue = queue.Queue(maxsize=cfg.max_queue)
        self._cache: dict = {}
        self._cache_order: list = []    # LRU order, oldest first
        self._cache_lock = threading.Lock()
        self._generation = 0            # bumped by invalidate_cache()
        self._resync = False            # segment set changed: rebuild backends
        self._buckets: dict[str, TokenBucket] = {}
        self._buckets_lock = threading.Lock()
        self._closed = False
        if segments is not None:
            segments.subscribe(self._on_generation)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="front-door")
        self._thread.start()

    # -- public API ---------------------------------------------------------

    def submit(self, request: SearchRequest, client: str = "default") -> _Ticket:
        """Admit (or shed) one request; returns immediately with a ticket."""
        now = self.clock()
        budget = (request.deadline_ms if request.deadline_ms is not None
                  else self.cfg.default_deadline_ms)
        t = _Ticket(request, client, now, now + budget / 1000.0)
        with self._stats_lock:
            self.stats.submitted += 1
        if self.cfg.rate_per_s > 0 and not self._bucket(client).take():
            self._shed(t, "rate_limited")
            return t
        hit = self._cache_get(request)
        if hit is not None:
            hit.latency_ms = (self.clock() - now) * 1000.0
            self._fulfill(t, hit, cache_hit=True)
            return t
        try:
            self._queue.put_nowait(t)
        except queue.Full:
            self._shed(t, "queue_full")
        return t

    def search(self, request: SearchRequest, client: str = "default",
               timeout: float | None = None) -> SearchResponse:
        return self.submit(request, client=client).result(timeout)

    def search_batch(self, requests: Sequence[SearchRequest],
                     client: str = "default",
                     timeout: float | None = None) -> list[SearchResponse]:
        tickets = [self.submit(r, client=client) for r in requests]
        return [t.result(timeout) for t in tickets]

    def close(self):
        """Stop the dispatcher thread; queued requests shed (never dropped)."""
        self._closed = True
        self._thread.join(timeout=30.0)
        while True:
            try:
                t = self._queue.get_nowait()
            except queue.Empty:
                break
            self._shed(t, "shutdown")
        self.dispatcher.close()

    # -- admission helpers --------------------------------------------------

    def _bucket(self, client: str) -> TokenBucket:
        with self._buckets_lock:
            b = self._buckets.get(client)
            if b is None:
                b = TokenBucket(self.cfg.rate_per_s, self.cfg.rate_burst,
                                self.clock)
                self._buckets[client] = b
            return b

    def invalidate_cache(self) -> None:
        """Drop every cached result and advance the cache generation — any
        index change (segment ingest / merge) makes every cached response
        potentially stale.  New entries key on the NEW generation, and
        results computed against the old segment set can no longer land
        (`_cache_put` checks the generation it was planned under)."""
        with self._cache_lock:
            self._generation += 1
            self._cache.clear()
            self._cache_order.clear()

    def _on_generation(self, gen: int) -> None:
        """SegmentManager subscription: invalidate + schedule a backend
        re-sync (picked up by the dispatcher thread before the next batch)."""
        with self._stats_lock:
            self.stats.generation_bumps += 1
        self._resync = True
        self.invalidate_cache()

    def _cache_generation(self) -> int:
        with self._cache_lock:
            return self._generation

    def _cache_get(self, request: SearchRequest) -> SearchResponse | None:
        if self.cfg.cache_capacity <= 0:
            return None
        stale = False
        with self._cache_lock:
            key = (request.plan_signature(), self._generation)
            entry = self._cache.get(key)
            if entry is not None:
                gen, resp = entry
                if gen != self._generation:
                    # structurally unreachable (invalidation clears the dict
                    # and the key embeds the generation) — kept as the
                    # regression tripwire behind stats.stale_cache_hits
                    self._cache.pop(key, None)
                    if key in self._cache_order:
                        self._cache_order.remove(key)
                    entry, stale = None, True
                else:
                    self._cache_order.remove(key)
                    self._cache_order.append(key)
        if stale:
            with self._stats_lock:
                self.stats.stale_cache_hits += 1
        if entry is None:
            return None
        # shallow copy: result arrays are shared (treated immutable), the
        # transport fields are per-delivery; the caller's request (possibly
        # a different deadline — excluded from the key) rides along
        return dataclasses.replace(entry[1], cached=True, request=request)

    def _cache_put(self, request: SearchRequest, resp: SearchResponse,
                   gen: int | None = None):
        """`gen` is the cache generation the response was COMPUTED under
        (captured at dispatch); a bump that landed mid-flight means the
        result may predate the newest segments — skip, never cache it."""
        if self.cfg.cache_capacity <= 0:
            return
        with self._cache_lock:
            if gen is not None and gen != self._generation:
                return
            key = (request.plan_signature(), self._generation)
            if key in self._cache:
                self._cache_order.remove(key)
            elif len(self._cache) >= self.cfg.cache_capacity:
                self._cache.pop(self._cache_order.pop(0), None)
            self._cache[key] = (self._generation, resp)
            self._cache_order.append(key)

    # -- resolution ---------------------------------------------------------

    def _shed(self, t: _Ticket, reason: str):
        resp = SearchResponse(
            doc=np.empty(0, np.int32), pos=np.empty(0, np.int32),
            postings_read=0, used_fallback=False, doc_only=False,
            request=t.request, status=STATUS_SHED, shed_reason=reason,
            latency_ms=(self.clock() - t.arrival) * 1000.0)
        with self._stats_lock:
            self.stats.shed += 1
            self.stats.shed_reasons[reason] = \
                self.stats.shed_reasons.get(reason, 0) + 1
        t.response = resp
        t._event.set()

    def _fulfill(self, t: _Ticket, resp: SearchResponse,
                 cache_hit: bool = False):
        if resp.latency_ms is None:
            resp.latency_ms = (self.clock() - t.arrival) * 1000.0
        with self._stats_lock:
            if resp.status == STATUS_SERVED_EXACT:
                self.stats.served_exact += 1
            else:
                self.stats.served_degraded += 1
            if cache_hit:
                self.stats.cache_hits += 1
            self.stats.latencies_ms.append(resp.latency_ms)
        t.response = resp
        t._event.set()

    # -- dispatcher thread --------------------------------------------------

    def _loop(self):
        while not self._closed:
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            window_end = min(self.clock() + self.cfg.batch_window_ms / 1000.0,
                             first.deadline)
            while len(batch) < self.cfg.max_batch:
                rem = window_end - self.clock()
                if rem <= 0:
                    break
                try:
                    t = self._queue.get(timeout=rem)
                except queue.Empty:
                    break
                batch.append(t)
                window_end = min(window_end, t.deadline)
            try:
                if self._resync:
                    self._sync_segments()
                self._dispatch_batch(batch)
            except Exception:                        # pragma: no cover
                # a dispatcher bug must not silently strand tickets
                for t in batch:
                    if not t.done():
                        self._shed(t, "internal_error")

    def _sync_segments(self):
        """Rebuild backends/planner from the segment manager's current
        generation (dispatcher thread only).  The resync flag clears FIRST
        so a bump landing mid-sync re-triggers.  The old dispatcher is
        closed without waiting: its in-flight late futures may still fire,
        but backfill is generation-guarded so they can never pollute the
        new generation's cache."""
        self._resync = False
        segs = self.segments
        backends = segs.engine_backends()
        planner = segs.current_planner()
        old = self.dispatcher
        self.dispatcher = ShardDispatcher(backends, replica_fns=None,
                                          timeout=self.cfg.shard_timeout_s)
        self.backends = backends
        self.n_shards = len(backends)
        self.planner = planner
        old.close()

    def _is_overflow(self, plan: QueryPlan) -> bool:
        """Routing hint: would this plan escape the batched executor's shape
        caps?  (The shard engines route per-plan themselves — this only
        decides WHICH dispatch bucket the request rides in, so the cheap
        group/fetch-count check suffices.)  The caps are read at call time
        (tests may shrink them)."""
        g_cap, f_cap = bx.G_CAP, bx.F_CAP
        for sp in plan.subplans:
            if not sp.supported:
                continue
            # kword windows wider than the int32 delta masks run flex-side
            if sp.kw_window is not None \
                    and int(sp.kw_window) > KW_DEVICE_MAX_WINDOW:
                return True
            for gs in (sp.groups, sp.fallback_groups):
                if len(gs) > g_cap or any(len(g.fetches) > f_cap for g in gs):
                    return True
        return False

    def _dispatch_batch(self, batch: list):
        now = self.clock()
        with self._stats_lock:
            self.stats.batches += 1
            self.stats.queue_wait_ms.extend((now - t.arrival) * 1000.0
                                            for t in batch)
        buckets: dict[str, list] = {"unranked": [], "ranked": [], "flex": []}
        for t in batch:
            if now > t.deadline:
                self._shed(t, "deadline")
                continue
            r = t.request
            t.plan = self.planner.plan(list(r.surface_ids), mode=r.mode,
                                       window=r.window, ranked=r.rank)
            if self._is_overflow(t.plan):
                # flex escape: the slow path only runs while the deadline
                # slack still covers its per-request time budget
                if (t.deadline - now) * 1000.0 < self.cfg.flex_budget_ms:
                    self._shed(t, "deadline")
                    continue
                with self._stats_lock:
                    self.stats.flex_routed += 1
                buckets["flex"].append(t)
            elif r.rank:
                buckets["ranked"].append(t)
            else:
                buckets["unranked"].append(t)
        # batched shape buckets first; flex stragglers run after, one by
        # one, so they can never hold a batched bucket's responses hostage
        for key in ("unranked", "ranked"):
            if buckets[key]:
                self._execute(buckets[key])
        for t in buckets["flex"]:
            self._execute([t])

    def _execute(self, items: list):
        reqs = [t.request for t in items]
        gen0 = self._cache_generation()
        slot = _BackfillSlot(items, gen0, self.n_shards)
        on_late = None
        if self.cfg.cache_capacity > 0:
            on_late = lambda i, res: self._backfill(slot, i, res)  # noqa: E731
        results = self.dispatcher.dispatch(reqs, on_late=on_late)
        missing = [i for i, r in enumerate(results) if r is None]
        attempt = 0
        while missing and attempt < self.cfg.max_retries:
            time.sleep(self.cfg.retry_backoff_ms / 1000.0 * (2 ** attempt))
            attempt += 1
            with self._stats_lock:
                self.stats.retries += 1
            sub = self.dispatcher.dispatch(reqs, shards=missing,
                                           on_late=on_late)
            for i in missing:
                if sub[i] is not None:
                    results[i] = sub[i]
            missing = [i for i, r in enumerate(results) if r is None]
        live = [i for i, r in enumerate(results) if r is not None]
        # arm (or close) the backfill slot: late-shard results re-merge into
        # the cache only while shards are actually missing
        early = []
        with slot.lock:
            if missing:
                slot.results = list(results)
                early, slot.early = slot.early, []
            else:
                slot.done = True
        for i, res in early:        # stragglers that beat the finalize
            self._backfill(slot, i, res)
        for q_i, t in enumerate(items):
            if not live:
                resp = SearchResponse(
                    doc=np.empty(0, np.int32), pos=np.empty(0, np.int32),
                    postings_read=0, used_fallback=False, doc_only=False,
                    ranked=t.request.rank, request=t.request,
                    status=STATUS_SERVED_DEGRADED, shed_reason="no_shards")
                if t.request.rank:
                    resp.anchor_scores = np.empty(0, np.float32)
                    resp.doc_ids = np.empty(0, np.int32)
                    resp.doc_scores = np.empty(0, np.float32)
                self._fulfill(t, resp)
                continue
            per_shard = [(s, results[s][q_i]) for s in live]
            resp = merge_shard_responses(t.request, t.plan, per_shard)
            resp.shards = tuple(live)
            late = self.clock() > t.deadline
            if len(live) == self.n_shards and not late:
                resp.status = STATUS_SERVED_EXACT
                self._cache_put(t.request, resp, gen=gen0)
            else:
                resp.status = STATUS_SERVED_DEGRADED
                resp.shed_reason = "shards" if len(live) < self.n_shards \
                    else "late"
            self._fulfill(t, resp)

    def _backfill(self, slot: "_BackfillSlot", shard_i: int, res):
        """A shard answered AFTER its dispatch timed out (ShardDispatcher
        `on_late`): fold its per-query responses into the slot.  The
        delivered SERVED_DEGRADED responses stay final — what heals is the
        CACHE: once every shard has contributed, the full merge is cached
        (generation-guarded) so the next identical query is EXACT."""
        with slot.lock:
            if slot.done or slot.results is None:
                if not slot.done:
                    slot.early.append((shard_i, res))
                return
            if slot.results[shard_i] is not None:
                return                        # replica/retry already answered
            slot.results[shard_i] = res
            complete = all(r is not None for r in slot.results)
            results = list(slot.results) if complete else None
            if complete:
                slot.done = True
        with self._stats_lock:
            self.stats.backfilled += 1
        if results is None:
            return
        live = list(range(slot.n_shards))
        for q_i, t in enumerate(slot.items):
            if t.plan is None:                # pragma: no cover
                continue
            resp = merge_shard_responses(t.request, t.plan,
                                         [(s, results[s][q_i]) for s in live])
            resp.shards = tuple(live)
            resp.status = STATUS_SERVED_EXACT
            self._cache_put(t.request, resp, gen=slot.gen)


class _BackfillSlot:
    """Shared state between one `_execute` dispatch and the late-shard
    callbacks it may receive afterwards (see FrontDoor._backfill)."""

    __slots__ = ("lock", "items", "gen", "n_shards", "results", "early",
                 "done")

    def __init__(self, items: list, gen: int, n_shards: int):
        self.lock = threading.Lock()
        self.items = items
        self.gen = gen                 # cache generation at dispatch time
        self.n_shards = n_shards
        self.results = None            # [n_shards] per-shard response lists
        self.early: list = []          # lates that arrived before finalize
        self.done = False
