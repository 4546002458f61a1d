"""Engine facades behind the typed request/response API (core/api.py).

`AdditionalIndexEngine` — the paper's system: planner (Type 1-4 dispatch over
the stop-phrase / expanded / 3-stream basic indexes, plus the multi-component
key plans) + the PyTorch executors.

`OrdinaryEngine` — the comparison baseline (the paper benchmarks Sphinx
2.0.6): a single inverted index over every basic form, stop words included;
every query reads the *full* posting list of every query word.

Both consume `SearchRequest`s (`search` / `search_batch`) and return
`SearchResponse`s.  They run on the card unless the caller asks for the CPU
(`device="cpu"`, as the tests do); on the card the batched path launches the
CUDA unpack and banded-intersect kernels.  This slice answers unranked
phrase and near requests; ranked and K-word requests raise
`NotImplementedError`.

`brute_force_search` — O(corpus) numpy oracle used by tests and by
chip_smoke.py to verify that indexed phrases are found exactly (paper:
"Since phrases are selected from an already-indexed document, they should
be precisely found").
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.api import SearchRequest, SearchResponse
from repro_torch.core.batch_executor import BatchExecutor
from repro_torch.core.builder import IndexSet
from repro_torch.core.corpus import Corpus
from repro_torch.core.executor import Executor, require_ported, resolve_device
from repro_torch.core.kword import MODE_KWORD
from repro_torch.core.planner import (FetchGroup, MODE_NEAR, MODE_PHRASE,
                                      Planner, QueryPlan, ResolvedFetch,
                                      SubPlan)


class _BatchSearchMixin:
    """Shared lazy batch-executor plumbing: the batched arena duplicates the
    posting streams on the device, so per-query-only users never pay for
    it."""

    def _init_executors(self, index: IndexSet, device, docs_per_shard):
        self.index = index
        self.device = resolve_device(device)
        self.executor = Executor(index, self.device)
        self._docs_per_shard = docs_per_shard
        self._batch_executor = None

    @property
    def batch_executor(self) -> BatchExecutor:
        if self._batch_executor is None:
            self._batch_executor = BatchExecutor(
                self.index, self.device, flex=self.executor,
                docs_per_shard=self._docs_per_shard)
        return self._batch_executor

    def _plan(self, request: SearchRequest) -> QueryPlan:
        if not isinstance(request, SearchRequest):
            raise TypeError(f"expected a SearchRequest, got {type(request)}")
        require_ported(request)
        return self.plan_request(request)

    def search(self, request: SearchRequest) -> SearchResponse:
        """One query through the flexible per-query executor."""
        return self.executor.execute(self._plan(request), request=request)

    def search_batch(self, requests) -> list[SearchResponse]:
        """Batched search: a sequence of SearchRequests through the
        plan-compiled batched executor — same results as per-query
        `search`, one device step per shape bucket."""
        requests = list(requests)
        t0 = time.perf_counter()
        plans = [self._plan(r) for r in requests]
        ex = self.batch_executor
        ex.timings["plan"] += time.perf_counter() - t0
        return ex.execute_batch(plans, requests=requests)


class AdditionalIndexEngine(_BatchSearchMixin):
    """The paper's engine: additional indexes + Type 1-4 query processing.

    `search(SearchRequest)` runs one query through the flexible executor;
    `search_batch([SearchRequest, ...])` runs a whole batch through the
    batched executor (identical results — see batch_executor.py).
    `device=None` means the card; pass `device="cpu"` to run on the CPU.
    """

    def __init__(self, index: IndexSet, device=None,
                 docs_per_shard: int | None = None):
        self.planner = Planner(index)
        self._init_executors(index, device, docs_per_shard)

    def plan_request(self, request: SearchRequest) -> QueryPlan:
        return self.planner.plan(list(request.surface_ids),
                                 mode=request.mode, window=request.window)


class OrdinaryEngine(_BatchSearchMixin):
    """Sphinx-style baseline: one inverted index, full posting-list reads."""

    def __init__(self, index: IndexSet, device=None,
                 docs_per_shard: int | None = None):
        self._init_executors(index, device, docs_per_shard)
        self._counts = index.ordinary.counts()

    def _slot_group(self, slot, forms, band) -> FetchGroup:
        fetches = []
        for f in forms:
            s, e = self.index.ordinary.find(f)
            if e > s:
                fetches.append(ResolvedFetch(stream="ordinary", start=s,
                                             length=e - s, offset=slot))
        return FetchGroup(slot=slot, fetches=fetches, band=band,
                          score_slot=slot)

    def plan_request(self, request: SearchRequest) -> QueryPlan:
        return self.plan(list(request.surface_ids), mode=request.mode,
                         window=request.window)

    def plan(self, surface_ids, mode: str = MODE_PHRASE,
             window: int | None = None) -> QueryPlan:
        if mode == MODE_KWORD:
            raise NotImplementedError("K-word search is ported in a later slice")
        if window is None:
            window = self.index.params.near_window
        ana = self.index.analyzer
        form_lists = [ana.forms_of(s) for s in surface_ids]
        # near mode is windowed for every query, stop forms included — the
        # baseline's single index holds stop posting lists, so it pays the
        # full-list reads the multi-key index exists to avoid
        groups = []
        if mode == MODE_PHRASE:
            for i, forms in enumerate(form_lists):
                groups.append(self._slot_group(i, forms, band=0))
        else:
            counts = [sum(int(self._counts[f]) for f in forms) for forms in form_lists]
            pivot = int(np.argmin(counts))
            for i, forms in enumerate(form_lists):
                groups.append(self._slot_group(i, forms,
                                               band=0 if i == pivot else window))
        return QueryPlan(subplans=[SubPlan(qtype=0, mode=mode, groups=groups,
                                           n_slots=len(form_lists))])


def near_query_contains_stop(lexicon, analyzer, surface_ids,
                             mode: str = MODE_NEAR) -> bool:
    """True when a near-mode query has at least one stop basic form among
    its words' forms — the population the paper's Type-4 rule used to
    confine to sequential matching, and which the multi-component key index
    (QTYPE_MULTI plans) now serves with true windowed semantics."""
    if mode != MODE_NEAR:
        return False
    return any(bool(lexicon.is_stop(np.asarray(analyzer.forms_of(s))).any())
               for s in surface_ids)


def near_query_stop_confined(lexicon, analyzer, surface_ids,
                             mode: str = MODE_NEAR) -> bool:
    """True when EVERY basic form of EVERY query word is a stop form.

    Such a near query has only all-stop tier combinations, so every subquery
    is Type 1 — contiguous stop-phrase matching, word order disregarded —
    and it has no doc-level fallback either (stop words carry no meaning
    doc-level).  An every-other-word query sampled from an indexed document
    legitimately may not find its source; these are the ONLY near queries
    recall is not promised for since the multi-component key index
    (QTYPE_MULTI) gave every mixed stop-containing near query windowed
    semantics.  The benchmark's `missed_source_docs` and the serve parity
    tests share this single predicate."""
    if mode != MODE_NEAR:
        return False
    return all(bool(lexicon.is_stop(np.asarray(analyzer.forms_of(s))).all())
               for s in surface_ids)


# ---------------------------------------------------------------------------
# brute-force oracle
# ---------------------------------------------------------------------------

def _tier_splits(form_lists, lexicon):
    """Mirror Planner._split_by_tier (the paper's query-splitting rule)."""
    import itertools
    per_slot = []
    for forms in form_lists:
        tiers = {}
        for f in forms:
            tiers.setdefault(int(lexicon.base_tier[f]), []).append(f)
        per_slot.append(sorted(tiers.items()))
    return list(itertools.product(*per_slot))


def _stop_multiset_anchor_set(tiered, tf_prim, tf_sec, doc_of, pos_of,
                              lexicon, params):
    """Any-order contiguous matches of an all-stop subquery (Type 1) — the
    anchor set shared by the plain and the ranked oracle."""
    import itertools
    from repro_torch.core.lexicon import TIER_STOP
    from repro_torch.core.planner import split_query_parts
    T = len(tf_prim)
    n = len(tiered)
    parts = split_query_parts(n, params.min_len, params.max_len)
    part_hits = []
    for (pstart, L) in parts:
        slot_forms = [tiered[pstart + j][1] for j in range(L)]
        qsets = {tuple(sorted(c)) for c in itertools.product(*slot_forms)}
        hits = set()
        for t in range(T - L + 1):
            if doc_of[t] != doc_of[t + L - 1]:
                continue
            cands = []
            okwin = True
            for u in range(t, t + L):
                forms = [f for f in (tf_prim[u], tf_sec[u])
                         if f >= 0 and lexicon.base_tier[f] == TIER_STOP]
                if not forms:
                    okwin = False
                    break
                cands.append(forms)
            if not okwin:
                continue
            wsets = {tuple(sorted(c)) for c in itertools.product(*cands)}
            if wsets & qsets:
                hits.add((int(doc_of[t]), int(pos_of[t]) - pstart))
        part_hits.append(hits)
    out = part_hits[0]
    for h in part_hits[1:]:
        out &= h
    return out


def brute_force_search(corpus: Corpus, index: IndexSet, surface_ids,
                       mode: str = MODE_PHRASE, window: int | None = None):
    """O(corpus) oracle with the *paper's* match semantics.

    Mirrors the engine exactly: the query is tier-split; each subquery is
    matched per its type:

      * all-stop subqueries: contiguous window, word order DISREGARDED
        (the stop-phrase index keys are sorted multisets), with the planner's
        part-splitting for phrases longer than MaxLength;
      * stop-containing subqueries, phrase mode: precise positional match
        (Type 4);
      * otherwise, phrase mode = precise positional; near mode = every word
        within `window` of the pivot (the planner's pivot rule) — INCLUDING
        stop slots: since the multi-component key index, near-mode
        subqueries containing stop forms get TRUE windowed answers
        (QTYPE_MULTI), no Type-4 sequential confinement.

    Returns (positional_matches, doc_matches): positional = set[(doc, anchor)]
    where anchor is the phrase start (phrase/stop) or the pivot position
    (near); doc_matches = distance-disregarding doc-level intersection of the
    non-stop words (the stream-1 fallback's ground truth).
    """
    import itertools

    lexicon, analyzer, params = index.lexicon, index.analyzer, index.params
    if window is None:
        window = params.near_window
    occ_counts = index.base_occ_counts()

    tf_prim = analyzer.primary[corpus.tokens]
    tf_sec = analyzer.secondary[corpus.tokens]
    doc_of = corpus.doc_ids_per_token()
    pos_of = corpus.positions_per_token()
    T = corpus.n_tokens
    from repro_torch.core.lexicon import TIER_STOP
    from repro_torch.core.planner import pick_pivot, split_query_parts

    def token_matches(slot_forms):
        m = np.isin(tf_prim, list(slot_forms))
        m |= np.isin(tf_sec, list(slot_forms)) & (tf_sec >= 0)
        return m

    def stop_multiset_anchors(tiered):
        """Any-order contiguous matches of an all-stop subquery."""
        return _stop_multiset_anchor_set(tiered, tf_prim, tf_sec, doc_of,
                                         pos_of, lexicon, params)

    positional = set()
    doc_level_all = set()
    for tiered in _tier_splits([analyzer.forms_of(s) for s in surface_ids], lexicon):
        tiers = [t for t, _ in tiered]
        n = len(tiered)
        sub_mode = mode   # near stays windowed even with stop slots (QTYPE_MULTI)
        if all(t == TIER_STOP for t in tiers):
            if n >= params.min_len:
                positional |= stop_multiset_anchors(tiered)
            docs = None   # stop-only: no doc-level fallback
        else:
            matches = [token_matches(forms) for _, forms in tiered]
            if sub_mode == MODE_PHRASE:
                ok = matches[0][: T - n + 1].copy()
                for i in range(1, n):
                    ok &= matches[i][i : T - n + 1 + i]
                if n > 1:
                    ok &= doc_of[: T - n + 1] == doc_of[n - 1 :]
                for t in np.nonzero(ok)[0]:
                    positional.add((int(doc_of[t]), int(pos_of[t])))
            else:
                pivot = pick_pivot(tiered, occ_counts)
                for t in np.nonzero(matches[pivot])[0]:
                    good = True
                    for i, m in enumerate(matches):
                        if i == pivot:
                            continue
                        lo, hi = max(0, t - window), min(T, t + window + 1)
                        if not (m[lo:hi] & (doc_of[lo:hi] == doc_of[t])).any():
                            good = False
                            break
                    if good:
                        positional.add((int(doc_of[t]), int(pos_of[t])))
            # doc-level (stream-1 fallback) truth: non-stop words only
            docs = None
            for (t, forms), m in zip(tiered, matches):
                if t == TIER_STOP:
                    continue
                d = set(np.unique(doc_of[m]).tolist())
                docs = d if docs is None else (docs & d)
        if docs:
            doc_level_all |= docs
    return positional, doc_level_all
