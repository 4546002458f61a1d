"""Engine facades behind the typed request/response API (core/api.py).

`AdditionalIndexEngine` — the paper's system: planner (Type 1-4 dispatch over
the stop-phrase / expanded / 3-stream basic indexes, plus the multi-component
key plans) + the PyTorch executors.

`OrdinaryEngine` — the comparison baseline (the paper benchmarks Sphinx
2.0.6): a single inverted index over every basic form, stop words included;
every query reads the *full* posting list of every query word.

Both consume `SearchRequest`s (`search` / `search_batch`) — phrase, near
and K-word, ranked or not — and return `SearchResponse`s, proximity-ranked
DocHits when `rank=True`.  They run on the card unless the caller asks for
the CPU (`device="cpu"`, as the tests do); on the card the batched path
launches the CUDA unpack, banded-intersect, min-delta and delta-mask
kernels.

`brute_force_search` — O(corpus) numpy oracle used by tests and by
chip_smoke.py to verify that indexed phrases are found exactly (paper:
"Since phrases are selected from an already-indexed document, they should
be precisely found"); `brute_force_ranked` — its scoring twin (literal
nested-loop proximity relevance per arXiv:2108.00410);
`brute_force_kword` / `brute_force_kword_ranked` — the K-word span oracles
(arXiv:2009.02684).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.api import SearchRequest, SearchResponse
from repro_torch.core.batch_executor import BatchExecutor
from repro_torch.core.builder import IndexSet
from repro_torch.core.corpus import Corpus
from repro_torch.core.executor import Executor, resolve_device
from repro_torch.core.kword import MODE_KWORD, pick_kword_anchor
from repro_torch.core.planner import (FetchGroup, MODE_NEAR, MODE_PHRASE,
                                      QTYPE_KWORD, Planner, QueryPlan,
                                      ResolvedFetch, SubPlan)


class _BatchSearchMixin:
    """Shared lazy batch-executor plumbing: the batched arena duplicates the
    posting streams on the device, so per-query-only users never pay for
    it.  The batch executor is built at the first `search_batch` (or the
    first read of `batch_executor`), and its device arena is copied at the
    first bucket step (`BatchDeviceIndex.device_arena`)."""

    def _init_executors(self, index: IndexSet, device, docs_per_shard,
                        doc_base: int = 0):
        self.index = index
        self.device = resolve_device(device)
        self.executor = Executor(index, self.device)
        self._docs_per_shard = docs_per_shard
        self._doc_base = doc_base
        self._batch_executor = None

    @property
    def batch_executor(self) -> BatchExecutor:
        if self._batch_executor is None:
            self._batch_executor = BatchExecutor(
                self.index, self.device, flex=self.executor,
                docs_per_shard=self._docs_per_shard,
                doc_base=self._doc_base)
        return self._batch_executor

    def _plan(self, request: SearchRequest) -> QueryPlan:
        if not isinstance(request, SearchRequest):
            raise TypeError(f"expected a SearchRequest, got {type(request)}")
        return self.plan_request(request)

    def search(self, request: SearchRequest) -> SearchResponse:
        """One query through the flexible per-query executor."""
        return self.executor.execute(self._plan(request), request=request)

    def search_batch(self, requests) -> list[SearchResponse]:
        """Batched search: a sequence of SearchRequests through the
        plan-compiled batched executor — same results as per-query
        `search`, one device step per shape bucket."""
        requests = list(requests)
        ex = self.batch_executor
        tr = ex.trace
        with tr.span("batch", batch=ex.counts["batches"],
                     requests=len(requests)):
            ex.counts["batches"] += 1
            with tr.span("plan"):
                plans = [self._plan(r) for r in requests]
            return ex.execute_batch(plans, requests=requests)


class AdditionalIndexEngine(_BatchSearchMixin):
    """The paper's engine: additional indexes + Type 1-4 query processing.

    `search(SearchRequest)` runs one query through the flexible executor;
    `search_batch([SearchRequest, ...])` runs a whole batch through the
    batched executor (identical results — see batch_executor.py).
    `device=None` means the card; pass `device="cpu"` to run on the CPU.
    `occ_counts` gives the planner cluster-wide occurrence statistics when
    this engine holds one doc shard of a larger corpus (see Planner);
    `doc_base` is then this engine's first GLOBAL doc id (segments, doc
    shards): the batched executor lays its rows on the global shard grid,
    so every shard buckets identically (its answers keep local doc ids).
    `windowed_near_stop=False` restores the paper's Type-4 sequential
    confinement of near queries with stop forms (the speed benchmark's
    before / after comparison).
    """

    def __init__(self, index: IndexSet, device=None,
                 docs_per_shard: int | None = None,
                 windowed_near_stop: bool = True, occ_counts=None,
                 doc_base: int = 0):
        self.planner = Planner(index, windowed_near_stop=windowed_near_stop,
                               occ_counts=occ_counts)
        self._init_executors(index, device, docs_per_shard, doc_base)

    def refresh_occ_counts(self, occ_counts=None):
        """Re-snapshot the planner's pivot statistics (see
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
        elif mode == MODE_KWORD:
            # the baseline pays full posting-list reads for every slot, stop
            # words included; the anchor is the rarest slot that has a
            # non-stop form (the span join needs an anchorable slot), and
            # the K-way windowed join runs over the full lists
            lex = self.index.lexicon
            counts = [sum(int(self._counts[f]) for f in forms)
                      for forms in form_lists]
            nonstop = [i for i, forms in enumerate(form_lists)
                       if not bool(lex.is_stop(np.asarray(forms)).all())]
            eligible = nonstop or list(range(len(form_lists)))
            anchor = min(eligible, key=lambda i: counts[i])
            for i, forms in enumerate(form_lists):
                groups.append(self._slot_group(i, forms,
                                               band=0 if i == anchor else window))
            return QueryPlan(subplans=[SubPlan(
                qtype=QTYPE_KWORD, mode=MODE_KWORD, groups=groups,
                n_slots=len(form_lists), kw_window=window)])
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


def brute_force_ranked(corpus: Corpus, index: IndexSet, surface_ids,
                       mode: str = MODE_PHRASE, window: int | None = None,
                       ranking=None):
    """Ranked twin of `brute_force_search`: the proximity relevance model of
    api.py computed by literal nested loops over the corpus — the reference
    the engines' device scoring pass is checked against end to end.

    Per tier-split subquery, every match anchor scores

        sum over query slots i of w(d_i),     w(d) = 1 / (1 + d)

    with d_i = 0 for the pivot and for every slot of a precise-phrase /
    all-stop match (exact offsets), else the distance from the anchor to the
    nearest same-document token matching slot i within the window.  Anchors
    duplicated across subqueries keep their MAX score; a document's
    relevance is the sum over its anchors times `ranking.proximity_scale`.

    Returns (anchor_scores, doc_scores, doc_level): dicts keyed (doc, pos)
    and doc (float64 — the engines accumulate float32, so compare with
    tolerance), plus the doc-only fallback truth set (relevance
    `ranking.doc_only_score`, only reachable when no subquery has a
    positional match).
    """
    from repro_torch.core.api import RankingParams
    from repro_torch.core.lexicon import TIER_STOP
    from repro_torch.core.planner import pick_pivot

    ranking = ranking or RankingParams()
    lexicon, analyzer, params = index.lexicon, index.analyzer, index.params
    if window is None:
        window = params.near_window
    occ_counts = index.base_occ_counts()
    tf_prim = analyzer.primary[corpus.tokens]
    tf_sec = analyzer.secondary[corpus.tokens]
    doc_of = corpus.doc_ids_per_token()
    pos_of = corpus.positions_per_token()
    T = corpus.n_tokens

    def token_matches(slot_forms):
        m = np.isin(tf_prim, list(slot_forms))
        m |= np.isin(tf_sec, list(slot_forms)) & (tf_sec >= 0)
        return m

    anchor_scores: dict = {}
    doc_level_all: set = set()

    def put(anchor, score):
        prev = anchor_scores.get(anchor)
        if prev is None or score > prev:
            anchor_scores[anchor] = score

    for tiered in _tier_splits([analyzer.forms_of(s) for s in surface_ids],
                               lexicon):
        tiers = [t for t, _ in tiered]
        n = len(tiered)
        if all(t == TIER_STOP for t in tiers):
            if n >= params.min_len:
                for anchor in _stop_multiset_anchor_set(
                        tiered, tf_prim, tf_sec, doc_of, pos_of, lexicon,
                        params):
                    put(anchor, float(n))       # exact offsets: n * w(0)
            continue                            # stop-only: no doc fallback
        matches = [token_matches(forms) for _, forms in tiered]
        if mode == MODE_PHRASE:
            ok = matches[0][: T - n + 1].copy()
            for i in range(1, n):
                ok &= matches[i][i: T - n + 1 + i]
            if n > 1:
                ok &= doc_of[: T - n + 1] == doc_of[n - 1:]
            for t in np.nonzero(ok)[0]:
                put((int(doc_of[t]), int(pos_of[t])), float(n))
        else:
            pivot = pick_pivot(tiered, occ_counts)
            for t in np.nonzero(matches[pivot])[0]:
                score = 1.0                     # the pivot slot: w(0)
                good = True
                for i, m in enumerate(matches):
                    if i == pivot:
                        continue
                    lo, hi = max(0, t - window), min(T, t + window + 1)
                    near = np.nonzero(m[lo:hi]
                                      & (doc_of[lo:hi] == doc_of[t]))[0]
                    if len(near) == 0:
                        good = False
                        break
                    delta = int(np.abs(near + lo - t).min())
                    score += 1.0 / (1.0 + delta)
                if good:
                    put((int(doc_of[t]), int(pos_of[t])), score)
        # doc-level (stream-1 fallback) truth: non-stop words only
        docs = None
        for (tr, forms), m in zip(tiered, matches):
            if tr == TIER_STOP:
                continue
            d = set(np.unique(doc_of[m]).tolist())
            docs = d if docs is None else (docs & d)
        if docs:
            doc_level_all |= docs

    scale = float(ranking.proximity_scale)
    anchor_scores = {k: v * scale for k, v in anchor_scores.items()}
    doc_scores: dict = {}
    for (d, _p), s in anchor_scores.items():
        doc_scores[d] = doc_scores.get(d, 0.0) + s
    return anchor_scores, doc_scores, doc_level_all


# ---------------------------------------------------------------------------
# K-word proximity oracle (arXiv:2009.02684; planner QTYPE_KWORD)
# ---------------------------------------------------------------------------

def _kword_tier_hits(tiered, matches, anchor, window, doc_of, pos_of, T):
    """Literal nested-loop span matching for one tier-split subquery: yields
    (doc, pos, score) for every anchor occurrence where some assignment of
    one occurrence per remaining slot fits inside a (window + 1)-wide span
    containing the anchor — the window-start scan is spelled out as loops,
    nothing shared with the executors' mask math.  `score` is the ranked
    model's anchor score: w(0) for the anchor plus, per remaining slot, w of
    the nearest in-window occurrence (the banded min the executors read)."""
    for t in np.nonzero(matches[anchor])[0]:
        d = doc_of[t]
        cands = []
        good = True
        for i, m in enumerate(matches):
            if i == anchor:
                continue
            lo, hi = max(0, t - window), min(T, t + window + 1)
            idx = np.nonzero(m[lo:hi] & (doc_of[lo:hi] == d))[0]
            if len(idx) == 0:
                good = False
                break
            cands.append((idx + lo - t).astype(int))
        if not good:
            continue
        ok = False
        for w0 in range(-window, 1):          # window starts containing t
            if all(any(w0 <= dd <= w0 + window for dd in c) for c in cands):
                ok = True
                break
        if not ok:
            continue
        score = 1.0 + sum(1.0 / (1.0 + int(np.abs(c).min())) for c in cands)
        yield int(d), int(pos_of[t]), score


def brute_force_kword(corpus: Corpus, index: IndexSet, surface_ids,
                      window: int):
    """O(corpus) K-word span oracle: anchors are occurrences of the rarest
    non-stop slot (pick_kword_anchor — the planner's anchor rule); an anchor
    matches iff every other query word has an occurrence such that ALL K
    words fall inside one (window + 1)-wide position span.  Tier-split like
    the engine; all-stop tier combinations are unsupported (no anchor) and
    contribute nothing, mirroring the planner.

    Returns (positional, doc_matches): positional = set[(doc, anchor_pos)];
    doc_matches = distance-disregarding doc-level intersection of the
    non-stop words (the stream-1 fallback's ground truth)."""
    lexicon, analyzer = index.lexicon, index.analyzer
    occ_counts = index.base_occ_counts()
    tf_prim = analyzer.primary[corpus.tokens]
    tf_sec = analyzer.secondary[corpus.tokens]
    doc_of = corpus.doc_ids_per_token()
    pos_of = corpus.positions_per_token()
    T = corpus.n_tokens
    from repro_torch.core.lexicon import TIER_STOP

    def token_matches(slot_forms):
        m = np.isin(tf_prim, list(slot_forms))
        m |= np.isin(tf_sec, list(slot_forms)) & (tf_sec >= 0)
        return m

    positional = set()
    doc_level_all = set()
    for tiered in _tier_splits([analyzer.forms_of(s) for s in surface_ids],
                               lexicon):
        anchor = pick_kword_anchor(tiered, occ_counts)
        if anchor < 0:
            continue                         # all-stop: unsupported subplan
        matches = [token_matches(forms) for _, forms in tiered]
        for d, p, _s in _kword_tier_hits(tiered, matches, anchor, window,
                                         doc_of, pos_of, T):
            positional.add((d, p))
        docs = None
        for (t, _forms), m in zip(tiered, matches):
            if t == TIER_STOP:
                continue
            dset = set(np.unique(doc_of[m]).tolist())
            docs = dset if docs is None else (docs & dset)
        if docs:
            doc_level_all |= docs
    return positional, doc_level_all


def brute_force_kword_ranked(corpus: Corpus, index: IndexSet, surface_ids,
                             window: int, ranking=None):
    """Ranked twin of `brute_force_kword` (same shapes as
    `brute_force_ranked`): every span-matching anchor scores w(0) for the
    anchor slot plus w(nearest in-window distance) per remaining slot —
    exactly the banded min-delta accumulation the executors run, with
    found overridden by the span join.  Duplicate anchors across tier-split
    subqueries keep their MAX score; doc relevance sums a doc's anchors."""
    from repro_torch.core.api import RankingParams
    from repro_torch.core.lexicon import TIER_STOP

    ranking = ranking or RankingParams()
    lexicon, analyzer = index.lexicon, index.analyzer
    occ_counts = index.base_occ_counts()
    tf_prim = analyzer.primary[corpus.tokens]
    tf_sec = analyzer.secondary[corpus.tokens]
    doc_of = corpus.doc_ids_per_token()
    pos_of = corpus.positions_per_token()
    T = corpus.n_tokens

    def token_matches(slot_forms):
        m = np.isin(tf_prim, list(slot_forms))
        m |= np.isin(tf_sec, list(slot_forms)) & (tf_sec >= 0)
        return m

    anchor_scores: dict = {}
    doc_level_all: set = set()
    for tiered in _tier_splits([analyzer.forms_of(s) for s in surface_ids],
                               lexicon):
        anchor = pick_kword_anchor(tiered, occ_counts)
        if anchor < 0:
            continue
        matches = [token_matches(forms) for _, forms in tiered]
        for d, p, s in _kword_tier_hits(tiered, matches, anchor, window,
                                        doc_of, pos_of, T):
            prev = anchor_scores.get((d, p))
            if prev is None or s > prev:
                anchor_scores[(d, p)] = s
        docs = None
        for (t, _forms), m in zip(tiered, matches):
            if t == TIER_STOP:
                continue
            dset = set(np.unique(doc_of[m]).tolist())
            docs = dset if docs is None else (docs & dset)
        if docs:
            doc_level_all |= docs
    scale = float(ranking.proximity_scale)
    anchor_scores = {k: v * scale for k, v in anchor_scores.items()}
    doc_scores: dict = {}
    for (d, _p), s in anchor_scores.items():
        doc_scores[d] = doc_scores.get(d, 0.0) + s
    return anchor_scores, doc_scores, doc_level_all
