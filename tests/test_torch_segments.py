"""The port's incremental segments (`repro_torch.core.segments`) and the
engine's `doc_base` grid on the CPU: the scenarios of tests/test_segments.py
and the two segment scenarios of tests/test_front.py, one for one, under
the same names, against the reference package where it costs no compile.

* Index builds are numpy in both packages, so the port's `SegmentManager`
  is held to the reference's manager over the same batches (occurrence
  counts, segment doc bases, generation numbers), and its merged index to
  the reference's one-shot `build_all`, array by array.
* The batched executor's rows at `doc_base=37, docs_per_shard=16` (row
  shard ids, `shard_base`s, clipped slots) equal the reference
  `BatchExecutor._build_rows`'s on the same plans (host-only; the arena is
  lazy), and the answers at doc base 37 equal doc base 0's.
* The lifecycle scenarios (union parity, merge, search during merge,
  merger crash, background merger, serve-tier union, K-word, the front
  door's stale-cache regressions) hold the port's answers to the port's
  one-shot engine over the same documents, which tests/test_torch_engine.py
  and its siblings hold to the reference.

The segment world is the first SEG_DOCS documents of the small world:
every scenario builds its segments anew (numpy, linear in the documents),
and at the full 120 documents the file would need about a minute of
builds on one worker.
"""
import threading
import time

import numpy as np
import pytest

from repro_torch.core import (AdditionalIndexEngine, SearchRequest,
                              SegmentManager, brute_force_kword,
                              brute_force_search, build_all, concat_corpora,
                              corpus_batches)
from repro_torch.core.corpus import Corpus
from repro_torch.core.lexicon import TIER_ORDINARY
from repro_torch.core.planner import Planner, pick_pivot
from repro_torch.core.segments import SEG_FRESH, SEG_RETIRED
from repro_torch.serve.front import FrontDoor, FrontDoorConfig
from test_torch_port import _assert_same
from test_torch_ranked import carried_world

SEG_DOCS = 60
FAST_CFG = dict(default_deadline_ms=600_000.0, shard_timeout_s=60.0)


def _head(corpus, n, cls):
    offs = corpus.doc_offsets
    return cls(doc_offsets=offs[:n + 1].copy(),
               tokens=corpus.tokens[:offs[n]].copy())


def _requests(corpus, n=32, seed=11):
    """Phrase/near mix sampled from indexed docs, every third ranked."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        d = int(rng.integers(corpus.n_docs))
        toks = corpus.doc(d)
        k = int(rng.integers(2, 5))
        if len(toks) < 2 * k + 2:
            continue
        st = int(rng.integers(0, len(toks) - 2 * k))
        i = len(out)
        if i % 2:
            q, mode = toks[st:st + k], "phrase"
        else:
            q, mode = toks[st:st + 2 * k:2], "near"
        out.append(SearchRequest(tuple(int(x) for x in q), mode=mode,
                                 rank=(i % 3 == 0)))
    return out


def _kword_requests(corpus, n=24, seed=27):
    """K in {3,4,5} contiguous windows from indexed docs, span-wide window,
    every third ranked — the segment-union kword population."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        d = int(rng.integers(corpus.n_docs))
        toks = corpus.doc(d)
        k = int(rng.integers(3, 6))
        if len(toks) <= k + 4:
            continue
        st = int(rng.integers(0, len(toks) - k - 1))
        i = len(out)
        out.append(SearchRequest(tuple(int(x) for x in toks[st:st + k]),
                                 mode="kword", window=min(k + 1, 15),
                                 rank=(i % 3 == 0)))
    return out


def _assert_identical(ref, got, accounting=True, ctx=""):
    assert np.array_equal(ref.doc, got.doc), ctx
    assert np.array_equal(ref.pos, got.pos), ctx
    assert ref.used_fallback == got.used_fallback, ctx
    assert ref.doc_only == got.doc_only, ctx
    assert ref.subplan_types == got.subplan_types, ctx
    if accounting:
        assert ref.postings_read == got.postings_read, ctx
    assert ref.ranked == got.ranked, ctx
    if ref.ranked:
        assert np.array_equal(ref.anchor_scores, got.anchor_scores), ctx
        assert np.array_equal(ref.doc_ids, got.doc_ids), ctx
        assert np.array_equal(ref.doc_scores, got.doc_scores), ctx


@pytest.fixture(scope="module")
def seg_world(small_world):
    """The first SEG_DOCS documents of the small world in both packages, the
    port's one-shot index and engine over them, and the lexicon, analyzer
    and index parameters the managers build with."""
    from repro.core.corpus import Corpus as RefCorpus
    port = carried_world(small_world)
    corpus = _head(port["corpus"], SEG_DOCS, Corpus)
    index = build_all(corpus, port["index"].lexicon, port["index"].analyzer,
                      port["index"].params)
    return {"corpus": corpus, "index": index,
            "ref_corpus": _head(small_world["corpus"], SEG_DOCS, RefCorpus),
            "lex": index.lexicon, "ana": index.analyzer,
            "params": index.params,
            "engine": AdditionalIndexEngine(index, device="cpu")}


def _manager(seg_world, **kw):
    kw.setdefault("auto_merge", False)
    return SegmentManager(seg_world["lex"], seg_world["ana"],
                          seg_world["params"], device="cpu", **kw)


@pytest.fixture()
def manager(seg_world):
    mgr = _manager(seg_world)
    yield mgr
    mgr.close()


@pytest.fixture(scope="module")
def manager4(seg_world):
    """Four ingested batches, no merge (read-only users), with the
    generations its listener saw and the ones ingest returned."""
    mgr = _manager(seg_world)
    seen = []
    mgr.subscribe(seen.append)
    gens = [mgr.ingest(b) for b in corpus_batches(seg_world["corpus"], 4)]
    yield mgr, seen, gens
    mgr.close()


def test_corpus_batches_round_trip(seg_world):
    corpus = seg_world["corpus"]
    parts = corpus_batches(corpus, 5)
    assert sum(p.n_docs for p in parts) == corpus.n_docs
    back = concat_corpora(parts)
    assert np.array_equal(back.doc_offsets, corpus.doc_offsets)
    assert np.array_equal(back.tokens, corpus.tokens)


def test_generation_listeners_and_global_occ(small_world, seg_world,
                                             manager4):
    """Ingest bumps are monotonic and observed; occurrence counts are
    additive across segments — the union's occ equals the one-shot index's;
    doc bases, generations and counts equal the reference manager's over
    the same batches."""
    from repro.core import SegmentManager as RefManager
    from repro.core import corpus_batches as ref_corpus_batches
    corpus = seg_world["corpus"]
    mgr, seen, gens = manager4
    assert gens == sorted(gens) and len(set(gens)) == 4
    assert seen == gens
    assert mgr.generation == gens[-1]
    assert mgr.n_docs == corpus.n_docs
    assert [s.doc_base for s in mgr.segments] == \
        [round(i * corpus.n_docs / 4) for i in range(4)]
    assert np.array_equal(mgr.occ_counts(),
                          seg_world["index"].base_occ_counts())
    ref = RefManager(small_world["lex"], small_world["ana"],
                     small_world["index"].params, auto_merge=False)
    try:
        ref_gens = [ref.ingest(b)
                    for b in ref_corpus_batches(seg_world["ref_corpus"], 4)]
        assert ref_gens == gens and ref.generation == mgr.generation
        assert [s.doc_base for s in ref.segments] == \
            [s.doc_base for s in mgr.segments]
        assert [s.n_docs for s in ref.segments] == \
            [s.n_docs for s in mgr.segments]
        occ = mgr.occ_counts()
        assert occ.dtype == ref.occ_counts().dtype
        assert np.array_equal(occ, ref.occ_counts())
    finally:
        ref.close()


def test_multi_segment_union_parity(seg_world, manager4):
    """4 live segments, no merge: union results are bit-identical to the
    one-shot engine — accounting included when the union replays the
    one-shot plan (`plan_index`), and doc/pos/score identical under the
    manager's own planner."""
    mgr = manager4[0]
    reqs = _requests(seg_world["corpus"], n=32)
    ref = seg_world["engine"].search_batch(reqs)
    got = mgr.search_batch(reqs, plan_index=seg_world["index"])
    for q, (r, g) in zip(reqs, zip(ref, got)):
        _assert_identical(r, g, accounting=True, ctx=q)
    own = mgr.search_batch(reqs)
    for q, (r, g) in zip(reqs, zip(ref, own)):
        _assert_identical(r, g, accounting=False, ctx=q)
    assert sum(len(g.doc) for g in got) > 0


def test_merge_bit_identical_to_one_shot(small_world, seg_world, manager):
    """K ingest batches + merge == one-shot build: the merged segment's
    streams equal the reference's one-shot `build_all` of the same corpus,
    array by array, so results (accounting included, via the manager's OWN
    planner) match the one-shot engine, and positional results match the
    brute-force oracle."""
    from repro.core import build_all as ref_build_all
    corpus, index = seg_world["corpus"], seg_world["index"]
    for b in corpus_batches(corpus, 3):
        manager.ingest(b)
    assert manager.merge_now()
    segs = manager.segments
    assert len(segs) == 1 and segs[0].doc_base == 0
    assert manager.merges_completed == 1
    assert all(s.state == SEG_RETIRED for s in manager.retired_segments)
    merged = segs[0].index
    _assert_same(ref_build_all(seg_world["ref_corpus"], small_world["lex"],
                               small_world["ana"],
                               small_world["index"].params), merged)
    assert np.array_equal(merged.base_occ_counts(), index.base_occ_counts())
    reqs = _requests(corpus, n=32)
    ref = seg_world["engine"].search_batch(reqs)
    got = manager.search_batch(reqs)
    for q, (r, g) in zip(reqs, zip(ref, got)):
        _assert_identical(r, g, accounting=True, ctx=q)
    # oracle cross-check (paper: indexed phrases are precisely found)
    for q, g in list(zip(reqs, got))[:8]:
        positional, doc_level = brute_force_search(
            corpus, index, list(q.surface_ids), mode=q.mode)
        if g.doc_only:
            assert set(g.doc.tolist()) == doc_level, q
        else:
            assert set(zip(g.doc.tolist(), g.pos.tolist())) == positional, q


def test_planner_occ_refresh(small_world):
    """The frozen-stats bugfix, both halves: (a) refresh_occ_counts moves
    pick_pivot when the statistics change; (b) after ingest, every segment
    planner plans the same structure as the one-shot planner.  Over the
    whole small world in 3 batches, as tests/test_segments.py: a union
    planner plans on its largest segment's streams, and segments of 20
    documents or fewer already change one plan's groups in 24 (in the
    reference too; the answers stay equal)."""
    world = carried_world(small_world)
    corpus, index = world["corpus"], world["index"]
    lex = index.lexicon
    planner = Planner(index)
    reqs = _requests(corpus, n=24, seed=5)
    for near in reqs:
        if near.mode != "near":
            continue
        form_lists = [index.analyzer.forms_of(s) for s in near.surface_ids]
        tiered = [(int(lex.base_tier[int(f[0])]), [int(x) for x in f])
                  for f in form_lists]
        if sum(t == TIER_ORDINARY for t, _ in tiered) >= 2:
            break
    else:
        pytest.fail("no near query with two ordinary slots in the sample")
    occ = index.base_occ_counts().astype(np.int64)
    old_pivot = pick_pivot(tiered, occ)
    doctored = occ.copy()
    for f in form_lists[old_pivot]:
        doctored[f] = int(occ.max()) + 1
    planner.refresh_occ_counts(doctored)
    assert planner._occ_counts[int(form_lists[old_pivot][0])] == \
        int(occ.max()) + 1
    assert pick_pivot(tiered, doctored) != old_pivot
    planner.refresh_occ_counts()                  # back to the index's own
    assert np.array_equal(planner._occ_counts, occ)

    # (b) plan parity after ingest: segment backends + union planner agree
    # with the one-shot planner on plan structure (pivot bands included)
    mgr = SegmentManager(lex, index.analyzer, index.params, auto_merge=False,
                         device="cpu")
    for b in corpus_batches(corpus, 3):
        mgr.ingest(b)

    def sig(plan):
        return tuple(
            (sp.qtype, tuple((g.slot, g.band) for g in sp.groups),
             tuple((g.slot, g.band) for g in sp.fallback_groups))
            for sp in plan.subplans if sp.supported)

    one_shot = world["additional"].planner
    union = mgr.current_planner()
    backends = mgr.engine_backends()
    assert [b.doc_base for b in backends] == [s.doc_base for s in mgr.segments]
    for r in reqs:
        want = sig(one_shot.plan(list(r.surface_ids), mode=r.mode,
                                 ranked=r.rank))
        assert sig(union.plan(list(r.surface_ids), mode=r.mode,
                              ranked=r.rank)) == want, r
        for b in backends:
            assert sig(b.engine.planner.plan(
                list(r.surface_ids), mode=r.mode, ranked=r.rank)) == want, r
    mgr.close()


def test_search_during_merge(seg_world, manager):
    """Concurrent search-during-merge safety: queries issued while the
    merger is re-packing return bit-identical results throughout, and the
    post-merge generation still matches."""
    corpus = seg_world["corpus"]
    for b in corpus_batches(corpus, 4):
        manager.ingest(b)
    reqs = _requests(corpus, n=12, seed=3)
    ref = seg_world["engine"].search_batch(reqs)
    manager.merge_fault = lambda: time.sleep(0.4)   # widen the merge window
    done = threading.Event()
    ok = []

    def merge():
        ok.append(manager.merge_now())
        done.set()

    th = threading.Thread(target=merge)
    th.start()
    rounds = 0
    while not done.is_set():
        got = manager.search_batch(reqs)
        for q, (r, g) in zip(reqs, zip(ref, got)):
            _assert_identical(r, g, accounting=False, ctx=(rounds, q))
        rounds += 1
    th.join()
    assert ok == [True] and rounds >= 1
    assert len(manager.segments) == 1
    got = manager.search_batch(reqs)
    for q, (r, g) in zip(reqs, zip(ref, got)):
        _assert_identical(r, g, accounting=True, ctx=("post", q))


def test_merger_crash_leaves_old_generation(seg_world, manager):
    """Chaos tier: a merger crash mid-merge reverts the sources to FRESH,
    leaves the generation (and every query result) untouched, and a later
    healthy merge succeeds — no silent drops at any point."""
    corpus = seg_world["corpus"]
    for b in corpus_batches(corpus, 3):
        manager.ingest(b)
    gen = manager.generation
    reqs = _requests(corpus, n=12, seed=9)
    ref = seg_world["engine"].search_batch(reqs)

    def boom():
        raise RuntimeError("injected merger crash")

    manager.merge_fault = boom
    assert manager.merge_now() is False
    assert manager.merge_failures == 1
    assert manager.generation == gen               # old generation serves on
    assert len(manager.segments) == 3
    assert all(s.state == SEG_FRESH for s in manager.segments)
    got = manager.search_batch(reqs)
    for q, (r, g) in zip(reqs, zip(ref, got)):
        _assert_identical(r, g, accounting=False, ctx=q)
    manager.merge_fault = None                     # heal
    assert manager.merge_now()
    assert manager.generation == gen + 1
    assert len(manager.segments) == 1
    got = manager.search_batch(reqs)
    for q, (r, g) in zip(reqs, zip(ref, got)):
        _assert_identical(r, g, accounting=True, ctx=q)


def test_background_merger_thread(seg_world):
    """auto_merge: the background thread compacts once the fresh-segment
    count reaches the threshold; results stay identical before and after."""
    corpus = seg_world["corpus"]
    mgr = _manager(seg_world, merge_threshold=2, auto_merge=True)
    try:
        for b in corpus_batches(corpus, 4):
            mgr.ingest(b)
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if len(mgr.segments) == 1 and mgr.merges_completed >= 1:
                break
            time.sleep(0.05)
        assert len(mgr.segments) == 1, [s.state for s in mgr.segments]
        reqs = _requests(corpus, n=16, seed=21)
        ref = seg_world["engine"].search_batch(reqs)
        for q, (r, g) in zip(reqs, zip(ref, mgr.search_batch(reqs))):
            _assert_identical(r, g, accounting=True, ctx=q)
    finally:
        mgr.close()


def test_serve_union_parity(seg_world, manager):
    """The serve tier unions across segments too: per-segment SearchServe
    backends under the shard merge are bit-identical to the one-shot engine
    (accounting via the one-shot plan replay)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.search_serve import SearchServeConfig

    corpus, index = seg_world["corpus"], seg_world["index"]
    for b in corpus_batches(corpus, 2):
        manager.ingest(b)
    cfg = SearchServeConfig(queries=16, postings_pad=4096, seed_pad=1024,
                            n_basic=1, n_expanded=1, n_stop=1, n_first=1,
                            n_multi=1)
    backends = manager.serve_backends(
        cfg, make_host_mesh(data=1, model=1, device="cpu"))
    assert [b.doc_base for b in backends] == [s.doc_base
                                              for s in manager.segments]
    reqs = _requests(corpus, n=16, seed=17)
    ref = seg_world["engine"].search_batch(reqs)
    got = manager.search_batch(reqs, backends=backends, plan_index=index)
    for q, (r, g) in zip(reqs, zip(ref, got)):
        _assert_identical(r, g, accounting=True, ctx=q)


# ---------------------------------------------------------------------------
# K-word proximity across the segment lifecycle (arXiv:2009.02684)
# ---------------------------------------------------------------------------


def test_kword_union_and_merge_parity(seg_world, manager):
    """K-word spans across 4 live segments (global doc grid, cluster-global
    occ pivots) are bit-identical to the one-shot engine; after the merge
    the manager's OWN planner matches with accounting, and positional
    anchors match the nested-loop oracle."""
    corpus, index = seg_world["corpus"], seg_world["index"]
    for b in corpus_batches(corpus, 4):
        manager.ingest(b)
    reqs = _kword_requests(corpus, n=24)
    ref = seg_world["engine"].search_batch(reqs)
    got = manager.search_batch(reqs, plan_index=index)
    for q, (r, g) in zip(reqs, zip(ref, got)):
        _assert_identical(r, g, accounting=True, ctx=q)
    own = manager.search_batch(reqs)
    for q, (r, g) in zip(reqs, zip(ref, own)):
        _assert_identical(r, g, accounting=False, ctx=q)
    assert sum(len(g.doc) for g in got) > 0

    assert manager.merge_now()
    merged = manager.search_batch(reqs)
    for q, (r, g) in zip(reqs, zip(ref, merged)):
        _assert_identical(r, g, accounting=True, ctx=q)
    for q, g in list(zip(reqs, merged))[:8]:
        positional, doc_level = brute_force_kword(
            corpus, index, list(q.surface_ids), q.window)
        if g.doc_only:
            assert set(g.doc.tolist()) == doc_level, q
        else:
            assert set(zip(g.doc.tolist(), g.pos.tolist())) == positional, q


def test_kword_search_during_background_merge(seg_world):
    """kword queries racing a live background merge return EXACT
    post-ingest answers at every poll — never a pre-merge/pre-ingest
    partial — and the post-merge steady state matches the one-shot
    engine with accounting."""
    corpus = seg_world["corpus"]
    mgr = _manager(seg_world, merge_threshold=2, auto_merge=True)
    try:
        for b in corpus_batches(corpus, 4):
            mgr.ingest(b)
        reqs = _kword_requests(corpus, n=8, seed=29)
        ref = seg_world["engine"].search_batch(reqs)
        deadline = time.monotonic() + 60.0
        polls = 0
        while time.monotonic() < deadline:
            for q, (r, g) in zip(reqs, zip(ref, mgr.search_batch(reqs))):
                _assert_identical(r, g, accounting=False, ctx=q)
            polls += 1
            if len(mgr.segments) == 1 and mgr.merges_completed >= 1:
                break
            time.sleep(0.05)
        assert len(mgr.segments) == 1, [s.state for s in mgr.segments]
        assert polls >= 1
        for q, (r, g) in zip(reqs, zip(ref, mgr.search_batch(reqs))):
            _assert_identical(r, g, accounting=True, ctx=q)
    finally:
        mgr.close()


# ---------------------------------------------------------------------------
# the front door over a segment manager: ingest vs the result cache
# ---------------------------------------------------------------------------


def _stale_cache_scenario(seg_world, req_of):
    corpus = seg_world["corpus"]
    batches = corpus_batches(corpus, 4)
    pre_docs = sum(b.n_docs for b in batches[:3])
    mgr = _manager(seg_world)
    for b in batches[:3]:
        mgr.ingest(b)
    # query sourced from a batch-4 doc (not yet ingested)
    d_new = pre_docs + batches[3].n_docs // 2
    req = req_of(corpus.doc(d_new))
    front = FrontDoor(segments=mgr,
                      cfg=FrontDoorConfig(cache_capacity=16, **FAST_CFG))
    try:
        first = front.search(req)
        assert first.status == "SERVED_EXACT" and not first.cached
        assert all(int(x) < pre_docs for x in first.doc)
        again = front.search(req)
        assert again.cached and front.stats.cache_hits == 1

        mgr.ingest(batches[3])              # the index just changed

        fresh = front.search(req)
        assert not fresh.cached, "served a pre-ingest cached response"
        assert fresh.status == "SERVED_EXACT"
        assert d_new in set(int(x) for x in fresh.doc)
        # bit-identical to the one-shot engine over the full corpus
        ref = seg_world["engine"].search_batch([req])[0]
        assert np.array_equal(ref.doc, fresh.doc)
        assert np.array_equal(ref.pos, fresh.pos)
        assert ref.used_fallback == fresh.used_fallback
        assert ref.doc_only == fresh.doc_only
        # postings_read deliberately unasserted: the segment union plans
        # with the manager's own occ stats (same bits, other accounting)
        again2 = front.search(req)
        assert again2.cached and np.array_equal(fresh.doc, again2.doc)
        assert front.stats.generation_bumps >= 1
        assert front.stats.stale_cache_hits == 0
        st = front.stats
        assert st.responded == st.submitted
    finally:
        front.close()
        front.dispatcher._pool.shutdown(wait=True)
        mgr.close()


def test_front_segment_ingest_never_serves_stale_cache(seg_world):
    """THE stale-cache regression: a cached response must never survive a
    segment ingest.  Query before ingest (cached), ingest a batch containing
    a new matching doc, re-query — the response must be fresh (non-cached),
    contain the new doc, and the stale tripwire must stay at zero."""
    _stale_cache_scenario(seg_world, lambda toks: SearchRequest(
        tuple(int(x) for x in toks[4:7]), mode="phrase"))


def test_front_kword_ingest_never_serves_stale_cache(seg_world):
    """K-word twin of the stale-cache regression."""
    _stale_cache_scenario(seg_world, lambda toks: SearchRequest(
        tuple(int(x) for x in toks[4:8]), mode="kword", window=5))


# ---------------------------------------------------------------------------
# the global doc-shard grid (`doc_base`) against the reference executor
# ---------------------------------------------------------------------------


def _row_sig(tasks):
    return [(t.plan_i, t.subplan_i, t.fallback, t.stop_checks,
             [(r.shard, r.shard_base, r.sortfree,
               [(g.band, [(f.stream, f.start, f.length, s, ln)
                          for f, s, ln in g.slots]) for g in r.groups])
              for r in t.rows]) for t in tasks]


@pytest.fixture(scope="module")
def grid_requests(small_world, paper_queries, stop_near_queries,
                  kword_queries):
    """Phrase / near, ranked stop-heavy near and K-word requests (as
    keyword dicts) over the small world."""
    return ([dict(surface_ids=q, mode=m) for q, m, _ in paper_queries[:16]]
            + [dict(surface_ids=q, mode="near", rank=True)
               for q, _ in stop_near_queries[:8]]
            + [dict(surface_ids=q, mode="kword", window=w)
               for q, w, _ in kword_queries[:8] if w <= 15])


@pytest.mark.parametrize("doc_base", [0, 37])
def test_doc_base_rows_match_reference(small_world, grid_requests, doc_base):
    """The port's rows on the global grid (shard ids, negative
    `shard_base`s, clipped slots) equal the reference executor's."""
    from repro.core import SearchRequest as RefRequest
    from repro.core.batch_executor import BatchExecutor as RefExecutor
    port_index = carried_world(small_world)["index"]
    ref_eng = small_world["engine"]
    ref_bx = RefExecutor(small_world["index"], docs_per_shard=16,
                         doc_base=doc_base)
    eng = AdditionalIndexEngine(port_index, device="cpu", docs_per_shard=16,
                                doc_base=doc_base)
    bx = eng.batch_executor
    dev = bx.dev
    assert (dev.doc_base, dev.n_shards, dev.docs_per_shard) == (
        ref_bx.dev.doc_base, ref_bx.dev.n_shards, ref_bx.dev.docs_per_shard)
    rows = []
    for i, kw in enumerate(grid_requests):
        req, ref_req = SearchRequest(**kw), RefRequest(**kw)
        want, got = [], []
        assert ref_bx._build_tasks(i, ref_eng.plan_request(ref_req), want,
                                   ranked=ref_req.rank) == \
            bx._build_tasks(i, eng.plan_request(req), got, ranked=req.rank)
        assert _row_sig(got) == _row_sig(want), kw
        rows += [r for t in got for r in t.rows]
    assert len(rows) > len(grid_requests)
    assert dev.n_shards == -(-(doc_base + dev.n_docs) // 16)
    assert all(r.shard_base == r.shard * 16 - doc_base for r in rows)
    # the first grid shard starts before the index's first doc
    assert any(r.shard_base < 0 for r in rows) == (doc_base % 16 != 0)


def test_doc_base_answers_equal_base_zero(small_world, grid_requests):
    """The grid moves row cuts, never answers: at doc base 37 every field
    of every response equals doc base 0's."""
    port_index = carried_world(small_world)["index"]
    reqs = [SearchRequest(**kw) for kw in grid_requests]
    base0 = AdditionalIndexEngine(port_index, device="cpu",
                                  docs_per_shard=16).search_batch(reqs)
    eng37 = AdditionalIndexEngine(port_index, device="cpu",
                                  docs_per_shard=16, doc_base=37)
    got = eng37.search_batch(reqs)
    assert eng37.batch_executor.dev.n_shards == -(-(37 + 120) // 16)
    for q, (r, g) in zip(reqs, zip(base0, got)):
        _assert_identical(r, g, accounting=True, ctx=q)
    assert sum(len(g.doc) for g in got) > 0


def test_windowed_near_stop_off_plans_like_reference(small_world,
                                                     stop_near_queries):
    """`windowed_near_stop=False` (the paper's Type-4 confinement, the speed
    benchmark's "before") plans every stop-heavy near query as the
    reference engine with the same option does, and changes plans."""
    from repro.core import AdditionalIndexEngine as RefEngine
    from test_torch_port import _plain
    port_index = carried_world(small_world)["index"]
    ref = RefEngine(small_world["index"], windowed_near_stop=False)
    eng = AdditionalIndexEngine(port_index, device="cpu",
                                windowed_near_stop=False)
    windowed = carried_world(small_world)["additional"]
    changed = 0
    for q, _ in stop_near_queries[:40]:
        got = eng.plan(q, mode="near")
        assert _plain(got) == _plain(ref.plan(q, mode="near")), q
        changed += _plain(got) != _plain(windowed.plan(q, mode="near"))
    assert changed > 0
