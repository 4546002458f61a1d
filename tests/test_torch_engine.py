"""The port's engines on the CPU against the reference package's engines.

Same corpus, same requests: the port's `search_batch` and `search` must
return exactly the reference's responses — doc, pos, postings_read,
used_fallback, doc_only and subplan_types — on the paper's phrase / near
stream, the stop-heavy near stream, scrambled-order queries that take the
doc-only fallback, plans forced through the flexible escape path, and a
fine doc-shard grain.  The same holds for the ordinary-index baseline.
"""
import numpy as np
import pytest

import repro_torch.core.batch_executor as port_bx
from repro.core import SearchRequest as RefRequest
from repro_torch.core import (AdditionalIndexEngine, CorpusConfig,
                              LexiconConfig, OrdinaryEngine, SearchRequest,
                              brute_force_search, build_all, generate_corpus,
                              make_lexicon_and_analyzer)

FIELDS = ("doc", "pos", "postings_read", "used_fallback", "doc_only",
          "subplan_types")


def _assert_same_response(want, got, what):
    for f in FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), (what, f)
        else:
            assert g == w, (what, f, w, g)


@pytest.fixture(scope="module")
def port_index():
    lc = LexiconConfig(n_surface=8000, n_base=6000, n_stop=150,
                       n_frequent=500, seed=2)
    lex, ana = make_lexicon_and_analyzer(lc)
    corpus = generate_corpus(lc, CorpusConfig(n_docs=120, mean_doc_len=400,
                                              seed=2))
    return build_all(corpus, lex, ana)


@pytest.fixture(scope="module")
def port_engines(port_index):
    return {"additional": AdditionalIndexEngine(port_index, device="cpu"),
            "ordinary": OrdinaryEngine(port_index, device="cpu")}


def _ref_engine(small_world, kind):
    return small_world["engine" if kind == "additional" else "ordinary"]


def _requests(fixture, queries):
    if fixture == "paper_queries":
        return [(q, m) for q, m, _ in queries]
    return [(q, "near") for q, _ in queries]


@pytest.fixture(scope="module")
def ref_batches(request, small_world):
    """The reference engine's search_batch responses per (engine, query
    fixture), computed once: the reference's own tests hold its search_batch
    equal to its per-query search, so both port entry points are compared
    with these."""
    cache = {}

    def get(kind, fixture):
        if (kind, fixture) not in cache:
            qs = _requests(fixture, request.getfixturevalue(fixture))
            cache[kind, fixture] = qs, _ref_engine(small_world, kind).search_batch(
                [RefRequest(q, mode=m) for q, m in qs])
        return cache[kind, fixture]
    return get


# the ordinary baseline reads every full posting list: one stream suffices
CASES = [("additional", "paper_queries"), ("additional", "stop_near_queries"),
         ("ordinary", "paper_queries")]


@pytest.mark.parametrize("kind,fixture", CASES)
def test_search_batch_matches_reference(ref_batches, port_engines, kind,
                                        fixture):
    qs, want = ref_batches(kind, fixture)
    got = port_engines[kind].search_batch([SearchRequest(q, mode=m)
                                           for q, m in qs])
    assert len(got) == len(qs)
    for (q, m), w, g in zip(qs, want, got):
        _assert_same_response(w, g, (q, m))


@pytest.mark.parametrize("kind,fixture", CASES)
def test_search_matches_reference(ref_batches, port_engines, kind, fixture):
    qs, want = ref_batches(kind, fixture)
    for (q, m), w in zip(qs, want):
        _assert_same_response(
            w, port_engines[kind].search(SearchRequest(q, mode=m)), (q, m))


def _scrambled_queries(corpus):
    """Words from two docs in an order no doc has: positional misses that
    take the doc-only fallback (tests/test_batch_executor.py's recipe)."""
    rng = np.random.default_rng(23)
    queries = []
    for _ in range(8):
        d1, d2 = rng.integers(corpus.n_docs, size=2)
        t1, t2 = corpus.doc(int(d1)), corpus.doc(int(d2))
        if len(t1) < 8 or len(t2) < 8:
            continue
        queries.append([int(t1[3]), int(t2[5]), int(t1[7])])
    return queries


@pytest.mark.parametrize("kind", ["additional", "ordinary"])
def test_fallback_queries_match_reference(small_world, port_engines, kind):
    queries = _scrambled_queries(small_world["corpus"])
    ref = _ref_engine(small_world, kind)
    want = ref.search_batch([RefRequest(q) for q in queries])
    got = port_engines[kind].search_batch([SearchRequest(q) for q in queries])
    for q, w, g in zip(queries, want, got):
        _assert_same_response(w, g, q)
        _assert_same_response(w, port_engines[kind].search(SearchRequest(q)), q)
    if kind == "additional":
        assert any(g.used_fallback for g in got)


def test_flex_escape_matches_reference(small_world, port_index, paper_queries,
                                       monkeypatch):
    """Shrunk table caps push plans through the flexible executor inside
    search_batch; answers stay the reference's."""
    monkeypatch.setattr(port_bx, "P_CAP", 1)
    monkeypatch.setattr(port_bx, "F_SPLIT_CAP", 2)
    eng = AdditionalIndexEngine(port_index, device="cpu")
    qs = [(q, m) for q, m, _ in paper_queries[:16]]
    plans = [eng.plan_request(SearchRequest(q, mode=m)) for q, m in qs]
    assert sum(not eng.batch_executor._build_tasks(i, p, [])
               for i, p in enumerate(plans)) >= len(plans) // 2
    got = eng.search_batch([SearchRequest(q, mode=m) for q, m in qs])
    assert eng.batch_executor.timings["flex"] > 0
    ref = small_world["engine"]
    for (q, m), g in zip(qs, got):
        _assert_same_response(ref.search(RefRequest(q, mode=m)), g, (q, m))


@pytest.mark.parametrize("kind", ["additional", "ordinary"])
def test_docs_per_shard_changes_nothing(ref_batches, port_index, kind):
    cls = AdditionalIndexEngine if kind == "additional" else OrdinaryEngine
    eng = cls(port_index, device="cpu", docs_per_shard=16)
    assert eng.batch_executor.dev.docs_per_shard == 16
    qs, want = ref_batches(kind, "paper_queries")
    got = eng.search_batch([SearchRequest(q, mode=m) for q, m in qs])
    for (q, m), w, g in zip(qs, want, got):
        _assert_same_response(w, g, (q, m))


def test_search_batch_matches_brute_force(small_world, port_engines,
                                          port_index, paper_queries):
    """The port's numpy oracle agrees with the port's batched answers."""
    corpus = small_world["corpus"]
    qs = [(q, m) for q, m, _ in paper_queries[:12]]
    got = port_engines["additional"].search_batch(
        [SearchRequest(q, mode=m) for q, m in qs])
    for (q, m), r in zip(qs, got):
        positional, doc_level = brute_force_search(corpus, port_index, q,
                                                   mode=m)
        if r.doc_only:
            assert set(r.doc.tolist()) == doc_level, (q, m)
        else:
            assert set(zip(r.doc.tolist(), r.pos.tolist())) == positional
