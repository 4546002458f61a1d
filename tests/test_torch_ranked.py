"""Ranked search (SearchRequest.rank=True) in the port, on the CPU, against
the reference package.

Same corpus, same requests: the port's `search_batch` and `search` must
return exactly the reference engine's ranked responses — doc, pos,
postings_read, used_fallback, doc_only, subplan_types, anchor scores and
provenance, ranked doc ids and float32 doc scores, bit for bit — on the
stop-heavy near stream and the paper's phrase / near stream, for plans
forced through the flexible escape path, at a fine doc-shard grain, for
doc-only fallbacks, under `top_k` truncation, and on the ordinary-index
baseline.  The port's `brute_force_ranked` agrees with the responses (to
the float32 tolerance of tests/test_ranking.py) and with the reference's
oracle; the ranked merge's top-k tie rule and the flex path's two-probe
`scored_probe` equal the reference's.
"""
import numpy as np
import pytest
import torch

import repro_torch.core.batch_executor as port_bx
from repro.core import SearchRequest as RefRequest
from repro.core import brute_force_ranked as ref_brute_force_ranked
from repro_torch.carry import index_from_reference
from repro_torch.core import (AdditionalIndexEngine, CorpusConfig,
                              LexiconConfig, OrdinaryEngine, RankingParams,
                              SearchRequest, brute_force_ranked,
                              generate_corpus)
from repro_torch.core import executor as port_executor

FIELDS = ("doc", "pos", "postings_read", "used_fallback", "doc_only",
          "subplan_types", "ranked", "anchor_scores", "anchor_subplans",
          "doc_ids", "doc_scores")


def assert_same_response(want, got, what):
    for f in FIELDS:
        w, g = getattr(want, f), getattr(got, f)
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            assert isinstance(w, np.ndarray) and isinstance(g, np.ndarray), \
                (what, f, w, g)
            assert g.dtype == w.dtype and np.array_equal(g, w), (what, f)
        else:
            assert g == w, (what, f, w, g)


_CARRIED = {}


def carried_world(small_world):
    """The reference index carried into the port (tests/test_torch_port.py
    shows it equal to the port's own build), the port's corpus and both
    port engines on the CPU; built once per reference world (the K-word
    tests share it)."""
    key = id(small_world["index"])
    if key not in _CARRIED:
        lc = LexiconConfig(n_surface=8000, n_base=6000, n_stop=150,
                           n_frequent=500, seed=2)
        corpus = generate_corpus(lc, CorpusConfig(n_docs=120,
                                                  mean_doc_len=400, seed=2))
        index = index_from_reference(small_world["index"])
        _CARRIED[key] = {"corpus": corpus, "index": index,
                         "additional": AdditionalIndexEngine(index,
                                                             device="cpu"),
                         "ordinary": OrdinaryEngine(index, device="cpu")}
    return _CARRIED[key]


@pytest.fixture(scope="module")
def port_world(small_world):
    return carried_world(small_world)


def _request_sets(stop_near_queries, paper_queries):
    return {
        "stop_near": [dict(surface_ids=q, mode="near", rank=True)
                      for q, _ in stop_near_queries[:16]],
        "paper": [dict(surface_ids=q, mode=m, rank=True, top_k=k)
                  for (q, m, _), k in zip(paper_queries[:24],
                                          [None, None, 2] * 8)],
    }


@pytest.fixture(scope="module")
def ref_ranked(small_world, stop_near_queries, paper_queries):
    """The reference engines' ranked search_batch responses per (engine,
    request set), computed once (the reference's own tests hold its
    search_batch equal to its per-query search).  The reference's batched
    step compiles per shape bucket, which bounds the request counts: the
    additional engine answers both sets in one batch, so they share
    buckets; the ordinary engine answers the paper set's first six."""
    sets = _request_sets(stop_near_queries, paper_queries)
    union = sets["stop_near"] + sets["paper"]
    want = small_world["engine"].search_batch([RefRequest(**r) for r in union])
    n = len(sets["stop_near"])
    cache = {("additional", "stop_near"): (sets["stop_near"], want[:n]),
             ("additional", "paper"): (sets["paper"], want[n:])}
    reqs = sets["paper"][:6]
    cache["ordinary", "paper"] = reqs, small_world["ordinary"].search_batch(
        [RefRequest(**r) for r in reqs])
    return lambda kind, name: cache[kind, name]


@pytest.mark.parametrize("name", ["stop_near", "paper"])
def test_ranked_search_batch_matches_reference(ref_ranked, port_world, name):
    reqs, want = ref_ranked("additional", name)
    got = port_world["additional"].search_batch(
        [SearchRequest(**r) for r in reqs])
    assert len(got) == len(reqs)
    for r, w, g in zip(reqs, want, got):
        assert_same_response(w, g, r)
    assert sum(len(g.doc_ids) for g in got) > 0


@pytest.mark.parametrize("name", ["stop_near", "paper"])
def test_ranked_search_matches_reference(ref_ranked, port_world, name):
    reqs, want = ref_ranked("additional", name)
    eng = port_world["additional"]
    for r, w in zip(reqs, want):
        assert_same_response(w, eng.search(SearchRequest(**r)), r)


@pytest.mark.parametrize("entry", ["search_batch", "search"])
def test_ordinary_ranked_matches_reference(ref_ranked, port_world, entry):
    reqs, want = ref_ranked("ordinary", "paper")
    eng = port_world["ordinary"]
    if entry == "search_batch":
        got = eng.search_batch([SearchRequest(**r) for r in reqs])
    else:
        got = [eng.search(SearchRequest(**r)) for r in reqs]
    for r, w, g in zip(reqs, want, got):
        assert_same_response(w, g, r)


def test_ranked_flex_escape_matches_reference(ref_ranked, port_world,
                                              monkeypatch):
    """Shrunk split caps send most ranked plans to the flexible executor
    from inside search_batch; scores stay bit-identical."""
    monkeypatch.setattr(port_bx, "P_CAP", 1)
    monkeypatch.setattr(port_bx, "F_SPLIT_CAP", 2)
    eng = AdditionalIndexEngine(port_world["index"], device="cpu")
    reqs, want = ref_ranked("additional", "paper")
    plans = [eng.plan_request(SearchRequest(**r)) for r in reqs]
    assert sum(not eng.batch_executor._build_tasks(i, p, [], ranked=True)
               for i, p in enumerate(plans)) >= len(plans) // 2
    got = eng.search_batch([SearchRequest(**r) for r in reqs])
    assert eng.batch_executor.timings["flex"] > 0
    for r, w, g in zip(reqs, want, got):
        assert_same_response(w, g, r)


def test_ranked_docs_per_shard_changes_nothing(ref_ranked, port_world):
    eng = AdditionalIndexEngine(port_world["index"], device="cpu",
                                docs_per_shard=16)
    reqs, want = ref_ranked("additional", "stop_near")
    got = eng.search_batch([SearchRequest(**r) for r in reqs])
    for r, w, g in zip(reqs, want, got):
        assert_same_response(w, g, r)


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


def test_ranked_doc_only_fallback_matches_reference(small_world, port_world):
    ranking = RankingParams(proximity_scale=2.0, doc_only_score=0.25)
    queries = _scrambled_queries(small_world["corpus"])
    reqs = [dict(surface_ids=q, rank=True, top_k=k, ranking=ranking)
            for q, k in zip(queries, [None, 1] * len(queries))]
    from repro.core import RankingParams as RefRanking
    want = small_world["engine"].search_batch(
        [RefRequest(**{**r, "ranking": RefRanking(2.0, 0.25)}) for r in reqs])
    eng = port_world["additional"]
    got = eng.search_batch([SearchRequest(**r) for r in reqs])
    for r, w, g in zip(reqs, want, got):
        assert_same_response(w, g, r)
        assert_same_response(w, eng.search(SearchRequest(**r)), r)
    fb = [g for g in got if g.doc_only]
    assert fb and all(np.all(g.doc_scores == np.float32(0.25)) for g in fb)


def test_ranked_top_k_is_a_prefix_of_the_full_ranking(ref_ranked, port_world):
    reqs, _ = ref_ranked("additional", "paper")
    eng = port_world["additional"]
    full = eng.search_batch([SearchRequest(**{**r, "top_k": None})
                             for r in reqs])
    cut = eng.search_batch([SearchRequest(**{**r, "top_k": 2})
                            for r in reqs])
    assert any(len(f.doc_ids) > 2 for f in full)
    for f, c in zip(full, cut):
        assert np.array_equal(c.doc_ids, f.doc_ids[:2])
        assert np.array_equal(c.doc_scores, f.doc_scores[:2])


@pytest.mark.parametrize("top_k", [0, 1, 2, 3, 5, 6, 9, None])
def test_rank_docs_ties_match_reference(top_k):
    """Documents order by (score desc, doc asc); a top_k that cuts inside a
    run of tied scores keeps the lower docs, as the reference's
    `jax.lax.top_k` selection does."""
    from repro.core.executor import _rank_docs as ref_rank_docs
    doc_ids = np.array([2, 3, 5, 8, 11, 13, 21, 34], np.int32)
    doc_scores = np.array([1.5, 3.0, 1.5, 3.0, 0.5, 1.5, 3.0, 1.5],
                          np.float32)
    want = ref_rank_docs(doc_ids, doc_scores, top_k)
    got = port_executor._rank_docs(doc_ids, doc_scores, top_k)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    if top_k == 2:
        assert got[0].tolist() == [3, 8]


def test_ranked_responses_match_port_oracle(ref_ranked, port_world):
    """The first 16 ranked responses against the port's literal-loop
    oracle (scores to 1e-4: the engines accumulate float32, the oracle
    float64); the response order is the score order."""
    reqs, _ = ref_ranked("additional", "stop_near")
    corpus, index = port_world["corpus"], port_world["index"]
    got = port_world["additional"].search_batch(
        [SearchRequest(**r) for r in reqs[:16]])
    rtol = 1e-4
    for r, resp in zip(reqs[:16], got):
        a_sc, d_sc, d_lvl = brute_force_ranked(corpus, index, r["surface_ids"],
                                               mode=r["mode"])
        if resp.doc_only:
            assert set(resp.doc.tolist()) == d_lvl, r
            continue
        anchors = dict(zip(zip(resp.doc.tolist(), resp.pos.tolist()),
                           resp.anchor_scores.tolist()))
        assert set(anchors) == set(a_sc), r
        for k, v in anchors.items():
            assert abs(v - a_sc[k]) <= rtol * max(1.0, abs(a_sc[k])), (r, k)
        assert set(resp.doc_ids.tolist()) == set(d_sc), r
        for d, s in zip(resp.doc_ids.tolist(), resp.doc_scores.tolist()):
            assert abs(s - d_sc[d]) <= rtol * max(1.0, abs(d_sc[d])), (r, d)
        s = resp.doc_scores
        assert np.all((s[:-1] > s[1:]) | ((s[:-1] == s[1:])
                                          & (resp.doc_ids[:-1]
                                             < resp.doc_ids[1:])))


@pytest.mark.parametrize("mode", ["near", "phrase"])
def test_port_ranked_oracle_equals_reference_oracle(small_world, port_world,
                                                    stop_near_queries,
                                                    paper_queries, mode):
    queries = ([q for q, _ in stop_near_queries[:4]] if mode == "near"
               else [q for q, m, _ in paper_queries[:8] if m == "phrase"])
    for q in queries:
        want = ref_brute_force_ranked(small_world["corpus"],
                                      small_world["index"], q, mode=mode)
        got = brute_force_ranked(port_world["corpus"], port_world["index"], q,
                                 mode=mode)
        assert got == want, q


def test_scored_probe_matches_reference():
    """The flex path's two-probe banded min-delta equals the reference's on
    composite-sorted keys with band-0 deltas and band > 0 zero deltas (the
    plan's domain), sentinel probes and pads included."""
    import jax.numpy as jnp
    from repro.core.executor import SENTINEL
    from repro.core.executor import scored_probe as ref_scored_probe
    rng = np.random.default_rng(4)
    for band in (0, 1, 3, 8):
        keys = np.sort(rng.integers(0, 4000, 300)).astype(np.int64)
        delta = (rng.integers(0, 16, 300) if band == 0
                 else np.zeros(300, np.int64))
        sdb = port_executor.SCORE_DELTA_BITS
        comp = np.sort((keys << sdb) | delta)
        comp = np.concatenate([comp, np.full(212, SENTINEL, np.int64)])
        probe = np.concatenate([
            keys[rng.integers(0, 300, 200)] + rng.integers(-9, 10, 200),
            rng.integers(0, 4000, 100)]) << sdb
        probe[::37] = SENTINEL
        want = np.asarray(ref_scored_probe(jnp.asarray(comp)[None],
                                           jnp.asarray(probe)[None], band))[0]
        got = port_executor.scored_probe(torch.from_numpy(comp),
                                         torch.from_numpy(probe), band)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), band
