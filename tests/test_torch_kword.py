"""K-word proximity search (mode="kword", arXiv:2009.02684) in the port, on
the CPU, against the reference package.

Same corpus, same requests: on the seeded stop-heavy K-word suite
(`kword_queries`: K in {3, 4, 5}, ~10% of windows wider than the device
masks' 15, which ride the flexible escape path) the port's `search_batch`
and `search` return exactly the reference engine's responses, unranked and
ranked (float32 scores bit for bit), and so does the ordinary-index
baseline.  The port's `brute_force_kword` / `brute_force_kword_ranked`
agree with the responses and with the reference's oracles.
"""
import pytest

from repro.core import SearchRequest as RefRequest
from repro.core import brute_force_kword as ref_brute_force_kword
from repro.core import brute_force_kword_ranked as ref_brute_force_kword_ranked
from repro_torch.core import (SearchRequest, brute_force_kword,
                              brute_force_kword_ranked)
from repro_torch.core.kword import KW_DEVICE_MAX_WINDOW
# the response comparison and the carried-index world of the ranked tests
from test_torch_ranked import assert_same_response, carried_world

# six of the suite's first 19 queries, each asked unranked and ranked: four
# device shape buckets (G 4 and 8, one and two slots, a long-list split)
# and a wide window that only the flexible path serves; few buckets, because
# the reference's batched step compiles per shape bucket
SUITE_PICK = (0, 1, 3, 4, 10, 18)


@pytest.fixture(scope="module")
def port_world(small_world):
    return carried_world(small_world)


@pytest.fixture(scope="module")
def kword_requests(kword_queries):
    """The picked suite queries as unranked and as ranked requests."""
    qs = [kword_queries[i] for i in SUITE_PICK]
    assert any(w > KW_DEVICE_MAX_WINDOW for _, w, _ in qs)
    return {rank: [dict(surface_ids=q, mode="kword", window=w, rank=rank)
                   for q, w, _ in qs] for rank in (False, True)}


@pytest.fixture(scope="module")
def ref_kword(small_world, kword_requests):
    """The reference engines' search_batch responses per (engine, ranked),
    computed once (the reference's own tests hold its search_batch equal to
    its per-query search): one batch per engine holding the unranked and
    the ranked requests, so their doc-only fallback rows share buckets; the
    ordinary engine answers the first three of each."""
    cache = {}
    for kind, n in (("additional", len(SUITE_PICK)), ("ordinary", 3)):
        eng = small_world["engine" if kind == "additional" else "ordinary"]
        reqs = {rank: kword_requests[rank][:n] for rank in (False, True)}
        want = eng.search_batch([RefRequest(**r)
                                 for r in reqs[False] + reqs[True]])
        cache[kind, False] = reqs[False], want[:n]
        cache[kind, True] = reqs[True], want[n:]
    return lambda kind, rank: cache[kind, rank]


@pytest.mark.parametrize("rank", [False, True])
def test_kword_search_batch_matches_reference(ref_kword, port_world, rank):
    reqs, want = ref_kword("additional", rank)
    got = port_world["additional"].search_batch(
        [SearchRequest(**r) for r in reqs])
    assert len(got) == len(reqs)
    for r, w, g in zip(reqs, want, got):
        assert_same_response(w, g, r)
    assert sum(len(g.doc) for g in got) > 0


@pytest.mark.parametrize("rank", [False, True])
def test_kword_search_matches_reference(ref_kword, port_world, rank):
    reqs, want = ref_kword("additional", rank)
    eng = port_world["additional"]
    for r, w in zip(reqs, want):
        assert_same_response(w, eng.search(SearchRequest(**r)), r)


@pytest.mark.parametrize("rank", [False, True])
def test_ordinary_kword_matches_reference(ref_kword, port_world, rank):
    reqs, want = ref_kword("ordinary", rank)
    eng = port_world["ordinary"]
    got = eng.search_batch([SearchRequest(**r) for r in reqs])
    for r, w, g in zip(reqs, want, got):
        assert_same_response(w, g, r)
        assert_same_response(w, eng.search(SearchRequest(**r)), r)


def test_kword_routing_matches_reference(small_world, port_world,
                                         kword_requests):
    """Exactly the reference's plans ride the flexible path, among them
    windows wider than the device masks' 15."""
    ref_bx = small_world["engine"].batch_executor
    eng = port_world["additional"]
    flex_wide = 0
    for rank in (False, True):
        for r in kword_requests[rank]:
            req = SearchRequest(**r)
            plan = eng.plan_request(req)
            ref_plan = small_world["engine"].plan_request(RefRequest(**r))
            fits = eng.batch_executor._build_tasks(0, plan, [], ranked=rank)
            assert fits == ref_bx._build_tasks(0, ref_plan, [], ranked=rank), r
            flex_wide += r["window"] > KW_DEVICE_MAX_WINDOW and not fits
    assert flex_wide > 0


@pytest.mark.parametrize("rank", [False, True])
def test_kword_responses_match_port_oracle(ref_kword, port_world, rank):
    """The responses against the port's literal-loop oracles: the anchor
    set exactly, ranked scores to 1e-4 (float32 accumulation against
    float64)."""
    reqs, _ = ref_kword("additional", rank)
    corpus, index = port_world["corpus"], port_world["index"]
    got = port_world["additional"].search_batch(
        [SearchRequest(**r) for r in reqs])
    for r, resp in zip(reqs, got):
        q, w = r["surface_ids"], r["window"]
        if not rank:
            positional, doc_level = brute_force_kword(corpus, index, q, w)
            if resp.doc_only:
                assert set(resp.doc.tolist()) == doc_level, r
            else:
                assert set(zip(resp.doc.tolist(), resp.pos.tolist())) \
                    == positional, r
            continue
        a_sc, d_sc, d_lvl = brute_force_kword_ranked(corpus, index, q, w)
        if resp.doc_only:
            assert set(resp.doc.tolist()) == d_lvl, r
            continue
        anchors = dict(zip(zip(resp.doc.tolist(), resp.pos.tolist()),
                           resp.anchor_scores.tolist()))
        assert set(anchors) == set(a_sc), r
        for k, v in anchors.items():
            assert abs(v - a_sc[k]) <= 1e-4 * max(1.0, abs(a_sc[k])), (r, k)
        for d, s in zip(resp.doc_ids.tolist(), resp.doc_scores.tolist()):
            assert abs(s - d_sc[d]) <= 1e-4 * max(1.0, abs(d_sc[d])), (r, d)


@pytest.mark.parametrize("rank", [False, True])
def test_port_kword_oracles_equal_reference(small_world, port_world,
                                            kword_queries, rank):
    for q, w, _ in kword_queries[:6]:
        if rank:
            want = ref_brute_force_kword_ranked(
                small_world["corpus"], small_world["index"], q, w)
            got = brute_force_kword_ranked(port_world["corpus"],
                                           port_world["index"], q, w)
        else:
            want = ref_brute_force_kword(small_world["corpus"],
                                         small_world["index"], q, w)
            got = brute_force_kword(port_world["corpus"], port_world["index"],
                                    q, w)
        assert got == want, (q, w)
