"""The batched search path's spans and counters (`repro_torch.core.trace`)
on the CPU: after a batch the spans nest as the path does (a parent's
seconds hold its children's), the counters agree with the work (a D2H copy
per output of every step, the rows the tasks carried); under
`torch.profiler` each span is a `repro.<name>` range on the profiler's
timeline, nested the same way, one `repro.launch` per step, and no user
annotation (which would put a row on the device's timeline); with no
profiler recording no range is opened.  The same through the serve tier's
executor."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core.trace as trace_mod
from repro_torch.core import (AdditionalIndexEngine, CorpusConfig,
                              LexiconConfig, OrdinaryEngine, SearchRequest,
                              build_all, generate_corpus,
                              make_lexicon_and_analyzer)
from repro_torch.core.kword import KW_DEVICE_MAX_WINDOW
from repro_torch.core.trace import COUNTS, SPANS
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve.search_serve import SearchServe, SearchServeConfig

# the spans directly under `batch`
CHILDREN = ("plan", "rows", "bucket", "tensorize", "device", "scatter",
            "collect", "merge", "flex")
ENGINES = {"ordinary": OrdinaryEngine, "additional": AdditionalIndexEngine}


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    lc = LexiconConfig(n_surface=8000, n_base=6000, n_stop=150,
                       n_frequent=500, seed=3)
    lex, ana = make_lexicon_and_analyzer(lc)
    corpus = generate_corpus(lc, CorpusConfig(n_docs=40, mean_doc_len=300,
                                              seed=3))
    return {"corpus": corpus, "index": build_all(corpus, lex, ana)}


def _requests(corpus, rank: bool, n=16, seed=5):
    """Phrase and every-other-word near requests from indexed documents;
    unranked, also requests whose words no document has in that order (the
    doc-only fallback) and a K-word window too wide for the device (the
    flexible executor)."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        toks = corpus.doc(int(rng.integers(corpus.n_docs)))
        st = int(rng.integers(0, len(toks) - 10))
        k = int(rng.integers(3, 6))
        if len(out) % 2:
            out.append(SearchRequest(toks[st:st + k].tolist(), rank=rank))
        else:
            out.append(SearchRequest(toks[st:st + 2 * k:2].tolist(),
                                     mode="near", window=8, rank=rank))
    if not rank:
        t1, t2 = corpus.doc(1), corpus.doc(2)
        out += [SearchRequest([int(t1[3 + i]), int(t2[5 + i]), int(t1[7 + i])])
                for i in range(3)]
        out.append(SearchRequest(corpus.doc(4)[6:10].tolist(), mode="kword",
                                 window=KW_DEVICE_MAX_WINDOW + 5))
    return out


def _spy_rows(monkeypatch, ex):
    """The tasks `_build_tasks` makes for the next batch."""
    tasks = []
    real = ex._build_tasks

    def spy(plan_i, plan, out, ranked=False):
        start = len(out)
        ok = real(plan_i, plan, out, ranked=ranked)
        tasks.extend(out[start:])
        return ok
    monkeypatch.setattr(ex, "_build_tasks", spy)
    return tasks


def _assert_nested(ex, tasks, ranked: bool):
    s, c = ex.timings, ex.counts
    assert set(SPANS) <= set(s) and set(c) == set(COUNTS)
    assert s["tensorize"] >= s["h2d"] > 0
    assert s["device"] >= s["launch"] + s["d2h"]
    assert s["launch"] > 0 and s["d2h"] > 0
    assert s["batch"] >= sum(s[k] for k in CHILDREN)
    assert c["batches"] == 1
    assert c["steps"] >= c["buckets"] >= 1
    assert c["d2h_copies"] == (3 if ranked else 2) * c["steps"]
    assert c["h2d_copies"] >= 12 * c["steps"] and c["h2d_bytes"] > 0
    assert c["d2h_bytes"] > 0
    main = sum(len(t.rows) for t in tasks if not t.fallback)
    assert c["rows"] - c["fallback_rows"] == main
    assert c["fallback_rows"] <= sum(len(t.rows) for t in tasks
                                     if t.fallback)


@pytest.mark.parametrize("ranked", [False, True])
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_spans_nest_and_counters_agree(world, monkeypatch, kind, ranked):
    eng = ENGINES[kind](world["index"], device="cpu")
    tasks = _spy_rows(monkeypatch, eng.batch_executor)
    out = eng.search_batch(_requests(world["corpus"], ranked))
    ex = eng.batch_executor
    _assert_nested(ex, tasks, ranked)
    if not ranked:
        assert ex.counts["flex_plans"] == 1 and ex.timings["flex"] > 0
        if kind == "additional":
            assert any(r.used_fallback for r in out)
            assert ex.counts["fallback_rows"] > 0


def _ranges(prof):
    """(name, start, end, is_user_annotation) of the `repro.` ranges."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
             e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("repro.")]


def _inside(r, outer):
    return any(o[1] <= r[1] and r[2] <= o[2] for o in outer)


def test_profiler_ranges_nest_and_count_the_steps(world):
    eng = OrdinaryEngine(world["index"], device="cpu")
    reqs = _requests(world["corpus"], False)
    eng.search_batch(reqs)
    ex = eng.batch_executor
    steps = ex.counts["steps"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.search_batch(reqs)
    ranges = _ranges(prof)
    by = {}
    for r in ranges:
        by.setdefault(r[0], []).append(r)
    assert len(by["repro.batch"]) == 1
    assert len(by["repro.launch"]) == ex.counts["steps"] - steps
    assert len(by["repro.d2h"]) == len(by["repro.launch"])
    for r in by["repro.launch"] + by["repro.d2h"]:
        assert _inside(r, by["repro.device"])
    for r in by["repro.device"] + by["repro.h2d"]:
        assert _inside(r, by["repro.batch"])
    for r in by["repro.h2d"]:
        assert _inside(r, by["repro.tensorize"])
    # function scope: no range becomes a row of the device's timeline
    assert not any(r[3] for r in ranges)
    assert set(by) <= {"repro." + k for k in SPANS}


def test_no_range_is_opened_without_a_profiler(world, monkeypatch):
    eng = OrdinaryEngine(world["index"], device="cpu")
    reqs = _requests(world["corpus"], True)
    want = eng.search_batch(reqs)

    def refuse(*a, **kw):
        raise AssertionError("a profiler range opened with no profiler")
    monkeypatch.setattr(trace_mod, "_Range", refuse)
    got = eng.search_batch(reqs)
    for w, g in zip(want, got):
        assert np.array_equal(w.doc_ids, g.doc_ids)
        assert np.array_equal(w.doc_scores, g.doc_scores)


@pytest.mark.parametrize("ranked", [False, True])
def test_serve_executor_spans_nest(world, monkeypatch, ranked):
    cfg = SearchServeConfig(queries=16, postings_pad=4096, seed_pad=1024,
                            n_basic=1, n_expanded=1, n_stop=1, n_first=1,
                            n_multi=1)
    serve = SearchServe(world["index"], cfg,
                        make_host_mesh(data=1, model=1, device="cpu"))
    reqs = _requests(world["corpus"], ranked)
    want = AdditionalIndexEngine(world["index"],
                                 device="cpu").search_batch(reqs)
    tasks = _spy_rows(monkeypatch, serve.executor)
    got = serve.search_batch(reqs)
    ex = serve.executor
    _assert_nested(ex, tasks, ranked)
    assert ex.counts["steps"] == ex.slab_stats["steps"]
    for w, g in zip(want, got):
        assert np.array_equal(w.doc, g.doc) and np.array_equal(w.pos, g.pos)
