"""The port's serving front door (`repro_torch.serve.front`), shard
dispatcher (`repro_torch.dist.fault_tolerance`) and fault injection
(`repro_torch.dist.chaos`) on the CPU: the scenarios of tests/test_front.py,
one for one, under the same names.

Parity anchor: ONE reference `AdditionalIndexEngine.search_batch` holding
every request of the file (phrase, near, ranked and K-word), run as
tests/test_front.py runs it.  The port's single-shard and 4-shard
`FrontDoor` answers equal it bit for bit (docs, positions, fallback flags,
ranked float32 scores and the postings_read accounting).  The chaos
scenarios — injected shard failures, shard stalls past the dispatcher
timeout, queue floods, clock skew — hold the same two invariants: every
ticket resolves with exactly one explicit status and the stats ledger
balances, and every non-degraded answer equals the anchor (or, for the
over-cap plan, the port's own engine, which tests/test_torch_engine.py
holds to the reference).  No jit runs on the port side, so stalls and
timeouts are short; every front and dispatcher is closed, and its pool
joined, before a test ends.
"""
import dataclasses
import time

import numpy as np
import pytest

from repro.core import SearchRequest as RefRequest
from repro_torch.core import AdditionalIndexEngine
from repro_torch.core.api import (MODE_NEAR, MODE_PHRASE,
                                  STATUS_SERVED_DEGRADED, STATUS_SERVED_EXACT,
                                  STATUS_SHED, SearchRequest)
from repro_torch.dist.chaos import ChaosShard, SkewedClock, flood
from repro_torch.dist.fault_tolerance import ShardDispatcher, merge_topk
from repro_torch.serve.front import (FrontDoor, FrontDoorConfig, ShardBackend,
                                     build_doc_shards, merge_shard_responses)
from test_torch_ranked import carried_world

# no compiles on the port side: only a real hang outlasts this
SLOW = 60.0
FAST_CFG = dict(default_deadline_ms=600_000.0, shard_timeout_s=SLOW)


def _requests(corpus, n=22, ranked_every=3, seed=11):
    """tests/test_front.py's phrase / near / ranked mix with known source
    docs (so hits are nonempty), plus two K-word requests (one ranked)."""
    rng = np.random.default_rng(seed)
    reqs = []
    d = 0
    while len(reqs) < n:
        d = (d + 7) % corpus.n_docs
        toks = np.asarray(corpus.doc(d))
        if len(toks) < 12:
            continue
        st = int(rng.integers(0, len(toks) - 8))
        k = int(rng.integers(2, 4))
        i = len(reqs)
        if ranked_every and i % ranked_every == 2:
            reqs.append(SearchRequest(tuple(int(x) for x in toks[st:st + k]),
                                      mode=MODE_PHRASE, rank=True, top_k=10))
        elif i % 2:
            reqs.append(SearchRequest(
                tuple(int(x) for x in toks[st:st + 2 * k:2]),
                mode=MODE_NEAR, window=6))
        else:
            reqs.append(SearchRequest(tuple(int(x) for x in toks[st:st + k]),
                                      mode=MODE_PHRASE))
    for rank, d in ((False, 5), (True, 40)):
        toks = corpus.doc(d)
        reqs.append(SearchRequest(tuple(int(x) for x in toks[6:10]),
                                  mode="kword", window=5, rank=rank))
    return reqs


def _assert_identical(ref, got):
    assert np.array_equal(ref.doc, got.doc)
    assert np.array_equal(ref.pos, got.pos)
    assert ref.postings_read == got.postings_read
    assert ref.used_fallback == got.used_fallback
    assert ref.doc_only == got.doc_only
    assert ref.subplan_types == got.subplan_types
    assert ref.ranked == got.ranked
    if ref.ranked:
        assert np.array_equal(ref.doc_ids, got.doc_ids)
        assert np.array_equal(ref.doc_scores, got.doc_scores)
        assert np.array_equal(ref.anchor_scores, got.anchor_scores)


def _ledger_balances(front):
    st = front.stats
    assert st.responded == st.submitted, \
        f"silent drop: {st.submitted} submitted, {st.responded} responded"


def _close(front_or_dispatcher):
    """Close, then join the worker pool: a stalled shard call must not
    outlive its test."""
    front_or_dispatcher.close()
    d = getattr(front_or_dispatcher, "dispatcher", front_or_dispatcher)
    d._pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def shard_world(small_world):
    world = carried_world(small_world)
    corpus, index = world["corpus"], world["index"]
    backends, replicas = build_doc_shards(corpus, index, 4, replicate=True,
                                          device="cpu")
    reqs = _requests(corpus)
    for b in backends + replicas:      # warm: no first call near a timeout
        b(reqs[:4])
    return {"corpus": corpus, "index": index, "engine": world["additional"],
            "backends": backends, "replicas": replicas,
            "requests": reqs}


@pytest.fixture(scope="module")
def reference(small_world, shard_world):
    """The reference engine's answers to every request of the file, in one
    batch (its jit compiles once per shape bucket)."""
    reqs = [RefRequest(**{f.name: getattr(r, f.name)
                          for f in dataclasses.fields(r)
                          if f.name != "ranking"})
            for r in shard_world["requests"]]
    return small_world["engine"].search_batch(reqs)


# ---------------------------------------------------------------------------
# parity: SERVED_EXACT == the reference engine's search_batch, bit for bit
# ---------------------------------------------------------------------------


def test_front_single_shard_bit_identical(shard_world, reference):
    front = FrontDoor(shard_world["index"], cfg=FrontDoorConfig(**FAST_CFG),
                      device="cpu")
    try:
        got = front.search_batch(shard_world["requests"])
        for ref, g in zip(reference, got):
            assert g.status == STATUS_SERVED_EXACT
            assert g.shards == (0,)
            _assert_identical(ref, g)
        assert any(g.ranked and len(g.doc_ids) for g in got)
        assert any(g.request.mode == "kword" and len(g.doc) for g in got)
        _ledger_balances(front)
        assert front.stats.shed == 0
    finally:
        _close(front)


def test_front_multi_shard_bit_identical(shard_world, reference):
    front = FrontDoor(shard_world["index"], backends=shard_world["backends"],
                      cfg=FrontDoorConfig(cache_capacity=0, **FAST_CFG))
    try:
        got = front.search_batch(shard_world["requests"])
        for ref, g in zip(reference, got):
            assert g.status == STATUS_SERVED_EXACT
            assert g.shards == (0, 1, 2, 3)
            _assert_identical(ref, g)
        _ledger_balances(front)
    finally:
        _close(front)


def test_front_merge_refuses_a_dropped_hit(shard_world, reference):
    """The equality check can see a fault: a merge fed one shard response
    with a hit removed no longer equals the anchor."""
    i, req = next((i, r) for i, r in enumerate(shard_world["requests"])
                  if not r.rank and len(reference[i].doc) >= 2)
    plan = shard_world["engine"].plan_request(req)
    per_shard = [(s, b([req])[0])
                 for s, b in enumerate(shard_world["backends"])]
    _assert_identical(reference[i],
                      merge_shard_responses(req, plan, per_shard))
    s, r = next((s, r) for s, r in per_shard
                if len(r.doc) and not r.doc_only)
    per_shard[s] = (s, dataclasses.replace(r, doc=r.doc[1:], pos=r.pos[1:]))
    with pytest.raises(AssertionError):
        _assert_identical(reference[i],
                          merge_shard_responses(req, plan, per_shard))


def test_front_flex_overflow_exact(shard_world):
    """A plan wider than the batched executor's caps routes through the flex
    bucket and still comes back SERVED_EXACT + bit-identical."""
    from repro_torch.core.batch_executor import G_CAP
    corpus, eng = shard_world["corpus"], shard_world["engine"]
    req = None
    for d in range(corpus.n_docs):
        toks = corpus.doc(d)
        for st in range(0, max(len(toks) - G_CAP - 3, 0), 4):
            q = toks[st:st + G_CAP + 3].tolist()
            plan = eng.plan(q, mode=MODE_PHRASE)
            # stop words become checks, not groups: need a window whose plan
            # really carries > G_CAP AND-groups in one subplan
            if any(sp.supported and len(sp.groups) > G_CAP
                   for sp in plan.subplans):
                req = SearchRequest(q, mode=MODE_PHRASE)
                break
        if req is not None:
            break
    assert req is not None, "no >G_CAP-group windows found"
    ref = eng.search_batch([req])[0]
    front = FrontDoor(shard_world["index"], cfg=FrontDoorConfig(**FAST_CFG),
                      device="cpu")
    try:
        got = front.search(req)
        assert got.status == STATUS_SERVED_EXACT
        _assert_identical(ref, got)
        assert front.stats.flex_routed >= 1
    finally:
        _close(front)


def test_front_cache_hit(shard_world, reference):
    front = FrontDoor(shard_world["index"],
                      cfg=FrontDoorConfig(cache_capacity=16, **FAST_CFG),
                      device="cpu")
    try:
        req = shard_world["requests"][0]
        first = front.search(req)
        assert not first.cached
        again = front.search(req)
        assert again.cached and again.status == STATUS_SERVED_EXACT
        assert front.stats.cache_hits == 1
        _assert_identical(first, again)
        _assert_identical(reference[0], again)
    finally:
        _close(front)


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def test_front_rate_limit_sheds_explicitly(shard_world):
    front = FrontDoor(shard_world["index"],
                      cfg=FrontDoorConfig(rate_per_s=0.001, rate_burst=3,
                                          cache_capacity=0, **FAST_CFG),
                      device="cpu")
    try:
        reqs = shard_world["requests"][:12]
        tickets = flood(front, reqs, client="greedy")
        resps = [t.result() for t in tickets]
        shed = [r for r in resps if r.status == STATUS_SHED]
        ok = [r for r in resps if r.status != STATUS_SHED]
        assert len(ok) == 3 and len(shed) == 9
        assert all(r.shed_reason == "rate_limited" for r in shed)
        # a second client has its own bucket
        other = front.search(reqs[0], client="polite")
        assert other.status == STATUS_SERVED_EXACT
        _ledger_balances(front)
    finally:
        _close(front)


def test_front_queue_flood_no_silent_drops(shard_world, reference):
    """8x-capacity flood while a chaos shard pins the dispatcher: every
    ticket resolves; overflow is shed with reason queue_full; everything
    that was admitted is served bit-exactly once the stall clears."""
    chaos = ChaosShard(ShardBackend(shard_world["index"], device="cpu"),
                       stall_s=0.3)
    front = FrontDoor(shard_world["index"], backends=[chaos],
                      cfg=FrontDoorConfig(max_queue=8, max_batch=4,
                                          cache_capacity=0, **FAST_CFG))
    try:
        reqs = (shard_world["requests"] * 3)[:64]    # 8x queue capacity
        tickets = flood(front, reqs, wait=False)
        resps = [t.result(timeout=SLOW) for t in tickets]
        statuses = {}
        for r in resps:
            statuses[(r.status, r.shed_reason)] = \
                statuses.get((r.status, r.shed_reason), 0) + 1
        assert statuses.get((STATUS_SHED, "queue_full"), 0) > 0
        served = [i for i, r in enumerate(resps)
                  if r.status == STATUS_SERVED_EXACT]
        assert served, statuses
        for i in served:
            _assert_identical(reference[i % len(reference)], resps[i])
        # the ledger balances: nothing hung, nothing vanished
        _ledger_balances(front)
        assert front.stats.shed == statuses.get((STATUS_SHED, "queue_full"), 0)
    finally:
        chaos.set()
        _close(front)


def test_front_clock_skew_deadline_shed(shard_world):
    """Queued requests admitted under one clock become unmeetable when the
    clock steps forward (NTP jump / long pause): they shed with reason
    deadline instead of burning the whole batch's budget."""
    clock = SkewedClock()
    stall = ChaosShard(ShardBackend(shard_world["index"], device="cpu"),
                       stall_s=0.5)
    front = FrontDoor(shard_world["index"], backends=[stall],
                      cfg=FrontDoorConfig(default_deadline_ms=5000.0,
                                          shard_timeout_s=SLOW, max_batch=2,
                                          cache_capacity=0),
                      clock=clock)
    try:
        reqs = shard_world["requests"][:8]
        tickets = [front.submit(r) for r in reqs]
        clock.skew_s = 30.0          # every queued deadline is now in the past
        resps = [t.result(timeout=SLOW) for t in tickets]
        assert any(r.status == STATUS_SHED and r.shed_reason == "deadline"
                   for r in resps)
        assert all(r.status in (STATUS_SHED, STATUS_SERVED_EXACT,
                                STATUS_SERVED_DEGRADED) for r in resps)
        _ledger_balances(front)
    finally:
        stall.set()
        _close(front)


# ---------------------------------------------------------------------------
# degradation: shard failure, stall, replica rescue
# ---------------------------------------------------------------------------


def test_front_replica_rescues_failed_primary(shard_world, reference):
    """Primary shard 1 fails hard; its replica absorbs the re-dispatch and
    the responses stay SERVED_EXACT and bit-identical."""
    backends = [ChaosShard(b) for b in shard_world["backends"]]
    backends[1].set(fail=True)
    front = FrontDoor(shard_world["index"], backends=backends,
                      replicas=shard_world["replicas"],
                      cfg=FrontDoorConfig(cache_capacity=0, **FAST_CFG))
    try:
        reqs = shard_world["requests"][:16]
        got = front.search_batch(reqs)
        for ref, g in zip(reference[:16], got):
            assert g.status == STATUS_SERVED_EXACT
            assert g.shards == (0, 1, 2, 3)
            _assert_identical(ref, g)
        assert front.dispatcher.stats.redispatched > 0
        assert backends[1].calls > 0
        _ledger_balances(front)
    finally:
        _close(front)


def test_front_dead_shard_degrades_explicitly(shard_world, reference):
    """Shard 2 stalls past the dispatcher timeout with NO replica: responses
    degrade explicitly — status SERVED_DEGRADED, contributing shards listed,
    and no doc from the dead shard's range is fabricated."""
    backends = [ChaosShard(b) for b in shard_world["backends"]]
    backends[2].set(stall_s=2.5)
    lo = shard_world["backends"][2].doc_base
    hi = lo + shard_world["backends"][2].n_docs
    front = FrontDoor(shard_world["index"], backends=backends,
                      cfg=FrontDoorConfig(default_deadline_ms=600_000.0,
                                          shard_timeout_s=1.0, max_retries=1,
                                          retry_backoff_ms=5.0,
                                          cache_capacity=0))
    try:
        reqs = shard_world["requests"][:8]
        got = front.search_batch(reqs)
        for ref, g in zip(reference[:8], got):
            assert g.status == STATUS_SERVED_DEGRADED
            assert g.shed_reason == "shards"
            assert g.shards == (0, 1, 3)
            docs = g.doc[g.doc >= 0]
            assert not np.any((docs >= lo) & (docs < hi))
            # the live shards' contribution is exactly the reference minus
            # the dead range
            keep = (ref.doc < lo) | (ref.doc >= hi)
            if not ref.doc_only and not g.doc_only:
                assert np.array_equal(ref.doc[keep], g.doc)
                assert np.array_equal(ref.pos[keep], g.pos)
        # bounded retry actually ran, and never un-degraded the result
        assert front.stats.retries > 0
        _ledger_balances(front)
        assert front.stats.served_degraded == len(reqs)
    finally:
        backends[2].set()
        _close(front)


def test_front_all_shards_down_still_responds(shard_world):
    chaos = ChaosShard(ShardBackend(shard_world["index"], device="cpu"),
                       fail=True)
    front = FrontDoor(shard_world["index"], backends=[chaos],
                      cfg=FrontDoorConfig(default_deadline_ms=600_000.0,
                                          shard_timeout_s=2.0, max_retries=1,
                                          retry_backoff_ms=5.0,
                                          cache_capacity=0))
    try:
        got = front.search_batch(shard_world["requests"][:4])
        for g in got:
            assert g.status == STATUS_SERVED_DEGRADED
            assert g.shed_reason == "no_shards"
            assert g.shards == () and len(g.doc) == 0
        _ledger_balances(front)
    finally:
        chaos.set()
        _close(front)


# ---------------------------------------------------------------------------
# ShardDispatcher merge path under concurrent replica failure + timeout,
# against the doc-sharded backends
# ---------------------------------------------------------------------------


def test_dispatcher_concurrent_stall_and_fail(shard_world):
    """Three concurrent fault modes in ONE dispatch: shard 0 healthy,
    shard 1 stalls past timeout but its replica is healthy (rescued),
    shard 2 fails hard AND its replica fails (lost)."""
    b = shard_world["backends"]
    primaries = [ChaosShard(b[0]), ChaosShard(b[1], stall_s=2.5),
                 ChaosShard(b[2], fail=True)]
    replicas = [ChaosShard(shard_world["replicas"][0]),
                ChaosShard(shard_world["replicas"][1]),
                ChaosShard(shard_world["replicas"][2], fail=True)]
    d = ShardDispatcher(primaries, replica_fns=replicas, timeout=1.0)
    reqs = shard_world["requests"][:6]
    try:
        out = d.dispatch(reqs)
        assert out[0] is not None
        assert out[1] is not None          # replica rescued the straggler
        assert out[2] is None              # primary AND replica down
        assert replicas[1].calls == 1 and replicas[2].calls == 1
        assert d.stats.redispatched == 2 and d.stats.failed == 1
        # the rescued shard's answers match a direct call to the replica
        direct = shard_world["replicas"][1](reqs)
        for x, y in zip(out[1], direct):
            _assert_identical(x, y)
        # subset re-dispatch heals the lost shard once chaos clears
        primaries[2].set()
        again = d.dispatch(reqs, shards=[2])
        assert again[2] is not None and again[0] is None and again[1] is None
    finally:
        primaries[1].set()
        _close(d)


def test_dispatcher_merge_topk_real_ranked_outputs(shard_world, reference):
    """merge_topk over real per-shard ranked outputs equals the global
    ranked doc list (scores are per-doc sums, disjoint across doc shards)."""
    i, req = next((i, r) for i, r in enumerate(shard_world["requests"])
                  if r.rank)
    per_shard = [b([req])[0] for b in shard_world["backends"]]
    # positional hits win over shard-local doc-only fallbacks (the same
    # have_pos gating merge_shard_responses applies)
    rows = [np.stack([r.doc_scores.astype(np.float64),
                      r.doc_ids.astype(np.float64)], axis=1)
            for r in per_shard
            if not r.doc_only and r.doc_ids is not None and len(r.doc_ids)]
    merged = merge_topk(rows, k=req.top_k)
    ref = reference[i]
    assert len(merged) == len(ref.doc_ids) > 0
    np.testing.assert_allclose(merged[:, 0],
                               np.sort(ref.doc_scores)[::-1], rtol=0)
    assert set(merged[:, 1].astype(int)) == set(int(x) for x in ref.doc_ids)


# ---------------------------------------------------------------------------
# late-shard backfill
# ---------------------------------------------------------------------------


def test_front_late_shard_backfills_cache(shard_world, reference):
    """A shard that answers AFTER the dispatch timeout degrades the delivered
    response — but its work is not thrown away: the straggler's result
    re-merges into the cache, and the next identical query is SERVED_EXACT
    and bit-identical to the unsharded engine."""
    backends = [ChaosShard(b) for b in shard_world["backends"]]
    backends[1].set(stall_s=2.0)
    front = FrontDoor(shard_world["index"], backends=backends,
                      cfg=FrontDoorConfig(default_deadline_ms=600_000.0,
                                          shard_timeout_s=1.0, max_retries=0,
                                          cache_capacity=16))
    try:
        req = shard_world["requests"][0]
        got = front.search(req)
        assert got.status == STATUS_SERVED_DEGRADED
        assert got.shed_reason == "shards"
        assert got.shards == (0, 2, 3)
        # the straggler finishes ~1 s later and backfills the cache
        deadline = time.monotonic() + SLOW
        while front.stats.backfilled < 1:
            assert time.monotonic() < deadline, "backfill never landed"
            time.sleep(0.02)
        again = front.search(req)
        assert again.cached and again.status == STATUS_SERVED_EXACT
        assert again.shards == (0, 1, 2, 3)
        _assert_identical(reference[0], again)
        assert front.stats.stale_cache_hits == 0
        _ledger_balances(front)
    finally:
        backends[1].set()
        _close(front)


# ---------------------------------------------------------------------------
# open loop: offered load through the front door, shed_rate == 0
# ---------------------------------------------------------------------------


def test_front_open_loop_smoke_no_shedding(shard_world):
    """Paced offered load at smoke scale: everything served exactly, nothing
    shed, p99 under a generous deadline."""
    front = FrontDoor(shard_world["index"],
                      cfg=FrontDoorConfig(default_deadline_ms=30_000.0,
                                          shard_timeout_s=SLOW,
                                          cache_capacity=0),
                      device="cpu")
    try:
        reqs = shard_world["requests"][:24]
        front.search_batch(reqs)     # warm-up outside the measured window
        front.stats = type(front.stats)()
        for r in reqs:
            front.submit(r)
            time.sleep(0.005)
        deadline = time.monotonic() + SLOW
        while front.stats.responded < front.stats.submitted:
            assert time.monotonic() < deadline, "front door hung"
            time.sleep(0.01)
        assert front.stats.submitted == len(reqs)
        assert front.stats.shed == 0
        assert front.stats.served_degraded == 0
        assert front.stats.percentile(99) <= 30_000.0
        _ledger_balances(front)
    finally:
        _close(front)


def test_front_queue_wait_one_entry_per_dispatched_ticket(shard_world):
    """Each dispatched ticket leaves its queue wait (arrival to its batch's
    dispatch): one entry a ticket, in queue order, between 0 and the
    ticket's latency."""
    front = FrontDoor(shard_world["index"],
                      cfg=FrontDoorConfig(cache_capacity=0, **FAST_CFG),
                      device="cpu")
    try:
        tickets = []
        for r in shard_world["requests"][:12]:
            tickets.append(front.submit(r))
            time.sleep(0.002)
        resps = [t.result(SLOW) for t in tickets]
    finally:
        _close(front)
    st = front.stats
    assert st.shed == 0 and st.batches >= 1
    assert len(st.queue_wait_ms) == len(tickets)
    for wait, resp in zip(st.queue_wait_ms, resps):
        assert 0.0 <= wait <= resp.latency_ms


def test_front_concurrent_clients_ledger_balances(shard_world, reference):
    """More submitting threads than cores, with a short switch interval:
    the stats ledger, the cache and the token buckets are shared state, and
    a lost update would unbalance the ledger or hang a ticket."""
    import sys
    import threading
    reqs = shard_world["requests"]
    n_threads = 16
    front = FrontDoor(shard_world["index"],
                      cfg=FrontDoorConfig(cache_capacity=8, rate_per_s=1e6,
                                          rate_burst=1000, **FAST_CFG),
                      device="cpu")
    out = [None] * n_threads
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(k):
            out[k] = front.search_batch(reqs, client=f"c{k % 4}",
                                        timeout=SLOW)
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SLOW)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        _close(front)
    st = front.stats
    assert st.submitted == st.responded == n_threads * len(reqs)
    assert st.served_exact == st.submitted
    assert len(st.latencies_ms) == st.submitted
    for got in out:
        for ref, g in zip(reference, got):
            assert g.status == STATUS_SERVED_EXACT
            _assert_identical(ref, g)


def test_front_runs_on_the_card_unless_cpu_is_asked(shard_world, monkeypatch):
    """Every entry point defaults to the card: without CUDA they raise
    instead of quietly running on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    index = shard_world["index"]
    for fn in (lambda: ShardBackend(index),
               lambda: FrontDoor(index),
               lambda: AdditionalIndexEngine(index, doc_base=5)):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


def test_poisson_open_loop_keeps_its_schedule():
    """The open loop's arrivals keep their Poisson schedule even when each
    submit is slow: the number offered is the number of arrival times from
    `default_rng(seed)` inside the window, not fewer, and the requests
    cycle in order."""
    from repro_torch.launch.serve import poisson_open_loop

    class _Done:
        def __init__(self, request):
            self.request = request

        def result(self, timeout=None):
            return self.request

    class _SlowFront:
        def submit(self, request):
            time.sleep(0.002)          # as slow as the mean gap below
            return _Done(request)

    qps, duration = 500.0, 0.5
    rng = np.random.default_rng(1)
    t, want = 0.0, 0
    while t < duration:
        want += 1
        t += rng.exponential(1.0 / qps)
    reqs = ["a", "b", "c"]
    out, offered_s = poisson_open_loop(_SlowFront(), reqs, qps, duration)
    assert len(out) == want
    assert out == [reqs[i % 3] for i in range(want)]
    assert duration * 0.9 <= offered_s <= duration + 0.2


def test_launch_counter_is_exact_across_threads():
    """Shards of the front door launch kernels from the dispatcher's pool
    threads at once: a wrapper's count is raised under the counters' lock,
    so a thread waits for it and no update is lost."""
    import threading

    from repro_torch.kernels import build

    def wrapper():
        pass

    wrapper.launches = 0
    with build._LAUNCH_LOCK:
        th = threading.Thread(target=build.count_launch, args=(wrapper,))
        th.start()
        th.join(0.2)
        assert th.is_alive() and wrapper.launches == 0
    th.join(5.0)
    assert not th.is_alive() and wrapper.launches == 1
    threads = [threading.Thread(
        target=lambda: [build.count_launch(wrapper) for _ in range(2000)])
        for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert wrapper.launches == 1 + 8 * 2000
