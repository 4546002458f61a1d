"""End-to-end serving driver on the PyTorch/CUDA port, through the serving
front door (repro_torch/serve/front.py): individual SearchRequests are
admitted, coalesced into deadline-bounded micro-batches, routed to shape
buckets, fanned out over replicated document shards
(dist/fault_tolerance.ShardDispatcher), and merged bit-identically to
`engine.search_batch` — with explicit SERVED_EXACT / SERVED_DEGRADED /
SHED statuses instead of silent failure when shards die.  The counterpart
of examples/search_serve.py, on the card unless `--device cpu`.

    PYTHONPATH=src python examples/torch_search_serve.py [--docs 300] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (AdditionalIndexEngine, CorpusConfig,
                              LexiconConfig, MODE_NEAR, SearchRequest,
                              build_all, generate_corpus,
                              make_lexicon_and_analyzer)
from repro_torch.core.executor import resolve_device
from repro_torch.dist.chaos import ChaosShard
from repro_torch.serve import FrontDoor, FrontDoorConfig, build_doc_shards


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    lex_cfg = LexiconConfig(n_surface=20_000, n_base=15_000, n_stop=400,
                            n_frequent=1200, seed=0)
    lex, ana = make_lexicon_and_analyzer(lex_cfg)
    corpus = generate_corpus(lex_cfg, CorpusConfig(n_docs=args.docs, seed=0))
    index = build_all(corpus, lex, ana)
    engine = AdditionalIndexEngine(index, device=device)

    # two replicated document shards behind the front door; generous
    # timeouts so first calls never read as stragglers
    backends, replicas = build_doc_shards(corpus, index, 2, replicate=True,
                                          device=device)
    chaos = [ChaosShard(b) for b in backends]
    front = FrontDoor(index, backends=chaos, replicas=replicas,
                      cfg=FrontDoorConfig(default_deadline_ms=600_000.0,
                                          shard_timeout_s=120.0,
                                          retry_backoff_ms=5.0))
    try:
        # individual queries from indexed documents — the front door does
        # the batching, not the client
        rng = np.random.default_rng(0)
        requests = []
        while len(requests) < 16:
            d = int(rng.integers(corpus.n_docs))
            toks = corpus.doc(d)
            if len(toks) < 10:
                continue
            st = int(rng.integers(len(toks) - 6))
            requests.append(SearchRequest(toks[st:st + 3].tolist()))

        tickets = [front.submit(r, client="example") for r in requests]
        results = [t.result() for t in tickets]
        st = front.stats
        print(f"front door ({device}): {st.submitted} submitted -> "
              f"{st.served_exact} exact in {st.batches} micro-batches, p99 "
              f"{st.percentile(99):.1f} ms")
        for i in range(4):
            r = results[i]
            pairs = list(zip(r.doc.tolist(), r.pos.tolist()))
            print(f"  q{i} {list(requests[i].surface_ids)}: {r.status}, "
                  f"shards {r.shards}, {len(r.doc)} hits, first: {pairs[:4]}")

        # SERVED_EXACT must agree with the engine bit-for-bit — including
        # the postings accounting, despite the doc-sharded backends
        wants = engine.search_batch(requests)
        assert all(np.array_equal(w.doc, r.doc)
                   and np.array_equal(w.pos, r.pos)
                   and w.postings_read == r.postings_read
                   for w, r in zip(wants, results))
        print("front == engine.search_batch on all queries")

        # a repeated query is a plan-signature cache hit
        again = front.search(requests[0], client="example")
        assert again.cached and again.status == "SERVED_EXACT"
        print(f"cache: repeat query served from cache "
              f"({front.stats.cache_hits} hit)")

        # ranked serving through the same door: proximity-scored top-k
        # DocHits, bit-identical to the engine's ranked batch
        ranked_reqs = [SearchRequest(r.surface_ids, mode=MODE_NEAR, rank=True,
                                     top_k=3) for r in requests[:4]]
        ranked = front.search_batch(ranked_reqs, client="example")
        ranked_eng = engine.search_batch(ranked_reqs)
        assert all(np.array_equal(w.doc_ids, g.doc_ids)
                   and np.array_equal(w.doc_scores, g.doc_scores)
                   for w, g in zip(ranked_eng, ranked))
        print("ranked front == ranked engine; sample top-k:")
        for req, r in zip(ranked_reqs, ranked[:2]):
            print(f"  {list(req.surface_ids)}: "
                  f"{[(h.doc, round(h.score, 3)) for h in r.hits]}")

        # kill a primary: the replica absorbs the re-dispatch, still EXACT
        # (a FRESH query — a repeat would be a cache hit and dodge the
        # shards)
        chaos[1].set(fail=True)
        toks = corpus.doc(7)
        fresh = SearchRequest(toks[4:7].tolist())
        rescued = front.search(fresh, client="example")
        assert rescued.status == "SERVED_EXACT"
        print(f"replica rescue: primary 1 down, replica answered "
              f"({front.dispatcher.stats.redispatched} re-dispatched) -> "
              f"{rescued.status}")
        chaos[1].set()
    finally:
        front.close()


if __name__ == "__main__":
    main()
