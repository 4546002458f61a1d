"""Quickstart on the PyTorch/CUDA port: build the paper's additional
indexes over a synthetic corpus and run the four query types against them
— then rank a word-set query by proximity relevance
(SearchRequest(rank=True)).  The counterpart of examples/quickstart.py,
on the card unless `--device cpu`.

    PYTHONPATH=src python examples/torch_quickstart.py [--docs 400] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (AdditionalIndexEngine, CorpusConfig,
                              LexiconConfig, MODE_KWORD, MODE_NEAR,
                              MODE_PHRASE, OrdinaryEngine, SearchRequest,
                              SegmentManager, build_all, corpus_batches,
                              generate_corpus, make_lexicon_and_analyzer)
from repro_torch.core.executor import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--docs", type=int, default=400)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    lex_cfg = LexiconConfig(n_surface=20_000, n_base=15_000, n_stop=400,
                            n_frequent=1200, seed=0)
    lex, ana = make_lexicon_and_analyzer(lex_cfg)
    corpus = generate_corpus(lex_cfg, CorpusConfig(n_docs=args.docs, seed=0))
    print(f"corpus: {corpus.n_docs} docs, {corpus.n_tokens} tokens "
          f"({device})")

    index = build_all(corpus, lex, ana)
    for k, v in index.size_report().items():
        print(f"  {k}: {v:,}")

    engine = AdditionalIndexEngine(index, device=device)
    ordinary = OrdinaryEngine(index, device=device)

    # take a phrase straight out of a document (the paper's procedure)
    rng = np.random.default_rng(3)
    doc = int(rng.integers(corpus.n_docs))
    toks = corpus.doc(doc)
    start = int(rng.integers(len(toks) - 12))
    phrase = toks[start:start + 4].tolist()
    word_set = toks[start:start + 8:2].tolist()

    for req in (SearchRequest(phrase, mode=MODE_PHRASE),
                SearchRequest(word_set, mode=MODE_NEAR)):
        plan = engine.plan_request(req)
        r = engine.search(req)
        r0 = ordinary.search(req)
        types = [sp.qtype for sp in plan.subplans]
        print(f"\nquery={list(req.surface_ids)} mode={req.mode} types={types}")
        print(f"  additional-index engine: {len(r.doc)} hits, "
              f"{r.postings_read:,} postings read"
              + (" (doc-level fallback)" if r.doc_only else ""))
        print(f"  ordinary inverted index: {len(r0.doc)} hits, "
              f"{r0.postings_read:,} postings read")
        print(f"  postings saved: {r0.postings_read / max(r.postings_read, 1):.1f}x")
        assert doc in set(r.doc.tolist())
    print("\nsource document found by every query — index verified.")

    # ranked top-k: proximity relevance from the SAME postings (zero extra
    # reads) — tighter word sets and repeated matches rank first
    ranked = engine.search(SearchRequest(word_set, mode=MODE_NEAR, rank=True,
                                         top_k=5))
    print(f"\nranked word-set query (top {len(ranked.hits)} of "
          f"{len(np.unique(ranked.doc))} docs, "
          f"{ranked.postings_read:,} postings read):")
    for hit in ranked.hits:
        print(f"  doc {hit.doc}: score {hit.score:.3f}, "
              f"{len(hit.positions)} anchors, subplans {hit.subplans}")
    assert ranked.hits[0].doc == doc or doc in {h.doc for h in ranked.hits}

    # K-word proximity (arXiv:2009.02684): every query word inside ONE
    # (window + 1)-wide span, any order — the planner covers stop slots
    # with multi-component-key lookups instead of full stop posting scans
    kword = toks[start:start + 5].tolist()
    kreq = SearchRequest(kword, mode=MODE_KWORD, window=8)
    kr = engine.search(kreq)
    kr0 = ordinary.search(kreq)
    print(f"\nkword query={kword} window=8: {len(kr.doc)} anchor hits, "
          f"{kr.postings_read:,} postings read "
          f"(ordinary plan: {kr0.postings_read:,} — "
          f"{kr0.postings_read / max(kr.postings_read, 1):.1f}x more)")
    assert doc in set(kr.doc.tolist())

    # incremental ingestion: the same corpus fed in batches through the
    # segment manager — each batch becomes an immutable segment, the
    # merger compacts them, and the union search stays identical to the
    # one-shot build at every generation
    mgr = SegmentManager(lex, ana, params=index.params, auto_merge=False,
                         device=device)
    try:
        for batch in corpus_batches(corpus, 4):
            gen = mgr.ingest(batch)
            print(f"\ningested {batch.n_docs} docs -> generation {gen}, "
                  f"{len(mgr.segments)} live segment(s), {mgr.n_docs} docs "
                  f"total")
        req = SearchRequest(phrase, mode=MODE_PHRASE)
        union = mgr.search_batch([req], plan_index=index)[0]
        assert np.array_equal(union.doc, engine.search(req).doc)
        mgr.merge_now()                   # compact 4 segments into 1
        merged = mgr.search_batch([req])[0]
        assert np.array_equal(merged.doc, engine.search(req).doc)
        print(f"after merge: {len(mgr.segments)} segment(s) — union and "
              f"merged results match the one-shot build")
    finally:
        mgr.close()


if __name__ == "__main__":
    main()
