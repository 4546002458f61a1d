"""Serving launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --mode search --queries 32
    PYTHONPATH=src python -m repro_torch.launch.serve --mode search --ranked --top-k 5
    PYTHONPATH=src python -m repro_torch.launch.serve --mode search --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --mode search --qps 50 --duration 5
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --arch llama3-8b
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --arch granite-moe-1b-a400m

  search — (the default) build the paper's indexes over a synthetic corpus
           (300 documents) and time a closed loop: one warm-up batch, then
           one timed batch of `--queries` requests through `SearchServe`
           on a one-rank mesh (launch/mesh.py): the reference's
           `serve_search`.  `--ranked` asks near queries with proximity
           ranking.  Passing `--qps` switches to an OPEN loop: Poisson
           arrivals at that rate for `--duration` seconds through the
           serving front door (serve/front.py), each request with a
           `--deadline-ms` budget, reporting the per-request p50 / p95 /
           p99 a client-side SLO would see and the exact / degraded / shed
           counts (a closed loop hides queueing delay: it offers the next
           request only after the previous one finished).
  lm     — greedy decode from the architecture's smoke config (dense or
           MoE) with the KV cache decode step (`decode_step`, attention
           through the flash-decode kernel), batch 2, cache of 128
           positions: the reference's `serve_lm`.

Both run on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.executor import resolve_device
from repro_torch.models import transformer as tfm


def _search_world(n_queries: int, ranked: bool, top_k: int):
    """The launcher's synthetic serving world: lexicon, corpus, full index
    set, and a repeatable workload of `n_queries` requests (phrase queries
    of 3 consecutive words, or ranked near queries of every other word)."""
    from repro_torch.core import (CorpusConfig, LexiconConfig, MODE_NEAR,
                                  SearchRequest, build_all, generate_corpus,
                                  make_lexicon_and_analyzer)
    lex_cfg = LexiconConfig(n_surface=20_000, n_base=15_000, n_stop=400,
                            n_frequent=1200, seed=0)
    lex, ana = make_lexicon_and_analyzer(lex_cfg)
    corpus = generate_corpus(lex_cfg, CorpusConfig(n_docs=300, seed=0))
    index = build_all(corpus, lex, ana)
    rng = np.random.default_rng(0)
    requests = []
    while len(requests) < n_queries:
        d = int(rng.integers(corpus.n_docs))
        toks = corpus.doc(d)
        if len(toks) < 10:
            continue
        st = int(rng.integers(len(toks) - 6))
        if ranked:
            requests.append(SearchRequest(toks[st:st + 6:2].tolist(),
                                          mode=MODE_NEAR, rank=True,
                                          top_k=top_k))
        else:
            requests.append(SearchRequest(toks[st:st + 3].tolist()))
    return index, requests


def serve_search(n_queries: int, ranked: bool = False, top_k: int = 10,
                 device=None) -> list:
    """Closed-loop serving of the synthetic world's requests: one warm-up
    batch, one timed batch; returns the timed batch's responses."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve.search_serve import SearchServe, SearchServeConfig
    mesh = make_host_mesh(data=1, model=1, device=device)
    index, requests = _search_world(n_queries, ranked, top_k)
    cfg = SearchServeConfig(queries=n_queries, postings_pad=8192,
                            seed_pad=2048, n_basic=1, n_expanded=1,
                            n_stop=1, n_first=1, n_multi=1)
    serve = SearchServe(index, cfg, mesh)
    serve.search_batch(requests)                    # warm
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else lambda: None)
    sync()
    t0 = time.perf_counter()
    results = serve.search_batch(requests)
    sync()
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(mesh.device)
             if mesh.device.type == "cuda" else "CPU")
    label = "ranked top-%d" % top_k if ranked else "phrase"
    print(f"[serve/search] {n_queries} {label} queries in {dt * 1e3:.1f} ms "
          f"({dt / max(n_queries, 1) * 1e6:.0f} us/query, {where}, "
          f"{serve.n_dp} doc shard(s)); "
          f"hit counts: {[len(r.doc) for r in results[:8]]}...")
    if ranked:
        r = next((r for r in results if r.doc_ids is not None
                  and len(r.doc_ids)), None)
        if r is not None:
            print(f"[serve/search] sample ranking: "
                  f"{[(h.doc, round(h.score, 3)) for h in r.hits[:5]]}")
    return results


def poisson_open_loop(front, requests, qps: float, duration: float,
                      seed: int = 1, timeout: float | None = None):
    """Offers `requests` (cycled) to `front` at Poisson arrival times of
    rate `qps`, drawn from `default_rng(seed)`, for `duration` seconds, and
    does not wait for an answer before the next arrival; then waits for
    every ticket (each at most `timeout` seconds).  Arrivals keep their
    schedule: a submit that wakes late (a sleep's overshoot, the front's
    threads holding the interpreter) is followed at once by the arrivals it
    fell behind, so the offered rate is `qps` and not `qps` less the host's
    overheads.  Returns (responses, seconds from the first arrival to the
    last)."""
    rng = np.random.default_rng(seed)
    tickets = []
    t0 = time.monotonic()
    t_next = t0
    while t_next < t0 + duration:
        wait = t_next - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        tickets.append(front.submit(requests[len(tickets) % len(requests)]))
        t_next += rng.exponential(1.0 / qps)
    offered_s = time.monotonic() - t0
    return [t.result(timeout) for t in tickets], offered_s


def serve_search_open_loop(qps: float, duration: float, deadline_ms: float,
                           ranked: bool = False, top_k: int = 10,
                           n_queries: int = 64, device=None):
    """Open-loop load: Poisson arrivals at `qps` through the front door for
    `duration` seconds (`poisson_open_loop`).  Unlike the closed loop above,
    arrivals do NOT wait for completions, so queueing delay is measured,
    not hidden — the latencies reported here are what a client-side SLO
    would see.  Returns the closed front door: `.stats` holds the measured
    window, `.dispatcher.stats` every shard call, warm-up included."""
    import dataclasses as _dc

    from repro_torch.serve import FrontDoor, FrontDoorConfig
    device = resolve_device(device)             # before the index build
    index, requests = _search_world(n_queries, ranked, top_k)
    cfg = FrontDoorConfig(default_deadline_ms=deadline_ms, cache_capacity=0,
                          shard_timeout_s=max(60.0, 4 * deadline_ms / 1000.0))
    front = FrontDoor(index, cfg=cfg, device=device)
    try:
        # warm up outside the measured window (generous deadline): the
        # arena's upload, and micro-batches of every size the measured
        # window can form (the executor pow2-buckets its task rows)
        warm = [_dc.replace(r, deadline_ms=600_000.0) for r in requests]
        n = 1
        while n < len(warm):
            front.search_batch(warm[:n])
            n *= 2
        front.search_batch(warm)
        front.stats = type(front.stats)()
        resps, elapsed = poisson_open_loop(front, requests, qps, duration)
    finally:
        front.close()
    lat = np.array([r.latency_ms for r in resps])
    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
    st = front.stats
    label = "ranked top-%d" % top_k if ranked else "phrase"
    print(f"[serve/search] open-loop {label}: offered "
          f"{len(resps) / elapsed:.1f} qps for {elapsed:.1f} s "
          f"({len(resps)} requests, deadline {deadline_ms:.0f} ms): "
          f"p50 {p50:.1f} ms, p95 {p95:.1f} ms, p99 {p99:.1f} ms; "
          f"exact {st.served_exact}, degraded {st.served_degraded}, "
          f"shed {st.shed} (shed_rate {st.shed_rate:.3f})")
    return front


def serve_lm(arch: str, n_tokens: int, device=None) -> list:
    """Greedy decode of `n_tokens` tokens, batch 2, from token 0, with
    weights from `init_params` and a CPU generator seeded 0, moved to the
    device: the same weights on the card as on the CPU, as the reference's
    `PRNGKey(0)`.  Returns batch row 0's tokens; ties in the argmax go to
    the lowest index, as `jnp.argmax`."""
    cfg = tfm.serving_config(get_arch(arch).make_smoke_config())
    dev = resolve_device(device)
    model = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                            "cpu").to(dev)
    B, S_max = 2, 128
    cache = tfm.init_cache(cfg, B, S_max, device=dev)
    tok = torch.zeros((B,), dtype=torch.int64, device=dev)
    t0 = time.perf_counter()
    toks = []
    for i in range(n_tokens):
        logits, cache = tfm.decode_step(model, cache, tok, i,
                                        attn_impl="flash")
        tok = torch.argmax(logits[:, :cfg.vocab], dim=-1)
        toks.append(tok)
    out = torch.stack(toks, dim=1)[0].tolist() if toks else []
    dt = time.perf_counter() - t0
    print(f"[serve/lm] {arch} decoded {n_tokens} tokens x batch {B} in "
          f"{dt * 1e3:.0f} ms ({dt / max(n_tokens, 1) * 1e3:.1f} ms/token, "
          f"{dev.type}); first 10: {out[:10]}")
    return out


def main(argv=None):
    """Runs the mode `argv` asks for; returns what its function returns."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["search", "lm"], default="search")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--queries", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--ranked", action="store_true",
                    help="near-mode queries with proximity ranking")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--qps", type=float, default=0.0,
                    help="open-loop Poisson arrival rate through the front "
                         "door (0 = closed-loop batch timing)")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="open-loop measurement window, seconds")
    ap.add_argument("--deadline-ms", type=float, default=500.0,
                    help="open-loop per-request deadline")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        return serve_lm(args.arch, args.tokens, device=args.device)
    if args.qps > 0:
        return serve_search_open_loop(
            args.qps, args.duration, args.deadline_ms, ranked=args.ranked,
            top_k=args.top_k, n_queries=args.queries, device=args.device)
    return serve_search(args.queries, ranked=args.ranked, top_k=args.top_k,
                        device=args.device)


if __name__ == "__main__":
    main()
