"""Distributed search on the PyTorch/CUDA port: one corpus document-
partitioned over `--world` ranks, served through the serve tier
(repro_torch/serve/search_serve.py: each rank holds only its own slice of
the posting arena, executes only its own rows and merges by all_reduce
over launch/mesh.py's group), verified bit-identical against the
in-process engine; plus a ring all-reduce checked against `all_reduce`.
The counterpart of examples/distributed_search.py.

On the card: NCCL, one rank per card (`--world` defaults to the card
count).  With `--device cpu`: gloo, `--world` defaulting to the
reference's 8 simulated devices.  The script spawns its ranks itself:

    PYTHONPATH=src python examples/torch_distributed_search.py [--world N] [--docs 320] [--device cpu]
"""
import argparse
import os
import pickle
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import (AdditionalIndexEngine, CorpusConfig,
                              LexiconConfig, MODE_NEAR, SearchRequest,
                              build_all, generate_corpus,
                              make_lexicon_and_analyzer)
from repro_torch.dist.collectives import make_ring_all_reduce
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.serve.search_serve import SearchServe, SearchServeConfig

CFG = SearchServeConfig(queries=8, postings_pad=2048, seed_pad=512,
                        n_basic=1, n_expanded=1, n_stop=1, n_first=1,
                        n_multi=1)


def _world(n_docs: int):
    """ONE corpus and its index, and a batch of CFG.queries phrase requests
    taken from its documents."""
    lex_cfg = LexiconConfig(n_surface=8000, n_base=6000, n_stop=200,
                            n_frequent=600, seed=0)
    lex, ana = make_lexicon_and_analyzer(lex_cfg)
    corpus = generate_corpus(lex_cfg, CorpusConfig(n_docs=n_docs, seed=0))
    index = build_all(corpus, lex, ana)
    rng = np.random.default_rng(0)
    requests = []
    while len(requests) < CFG.queries:
        d = int(rng.integers(corpus.n_docs))
        toks = corpus.doc(d)
        if len(toks) < 10:
            continue
        st = int(rng.integers(len(toks) - 6))
        requests.append(SearchRequest(toks[st:st + 3].tolist()))
    return index, requests


def _rank_main(rank: int, world: int, backend: str, addr: str, path: str):
    """One rank: the doc-partitioned serve tier over the world's index,
    checked against the engine on this rank's device, then the ring."""
    if backend == "gloo":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        device = torch.device("cpu")
    else:
        device = torch.device(f"cuda:{rank}")
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=addr, world_size=world,
                            rank=rank)
    try:
        say = print if rank == 0 else (lambda *a, **k: None)
        with open(path, "rb") as fh:
            index, requests = pickle.load(fh)
        mesh = make_host_mesh(data=world, model=1, device=device)
        engine = AdditionalIndexEngine(index, device=device)
        say(f"devices: {world} ({backend}, {device.type})")

        # documents partitioned over the dp ranks by the serve tier itself
        # (contiguous doc ranges; each rank's arena holds only its own
        # postings)
        serve = SearchServe(index, CFG, mesh)
        say(f"document-sharded serve: {serve.n_dp} shards x "
            f"{serve.executor.docs_per_dp} docs")
        got = serve.search_batch(requests)
        want = engine.search_batch(requests)
        assert all(np.array_equal(w.doc, g.doc)
                   and np.array_equal(w.pos, g.pos)
                   for w, g in zip(want, got))
        say(f"serve over {world} shards == engine: "
            f"counts={[len(r.doc) for r in got]}")

        # ranked across the shards: per-shard scores merge through the same
        # MIN / MAX all_reduce step and stay bit-identical to the engine
        ranked_reqs = [SearchRequest(r.surface_ids, mode=MODE_NEAR,
                                     rank=True, top_k=3) for r in requests]
        rs = serve.search_batch(ranked_reqs)
        re_ = engine.search_batch(ranked_reqs)
        assert all(np.array_equal(w.doc_ids, g.doc_ids)
                   and np.array_equal(w.doc_scores, g.doc_scores)
                   for w, g in zip(re_, rs))
        say(f"ranked serve over {world} shards == engine: "
            f"top docs {[r.doc_ids[:2].tolist() for r in rs[:4]]}")

        ring = make_ring_all_reduce(mesh.dp_group)
        X = np.random.default_rng(0).normal(size=(world, 32)).astype(
            np.float32)
        mine = torch.from_numpy(X[rank]).to(device)
        red = ring(mine)
        fused = mine.clone()
        dist.all_reduce(fused, group=mesh.dp_group)
        err = float(np.abs(red.cpu().numpy() - X.sum(0)).max())
        vs_fused = float((red - fused).abs().max())
        assert vs_fused <= 1e-5 * world, vs_fused
        say(f"ring all-reduce max err: {err:.2e} "
            f"(vs all_reduce: {vs_fused:.2e})")
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: the card count; 8 with --device "
                         "cpu)")
    ap.add_argument("--docs", type=int, default=320)
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo ranks on the CPU (default: NCCL, "
                         "one rank per card)")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        backend, world = "gloo", args.world or 8
    elif args.device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass --device cpu")
        backend = "nccl"
        world = args.world or torch.cuda.device_count()
        if world > torch.cuda.device_count():
            raise ValueError(f"--world {world}: only "
                             f"{torch.cuda.device_count()} card(s)")
    else:
        raise ValueError(f"--device {args.device!r}: 'cpu' or leave it out")

    index, requests = _world(args.docs)
    with socket.socket() as s:                  # a free port for the store
        s.bind(("localhost", 0))
        addr = f"tcp://localhost:{s.getsockname()[1]}"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "world.pkl")
        with open(path, "wb") as fh:
            pickle.dump((index, requests), fh,
                        protocol=pickle.HIGHEST_PROTOCOL)
        mp.spawn(_rank_main, args=(world, backend, addr, path), nprocs=world,
                 join=True)


if __name__ == "__main__":
    main()
