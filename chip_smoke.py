#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--docs N] [--seed S]
    python3 chip_smoke.py --ab PARENT . . PARENT     # see run_ab

Phases, each reported on its own lines:

1. device and build — the card's name and power limit (nvidia-smi), then
   every CUDA kernel source in src/repro_torch/kernels/csrc built at once
   (one nvcc per source, in parallel) and its build seconds;
2. index — a corpus of `--docs` documents (default lexicon, mean length
   800 words, seeded) and its additional + ordinary indexes, built on the
   host and moved to the card;
3. kernels — each kernel against its plain PyTorch version on the card,
   on seeded edge cases and on the largest inputs the main path gives it,
   exact equality required (the unpack, banded-intersect, min-delta and
   delta-mask kernels); times with CUDA events (L2 flushed before each
   launch) beside the least time the card could take; one `kernels` JSON
   line;
4. main path — the paper's query stream (phrase + every-other-word near
   queries of 3-5 words) in batches through `AdditionalIndexEngine(...,
   device="cuda").search_batch` and the `OrdinaryEngine` baseline, plus a
   stop-heavy near batch; then, after one warm-up batch each, two ranked
   batches of the paper stream (rank=True, top_k=10), one ranked
   stop-heavy near batch, and two K-word batches (K in {3, 4, 5}, ~10%
   with windows wider than 15 that ride the flexible path; the second
   ranked).  Every response is checked field by field (scores included)
   against the same engine on the CPU; the first 16 unranked ones and the
   first 8 of every new batch against the brute-force oracles; all four
   kernels' launch counters must rise in this phase.

Any failed check exits non-zero.  The last line of standard output is
`{"ok": true, "device": {...}}`.  Without a CUDA device, or without the
repository's sources beside it, the script fails without a result.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import multiprocessing
import os
import pickle
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
INT_OPS_PER_S = 33.5e12        # 67 TFLOP/s f32 outside the tensor cores,
                               # counted per instruction (int32 runs at
                               # the f32 instruction rate)
L2_FLUSH_BYTES = 256 << 20     # > the 50 MB L2: callers find the arena cold
SEGMENT = "corpus reduced from the paper's ~130k docs by host build time"


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(tag, **kv):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_cuda_ms(torch, fn, iters=20):
    """Mean device ms of `fn()` over `iters` launches, L2 flushed before
    each one (CUDA events around the call only)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]


# ---------------------------------------------------------------------------
# query streams (seeded)
# ---------------------------------------------------------------------------

def paper_stream(np, corpus, n, seed):
    """The paper's experiment: a random indexed document; 2.1 consecutive
    words (phrase), 2.2 every other word (near); 3..5 words per query."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        toks = corpus.doc(int(rng.integers(corpus.n_docs)))
        k = int(rng.integers(3, 6))
        if len(toks) < 2 * k + 2:
            continue
        st = int(rng.integers(0, len(toks) - 2 * k))
        out.append((toks[st:st + k].tolist(), "phrase"))
        if len(out) < n:
            out.append((toks[st:st + 2 * k:2].tolist(), "near"))
    return out


def stop_near_stream(np, corpus, lex, ana, n, seed):
    """Near queries sampled at strides 1..3, each made to contain a stop
    form (one word replaced by a stop surface when it has none)."""
    rng = np.random.default_rng(seed)
    stop_surfaces = [s for s in range(400)
                     if bool(lex.is_stop(np.asarray(ana.forms_of(s))).any())][:8]
    out = []
    while len(out) < n:
        toks = corpus.doc(int(rng.integers(corpus.n_docs)))
        k = int(rng.integers(3, 6))
        stride = int(rng.integers(1, 4))
        span = stride * (k - 1) + 1
        if len(toks) <= span:
            continue
        st = int(rng.integers(0, len(toks) - span))
        q = toks[st:st + span:stride].tolist()
        if not any(bool(lex.is_stop(np.asarray(ana.forms_of(s))).any())
                   for s in q):
            q[int(rng.integers(k))] = int(rng.choice(stop_surfaces))
        out.append((q, "near"))
    return out


def kword_stream(np, corpus, lex, ana, n, seed):
    """K-word proximity queries drawn like the reference's test suite
    (tests/conftest.py::kword_queries): K in {3, 4, 5} words sampled at
    strides 1..3, ~70% with a stop surface injected, window = the sampled
    span plus jitter in [2, 15], ~10% with W in [16, 31] (the flexible
    path's range).  Returns (surface_ids, window) pairs."""
    rng = np.random.default_rng(seed)
    stop_surfaces = [s for s in range(400)
                     if bool(lex.is_stop(np.asarray(ana.forms_of(s))).any())][:8]
    out = []
    while len(out) < n:
        toks = corpus.doc(int(rng.integers(corpus.n_docs)))
        k = int(rng.integers(3, 6))
        stride = int(rng.integers(1, 4))
        span = stride * (k - 1) + 1
        if len(toks) <= span:
            continue
        st = int(rng.integers(0, len(toks) - span))
        q = toks[st:st + span:stride].tolist()
        if rng.random() < 0.7:
            q[int(rng.integers(k))] = int(rng.choice(stop_surfaces))
        if rng.random() < 0.1:
            window = 16 + int(rng.integers(0, 16))
        else:
            window = max(2, min(span - 1 + int(rng.integers(0, 4)), 15))
        out.append((q, window))
    return out


# ---------------------------------------------------------------------------
# kernel phase helpers
# ---------------------------------------------------------------------------

def width_class_store(np, PackedPostings, BLOCK, PACK_WIDTHS, rng):
    """A packed store with one block per width class per field, negative
    anchors, a full-int32-range block and a constant (width-0) tail block
    whose lane word lies past the end of `lanes`."""
    cols = {"doc": [], "pos": [], "dist": []}
    for w in PACK_WIDTHS:
        hi = 0 if w == 0 else (1 << min(w, 31)) - 1
        for f in cols:
            anchor = int(rng.integers(-1000, 1000))
            vals = anchor + rng.integers(0, hi + 1, BLOCK, dtype=np.int64)
            vals[0], vals[-1] = anchor, anchor + hi
            if w == 32:
                vals[0], vals[-1] = -(1 << 31), (1 << 31) - 1
            cols[f].append(vals)
    for f in cols:
        cols[f].append(np.full(BLOCK, 7))
    return PackedPostings.from_columns(
        {f: np.concatenate(v).astype(np.int32) for f, v in cols.items()},
        fields=("doc", "pos", "dist"))


def rebased_rows(np, rng, n_rows, pa, pb):
    """Rows in the rebased int32 key domain: unsorted a with sentinel pads,
    ascending b with sentinel tails and a duplicate run straddling a
    128-block, bands 0..8 (0 and the near window 8 included), one
    all-sentinel a row and one all-sentinel b row."""
    i32max = np.iinfo(np.int32).max
    a = np.full((n_rows, pa), i32max, np.int32)
    b = np.full((n_rows, pb), i32max, np.int32)
    for r in range(n_rows):
        keys = (rng.integers(0, 64, pb) << 17) | rng.integers(64, 4000, pb)
        nb = int(rng.integers(pb // 2, pb + 1))
        b[r, :nb] = np.sort(keys[:nb])
        if nb > 140:
            b[r, 120:136] = b[r, 120]
            b[r, :nb] = np.sort(b[r, :nb])
        na = int(rng.integers(pa // 2, pa + 1))
        near = b[r, rng.integers(0, nb, na)].astype(np.int64) \
            + rng.integers(-9, 10, na)
        a[r, :na] = np.where(rng.random(na) < 0.5, near,
                             (rng.integers(0, 64, na) << 17)
                             | rng.integers(64, 4000, na))
    a[min(1, n_rows - 1)] = i32max
    b[min(2, n_rows - 1)] = i32max
    bands = rng.choice([0, 0, 1, 2, 5, 8], n_rows).astype(np.int32)
    bands[0] = 0
    bands[-1] = 8
    return a, b, bands


def unpack_bound(torch, arena, idx):
    """Least bytes and int ops of an unpack call on these inputs: each
    ordinal read, each touched metadata row and lane word read once, three
    int32 outputs written."""
    meta_t, n = arena["blk_meta"], idx.numel()
    blk = (idx.reshape(-1) >> 7).clamp(0, meta_t.shape[0] - 1).long()
    off = (idx.reshape(-1) & 127).long()
    meta = meta_t[blk].long()
    ws = [meta[:, 1] & 63, (meta[:, 1] >> 6) & 63, (meta[:, 1] >> 12) & 63]
    fb = meta[:, 0]
    words = []
    for w in ws:
        live = w > 0
        words.append((fb + ((off * w) >> 5))[live])
        fb = fb + (w << 2)
    n_words = torch.cat(words).unique().numel()
    n_rows = blk.unique().numel()
    nbytes = 4 * n + 20 * n_rows + 4 * n_words + 12 * n
    return nbytes, 40 * n


def scored_rows(np, rng, n_rows, pa, pb, delta_bits):
    """Min-delta rows: `rebased_rows` folded onto four docs (dense, so bands
    hold several keys and equal-key runs), a delta in [0, 15] beside every
    key — band > 0 rows included, outside the plan's domain: the general
    minimum — each row sorted by (key, delta) as the (key << delta_bits |
    delta) composite, sentinel pads with delta 0, bands 0, 1, 8 and 15."""
    i32max = np.iinfo(np.int32).max
    a, b, _ = rebased_rows(np, rng, n_rows, pa, pb)
    a = np.where(a == i32max, a, a & ((4 << 17) - 1))
    b = np.sort(np.where(b == i32max, b, b & ((4 << 17) - 1)), axis=1)
    bands = np.resize(np.array([0, 1, 8, 15], np.int32), n_rows)
    bd = rng.integers(0, 16, b.shape)
    bd[b == i32max] = 0
    comp = np.sort((b.astype(np.int64) << delta_bits) | bd, axis=1)
    return (a, (comp >> delta_bits).astype(np.int32),
            (comp & ((1 << delta_bits) - 1)).astype(np.int32), bands)


def band_bound(torch, a, b, bands, out_bytes, delta_plane=False,
               walk=False, max_band=None):
    """Least bytes and int ops of a banded row kernel (intersect, min delta,
    delta mask) on these inputs.  Bytes: a read and the output written
    (`out_bytes` per a element), bands read, and of b only the 32-byte
    sectors holding what the answer depends on — per live a element the
    b keys inside its band (capped at `max_band`) and the one on each side
    that closes it, plus, with `delta_plane`, the deltas inside the band;
    each sector once per row.  Ops: a lower-bound search per a element,
    and with `walk` three per in-band b entry (the walk these inputs
    need)."""
    N, pa = a.shape
    pb = b.shape[1]
    band = bands.long()[:, None]
    if max_band is not None:
        band = band.clamp(max=max_band)
    b64 = b.long().contiguous()
    live = a != 2**31 - 1
    lo = torch.searchsorted(b64, (a.long() - band).contiguous())
    hi = torch.searchsorted(b64, (a.long() + band).contiguous(), side="right")

    def sectors(start, end):
        """Distinct 32-byte sectors of an int32 [N, Pb] plane covered by
        the per-element ranges [start, end), summed over rows."""
        start = torch.where(live, start.clamp(0, pb), 0)
        end = torch.where(live, end.clamp(0, pb), 0).clamp(min=start)
        cover = torch.zeros((N, pb + 1), dtype=torch.int64, device=a.device)
        ones = torch.ones_like(start)
        cover.scatter_add_(1, start, ones)
        cover.scatter_add_(1, end, -ones)
        used = cover.cumsum(1)[:, :pb] > 0
        used = torch.cat([used, used.new_zeros((N, -pb % 8))], dim=1)
        return int(used.reshape(N, -1, 8).any(-1).sum())

    b_sectors = sectors(lo - 1, hi + 1)
    if delta_plane:
        b_sectors += sectors(lo, hi)
    nbytes = N * pa * (4 + out_bytes) + 4 * N + 32 * b_sectors
    ops = N * pa * (2 + 3 * max(1, pb.bit_length()))
    if walk:
        ops += 3 * int(((hi - lo).clamp(min=0) * live).sum())
    return nbytes, ops


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the brute-force oracle runs in forked workers, which inherit this state
# instead of receiving the multi-GB corpus and index by pickle
_ORACLE = {}


def _oracle(i):
    """The brute-force oracle's answer for oracle request i:
    brute_force_search's or brute_force_kword's (positional set, doc-level
    set), or brute_force_ranked's / brute_force_kword_ranked's (anchor
    scores, doc scores, doc-level set) for a ranked request."""
    from repro_torch.core import (brute_force_kword, brute_force_kword_ranked,
                                  brute_force_ranked, brute_force_search)
    corpus, index, r = _ORACLE["corpus"], _ORACLE["index"], \
        _ORACLE["requests"][i]
    if r.mode == "kword":
        fn = brute_force_kword_ranked if r.rank else brute_force_kword
        return fn(corpus, index, r.surface_ids, r.window)
    fn = brute_force_ranked if r.rank else brute_force_search
    return fn(corpus, index, r.surface_ids, mode=r.mode, window=r.window)


def oracle_mismatch(r, resp, want, rtol=1e-4) -> bool:
    """True when response `resp` to request `r` disagrees with the oracle's
    answer `want`: anchor (or doc-level) sets exactly, ranked anchor and
    doc scores to `rtol` (the engines accumulate float32, the oracle
    float64), ranked docs in (score desc, doc asc) order, `top_k` docs."""
    if not r.rank:
        positional, doc_level = want
        if resp.doc_only:
            return set(resp.doc.tolist()) != doc_level
        return set(zip(resp.doc.tolist(), resp.pos.tolist())) != positional
    a_sc, d_sc, d_lvl = want
    if resp.doc_only:
        return set(resp.doc.tolist()) != d_lvl
    got = dict(zip(zip(resp.doc.tolist(), resp.pos.tolist()),
                   resp.anchor_scores.tolist()))
    if set(got) != set(a_sc):
        return True
    if any(abs(v - a_sc[k]) > rtol * max(1.0, abs(a_sc[k]))
           for k, v in got.items()):
        return True
    if len(resp.doc_ids) != min(r.top_k or len(d_sc), len(d_sc)):
        return True
    if any(abs(s - d_sc[d]) > rtol * max(1.0, abs(d_sc[d]))
           for d, s in zip(resp.doc_ids.tolist(), resp.doc_scores.tolist())):
        return True
    s, d = resp.doc_scores, resp.doc_ids
    return not bool(((s[:-1] > s[1:])
                     | ((s[:-1] == s[1:]) & (d[:-1] < d[1:]))).all())


class Recorder:
    """Wraps a kernel entry point of the batch executor and keeps a copy of
    the inputs of its largest call (used only before the main path run)."""

    def __init__(self, fn, size):
        self.fn, self.size, self.best, self.best_size = fn, size, None, -1

    def __call__(self, *args):
        s = self.size(*args)
        if s > self.best_size:
            self.best_size = s
            # the arena dict is never written: keep it, copy the rest
            self.best = tuple(x if isinstance(x, dict) else x.clone()
                              for x in args)
        return self.fn(*args)


# ---------------------------------------------------------------------------
# the smoke run
# ---------------------------------------------------------------------------

def run(args) -> dict:
    with contextlib.ExitStack() as stack:      # ends the oracle's workers
        return _run(args, stack)


def _run(args, stack) -> dict:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available: this smoke run needs an "
                           "NVIDIA GPU")
    import repro_torch.core.batch_executor as bx
    from repro_torch.core import (AdditionalIndexEngine, CorpusConfig,
                                  LexiconConfig, OrdinaryEngine,
                                  SearchRequest, build_all, generate_corpus,
                                  make_lexicon_and_analyzer)
    from repro_torch.core.postings import BLOCK, PACK_WIDTHS, PackedPostings
    from repro_torch.kernels import build, ops

    t_run = time.perf_counter()

    def phase_done(name, t_start):
        say("phase", name=name, seconds=f"{time.perf_counter() - t_start:.1f}")
        return time.perf_counter()

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    device_kind = torch.cuda.get_device_name(0)
    say("device", name=json.dumps(device_kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    say("build", seconds=f"{build_s:.2f}", sources=",".join(logs))
    t_phase = time.perf_counter()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("ptxas", source=name, info=json.dumps(line.strip()))

    # -- 2. index -------------------------------------------------------------
    t0 = time.perf_counter()
    lc = LexiconConfig(seed=args.seed)
    lex, ana = make_lexicon_and_analyzer(lc)
    corpus = generate_corpus(lc, CorpusConfig(n_docs=args.docs,
                                              mean_doc_len=800.0,
                                              seed=args.seed))
    index = build_all(corpus, lex, ana)
    host_build_s = time.perf_counter() - t0

    n_b, bs = args.batches, args.batch_size
    stream = paper_stream(np, corpus, (n_b + 1) * bs, args.seed + 1)
    batches = [[SearchRequest(q, mode=m) for q, m in stream[i * bs:(i + 1) * bs]]
               for i in range(n_b + 1)]
    stop_batch = [SearchRequest(q, mode=m) for q, m in
                  stop_near_stream(np, corpus, lex, ana, bs, args.seed + 2)]
    # the ranked and K-word batch kinds: one warm-up batch each, then the
    # timed batches of each kind
    ranked = paper_stream(np, corpus, 3 * bs, args.seed + 3)
    ranked = [[SearchRequest(q, mode=m, rank=True, top_k=10)
               for q, m in ranked[i * bs:(i + 1) * bs]] for i in range(3)]
    # K-word: a warm-up batch alternating unranked and ranked requests,
    # then one unranked and one ranked batch
    kw = kword_stream(np, corpus, lex, ana, 3 * bs, args.seed + 5)
    ranks = [[j % 2 == 1 for j in range(bs)], [False] * bs, [True] * bs]
    kw = [[SearchRequest(q, mode="kword", window=w, rank=rk)
           for (q, w), rk in zip(kw[i * bs:(i + 1) * bs], ranks[i])]
          for i in range(3)]
    warmups = [ranked[0], kw[0]]
    kinds = {
        "ranked": ranked[1:],
        "ranked_stop_near": [[SearchRequest(q, mode=m, rank=True, top_k=10)
                              for q, m in stop_near_stream(
                                  np, corpus, lex, ana, bs, args.seed + 4)]],
        "kword": [kw[1]],
        "kword_ranked": [kw[2]],
    }
    timed = [r for b in batches[1:] for r in b] + stop_batch
    # the O(corpus) oracle for the first 16 timed unranked requests and the
    # first 8 of every new batch runs in forked workers (numpy only; forked
    # before any tensor exists) while the card phases below proceed; it is
    # collected before the timed main path
    oracle_reqs = timed[:16] + [r for bl in kinds.values() for b in bl
                                for r in b[:8]]
    _ORACLE.update(corpus=corpus, index=index, requests=oracle_reqs)
    pool = stack.enter_context(ProcessPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("fork")))
    oracle_futures = [pool.submit(_oracle, i) for i in range(len(oracle_reqs))]

    torch.cuda.reset_peak_memory_stats()
    engines = {"additional": AdditionalIndexEngine(index, device="cuda"),
               "ordinary": OrdinaryEngine(index, device="cuda")}
    for eng in engines.values():
        eng.batch_executor                       # arenas onto the card now
    torch.cuda.synchronize()
    dev_bytes = engines["additional"].batch_executor.dev.device_nbytes()
    say("index", docs=corpus.n_docs, tokens=corpus.n_tokens,
        host_build_s=f"{host_build_s:.1f}", arena_device_bytes=dev_bytes,
        max_memory_allocated=torch.cuda.max_memory_allocated())
    say("index", cut=json.dumps(SEGMENT))
    t_phase = phase_done("index", t_phase)

    # record the inputs the main path gives each kernel (the additional
    # engine's warm-up batches)
    names = ("unpack_postings", "banded_intersect_rows",
             "banded_min_delta_rows", "banded_delta_mask_rows")
    rec = {"unpack_postings": Recorder(bx.unpack_postings,
                                       lambda arena, idx: idx.numel()),
           "banded_intersect_rows": Recorder(
               bx.banded_intersect_rows, lambda a, b, bands: a.numel()),
           "banded_min_delta_rows": Recorder(
               bx.banded_min_delta_rows,
               lambda a, bk, bd, bands: a.numel() + bk.numel()),
           "banded_delta_mask_rows": Recorder(
               bx.banded_delta_mask_rows,
               lambda a, b, bands: a.numel() + b.numel())}
    for name in names:
        setattr(bx, name, rec[name])
    try:
        for batch in [batches[0]] + warmups:
            engines["additional"].search_batch(batch)
    finally:
        for name in names:
            setattr(bx, name, rec[name].fn)
    check(all(r.best is not None for r in rec.values()),
          "the warm-up batches reached not every kernel: "
          f"{[n for n, r in rec.items() if r.best is None]}")

    # -- 3. kernels against their plain versions -----------------------------
    rng = np.random.default_rng(args.seed)
    err = dict.fromkeys(names, 0)

    def diff(got, want):
        if not got.numel():
            return 0
        return int((got.long() - want.long()).abs().max())

    pp = width_class_store(np, PackedPostings, BLOCK, PACK_WIDTHS, rng)
    arena = {"lanes": torch.from_numpy(pp.lanes).cuda(),
             "blk_meta": torch.from_numpy(pp.meta_matrix()).cuda()}
    idx = torch.arange(pp.n_padded + 500, dtype=torch.int32,
                       device=arena["lanes"].device)
    for arena_c, idx_c in ((arena, idx), rec["unpack_postings"].best):
        got = ops.unpack_postings(arena_c, idx_c)
        want = ops.unpack_postings_plain(arena_c, idx_c)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err["unpack_postings"] = max(err["unpack_postings"], diff(g, w))
    decoded = ops.unpack_postings(arena, idx)
    for f, name in enumerate(("doc", "pos", "dist")):
        check(np.array_equal(decoded[f][:pp.n].cpu().numpy(),
                             pp.decode(name)), f"unpack != codec ({name})")

    shapes = ((128, 128), (256, 1024), (1024, 4096), (1024, 32768))
    cases = {name: [] for name in names[1:]}
    for pa, pb in shapes:
        cases["banded_intersect_rows"].append(
            [torch.from_numpy(x).cuda()
             for x in rebased_rows(np, rng, 8, pa, pb)])
        a, bk, bd, bands = (torch.from_numpy(x).cuda()
                            for x in scored_rows(np, rng, 8, pa, pb,
                                                ops.SCORE_DELTA_BITS))
        cases["banded_min_delta_rows"].append([a, bk, bd, bands])
        cases["banded_delta_mask_rows"].append([a, bk, bands])
    # (plain version, which outputs are hits) per row kernel
    plain = {"banded_intersect_rows": (ops.banded_intersect_rows_plain,
                                       lambda x: x),
             "banded_min_delta_rows": (ops.banded_min_delta_rows_plain,
                                       lambda x: x != ops.I32_SENTINEL),
             "banded_delta_mask_rows": (ops.banded_delta_mask_rows_plain,
                                        lambda x: x != 0)}
    for name, (fn_plain, hits) in plain.items():
        kernel = getattr(ops, name)
        for i, args_c in enumerate(cases[name] + [list(rec[name].best)]):
            got = kernel(*args_c)
            want = fn_plain(*args_c)
            torch.cuda.synchronize()
            err[name] = max(err[name], diff(got, want))
            if i < len(shapes):
                h = hits(want)
                check(bool(h.any()) and not bool(h.all()),
                      f"{name} edge case {shapes[i]} is trivial")
    check(all(v == 0 for v in err.values()), f"kernel != plain version: {err}")

    # times at the largest main-path inputs
    arena_m, idx_m = rec["unpack_postings"].best
    a_m, b_m, bands_m = rec["banded_intersect_rows"].best
    md = rec["banded_min_delta_rows"].best
    dm = rec["banded_delta_mask_rows"].best
    timing = {
        "unpack_postings": (
            time_cuda_ms(torch, lambda: ops.unpack_postings(arena_m, idx_m)),
            time_cuda_ms(torch, lambda: ops.unpack_postings_plain(arena_m, idx_m)),
            bound_ms(*unpack_bound(torch, arena_m, idx_m))),
        "banded_intersect_rows": (
            time_cuda_ms(torch, lambda: ops.banded_intersect_rows(a_m, b_m, bands_m)),
            time_cuda_ms(torch, lambda: ops.banded_intersect_rows_plain(
                a_m, b_m, bands_m)),
            bound_ms(*band_bound(torch, a_m, b_m, bands_m, 1))),
        "banded_min_delta_rows": (
            time_cuda_ms(torch, lambda: ops.banded_min_delta_rows(*md)),
            time_cuda_ms(torch, lambda: ops.banded_min_delta_rows_plain(*md)),
            bound_ms(*band_bound(torch, md[0], md[1], md[3], 4,
                                 delta_plane=True, walk=True))),
        "banded_delta_mask_rows": (
            time_cuda_ms(torch, lambda: ops.banded_delta_mask_rows(*dm)),
            time_cuda_ms(torch, lambda: ops.banded_delta_mask_rows_plain(*dm)),
            bound_ms(*band_bound(torch, *dm, 4, walk=True, max_band=15))),
    }
    say("kernel_shapes", unpack_postings=tuple(idx_m.shape),
        banded_intersect_rows=f"a{tuple(a_m.shape)}b{tuple(b_m.shape)}",
        banded_min_delta_rows=f"a{tuple(md[0].shape)}b{tuple(md[1].shape)}",
        banded_delta_mask_rows=f"a{tuple(dm[0].shape)}b{tuple(dm[1].shape)}")
    t_phase = phase_done("kernels", t_phase)
    oracle = [f.result() for f in oracle_futures]    # workers idle from here
    # the index and the oracle's answers are set-up data: collect now and
    # keep the collector off them, so that no full collection over them
    # pauses a timed batch
    gc.collect()
    gc.freeze()
    t_phase = phase_done("oracle_wait", t_phase)

    # -- 4. main path ---------------------------------------------------------
    counters = {"unpack_postings": ops.unpack_postings_cuda,
                "banded_intersect_rows": ops.banded_intersect_rows_cuda,
                "banded_min_delta_rows": ops.banded_min_delta_rows_cuda,
                "banded_delta_mask_rows": ops.banded_delta_mask_rows_cuda}
    for fn in counters.values():
        fn.launches = 0
    n_calls = 0

    def run_batch(eng, batch):
        nonlocal n_calls
        t0 = time.perf_counter()
        out = eng.search_batch(batch)
        torch.cuda.synchronize()
        n_calls += 1
        return out, time.perf_counter() - t0

    results, stats, kind_out, kind_lat, kind_split = {}, {}, {}, {}, {}
    for name, eng in engines.items():
        ex = eng.batch_executor
        if name != "additional":
            for batch in [batches[0]] + warmups:         # warm-up
                run_batch(eng, batch)
        lat, out = [], []
        for k in ex.timings:
            ex.timings[k] = 0.0
        for batch in batches[1:]:
            o, dt = run_batch(eng, batch)
            out.extend(o)
            lat.append(dt)
        split = dict(ex.timings)
        stop_out, stop_s = run_batch(eng, stop_batch)
        results[name] = out + stop_out
        stats[name] = (lat, split, stop_s)
        for kname, bl in kinds.items():
            for k in ex.timings:
                ex.timings[k] = 0.0
            for batch in bl:
                o, dt = run_batch(eng, batch)
                kind_out.setdefault((name, kname), []).extend(o)
                kind_lat.setdefault((name, kname), []).append(dt)
            kind_split[name, kname] = dict(ex.timings)
    launches = {k: fn.launches for k, fn in counters.items()}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    t_phase = phase_done("main_path", t_phase)

    fields = ("doc", "pos", "postings_read", "used_fallback", "doc_only",
              "subplan_types", "ranked", "anchor_scores", "doc_ids",
              "doc_scores")

    def same(w, g, f):
        wv, gv = getattr(w, f), getattr(g, f)
        if isinstance(wv, np.ndarray) or isinstance(gv, np.ndarray):
            return (isinstance(wv, np.ndarray) and isinstance(gv, np.ndarray)
                    and wv.dtype == gv.dtype and np.array_equal(wv, gv))
        return wv == gv

    mismatches, cpu_s = {}, {}
    for name, eng in engines.items():
        t0 = time.perf_counter()
        cpu = type(eng)(index, device="cpu")
        want = [r for i in range(1, n_b + 1)
                for r in cpu.search_batch(batches[i])]
        want += cpu.search_batch(stop_batch)
        got = list(results[name])
        for kname, bl in kinds.items():
            for batch in bl:
                want += cpu.search_batch(batch)
            got += kind_out[name, kname]
        mismatches[f"{name}_vs_cpu"] = sum(
            not all(same(w, g, f) for f in fields) for w, g in zip(want, got))
        check(len(want) == len(got), "response counts differ")
        del cpu
        cpu_s[f"{name}_s"] = f"{time.perf_counter() - t0:.1f}"
    say("cpu_check", **cpu_s)
    t_phase = phase_done("cpu_check", t_phase)
    checked = results["additional"][:16] + [
        r for kname, bl in kinds.items()
        for i in range(len(bl))
        for r in kind_out["additional", kname][i * bs:i * bs + 8]]
    mismatches[f"additional_vs_oracle_{len(oracle_reqs)}"] = sum(
        oracle_mismatch(r, resp, w)
        for r, resp, w in zip(oracle_reqs, checked, oracle))
    say("check", **mismatches)
    check(all(v == 0 for v in mismatches.values()),
          f"responses differ: {mismatches}")
    for v in results["additional"]:
        check(len(v.doc) == len(v.pos), "doc/pos length mismatch")
    for (name, kname), out in kind_out.items():
        for v in out:
            check(len(v.doc) == len(v.pos), "doc/pos length mismatch")
            if v.ranked:
                check(v.doc_scores.dtype == np.float32
                      and bool(np.isfinite(v.doc_scores).all())
                      and bool(np.isfinite(v.anchor_scores).all())
                      and len(v.doc_ids) <= (v.request.top_k
                                             or len(v.doc_ids))
                      and len(v.anchor_scores) == len(v.doc),
                      f"bad ranked response ({name}, {kname})")

    for name, (lat, split, stop_s) in stats.items():
        n_req = n_b * bs
        say("main_path", engine=name, batches=n_b, batch_size=bs,
            qps=f"{n_req / sum(lat):.1f}",
            batch_p50_ms=f"{percentile(lat, 50) * 1e3:.2f}",
            batch_p99_ms=f"{percentile(lat, 99) * 1e3:.2f}",
            stop_near_batch_ms=f"{stop_s * 1e3:.2f}",
            **{f"{k}_s": f"{v:.4f}" for k, v in split.items()})
    for (name, kname), lat in kind_lat.items():
        say("main_path_kind", engine=name, kind=kname, batches=len(lat),
            batch_size=bs, qps=f"{len(lat) * bs / sum(lat):.1f}",
            batch_p50_ms=f"{percentile(lat, 50) * 1e3:.2f}",
            batch_p99_ms=f"{percentile(lat, 99) * 1e3:.2f}",
            **{f"{k}_s": f"{v:.4f}" for k, v in kind_split[name, kname].items()})
    post = {name: sum(r.postings_read for r in rs)
            for name, rs in results.items()}
    say("postings", additional=post["additional"], ordinary=post["ordinary"],
        ratio=f"{post['ordinary'] / max(post['additional'], 1):.2f}")
    kw_post = {name: sum(r.postings_read for kname in ("kword", "kword_ranked")
                         for r in kind_out[name, kname]) for name in engines}
    say("postings_kword", additional=kw_post["additional"],
        ordinary=kw_post["ordinary"],
        ratio=f"{kw_post['ordinary'] / max(kw_post['additional'], 1):.2f}")
    say("memory", max_memory_allocated=torch.cuda.max_memory_allocated())
    say("launches", **launches, batches=n_calls)

    replaces = {"unpack_postings": "src/repro/kernels/unpack.py:39",
                "banded_intersect_rows": "src/repro/kernels/intersect.py:58",
                "banded_min_delta_rows": "src/repro/kernels/intersect.py:117",
                "banded_delta_mask_rows": "src/repro/kernels/intersect.py:176"}
    sources = {"unpack_postings": "unpack.cu",
               "banded_intersect_rows": "intersect.cu",
               "banded_min_delta_rows": "min_delta.cu",
               "banded_delta_mask_rows": "delta_mask.cu"}
    kernels = []
    for name in names:
        ms, plain_ms, (b_ms, b_by) = timing[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/"
                                  + sources[name],
                        "replaces": replaces[name],
                        "launches": launches[name],
                        "max_abs_err": err[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})
    say("phase", name="total", seconds=f"{time.perf_counter() - t_run:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    return {"platform": "gpu", "kind": device_kind,
            "count": torch.cuda.device_count()}


# ---------------------------------------------------------------------------
# A/B of the unranked main path between checkouts (--ab)
# ---------------------------------------------------------------------------

def _ab_run_tree(tree, blob, freeze, conn):
    """One spawned run: `repro_torch` from `tree` only, then the batches."""
    try:
        sys.path.insert(0, str(Path(tree).resolve() / "src"))
        import torch
        from repro_torch.core import (AdditionalIndexEngine, OrdinaryEngine,
                                      SearchRequest)
        data = pickle.loads(blob)
        index = data["index"]
        batches = [[SearchRequest(q, mode=m) for q, m in b]
                   for b in data["batches"]]
        stop_batch = [SearchRequest(q, mode=m) for q, m in data["stop"]]
        if freeze:
            gc.collect()
            gc.freeze()
        out = {}
        for name, cls in (("additional", AdditionalIndexEngine),
                          ("ordinary", OrdinaryEngine)):
            eng = cls(index, device="cuda")
            ex = eng.batch_executor
            eng.search_batch(batches[0])                  # warm-up
            torch.cuda.synchronize()
            for k in ex.timings:
                ex.timings[k] = 0.0
            lat, digest = [], hashlib.sha256()
            for batch in batches[1:]:
                t0 = time.perf_counter()
                resp = eng.search_batch(batch)
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t0)
                for r in resp:
                    digest.update(r.doc.tobytes() + r.pos.tobytes()
                                  + str(r.postings_read).encode())
            split = dict(ex.timings)
            t0 = time.perf_counter()
            eng.search_batch(stop_batch)
            torch.cuda.synchronize()
            out[name] = {
                "qps": len(lat) * len(batches[1]) / sum(lat),
                "batch_p50_ms": percentile(lat, 50) * 1e3,
                "batch_p99_ms": percentile(lat, 99) * 1e3,
                "stop_near_batch_ms": (time.perf_counter() - t0) * 1e3,
                **{f"{k}_s": v for k, v in split.items()},
                "digest": digest.hexdigest()[:16]}
            del eng, ex
        conn.send(out)
    except BaseException as e:                      # reported by the parent
        conn.send({"error": f"{type(e).__name__}: {e}"})
    finally:
        conn.close()


def run_ab(args) -> int:
    """`--ab TREE ...`: the unranked main path of each checkout in TREE, in
    the order given, on one card.  The corpus and index are built once, on
    the host, with the package beside this script (the index builder is
    the same code in every checkout of the port so far) and pickled; each
    run then starts a fresh (spawned) process that imports `repro_torch`
    from its checkout alone, unpickles the index into that checkout's
    classes and drives what phase 4 drives for unranked requests: per
    engine one warm-up batch, `--batches` timed batches of the paper's
    stream and one stop-heavy near batch, reporting QPS, batch p50 / p99
    and the executor's phase seconds.  The list runs once with
    `gc.collect(); gc.freeze()` after set-up and once without, so every
    checkout sees the same harness either way.  The answers (doc, pos,
    postings_read per response) must agree across runs."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke --ab: FAILED: CUDA is not available",
              file=sys.stderr)
        return 1
    for tree in args.ab:
        if not (Path(tree) / "src" / "repro_torch").is_dir():
            print(f"chip_smoke --ab: FAILED: {tree} holds no src/repro_torch",
                  file=sys.stderr)
            return 1
    from repro_torch.core import (CorpusConfig, LexiconConfig, build_all,
                                  generate_corpus, make_lexicon_and_analyzer)

    t0 = time.perf_counter()
    lc = LexiconConfig(seed=args.seed)
    lex, ana = make_lexicon_and_analyzer(lc)
    corpus = generate_corpus(lc, CorpusConfig(n_docs=args.docs,
                                              mean_doc_len=800.0,
                                              seed=args.seed))
    index = build_all(corpus, lex, ana)
    n_b, bs = args.batches, args.batch_size
    stream = paper_stream(np, corpus, (n_b + 1) * bs, args.seed + 1)
    blob = pickle.dumps({
        "index": index,
        "batches": [stream[i * bs:(i + 1) * bs] for i in range(n_b + 1)],
        "stop": stop_near_stream(np, corpus, lex, ana, bs, args.seed + 2)},
        protocol=pickle.HIGHEST_PROTOCOL)
    del index, corpus
    gc.collect()
    say("ab_setup", docs=args.docs, pickle_bytes=len(blob),
        seconds=f"{time.perf_counter() - t0:.1f}")

    ctx = multiprocessing.get_context("spawn")
    runs = []
    for freeze in (True, False):
        for tree in args.ab:
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(target=_ab_run_tree,
                            args=(tree, blob, freeze, send))
            p.start()
            send.close()
            res = recv.recv()
            p.join()
            if "error" in res:
                print(f"chip_smoke --ab: FAILED: {tree}: {res['error']}",
                      file=sys.stderr)
                return 1
            for eng, r in res.items():
                say("ab", tree=tree, gc_freeze=freeze, engine=eng,
                    **{k: (f"{v:.4f}" if isinstance(v, float) else v)
                       for k, v in r.items()})
            runs.append({"tree": tree, "gc_freeze": freeze, **res})
    digests = {(eng, r[eng]["digest"]) for r in runs for eng in
               ("additional", "ordinary")}
    print(json.dumps({"ab": runs}), flush=True)
    if len(digests) != 2:
        print("chip_smoke --ab: FAILED: answers differ across runs: "
              f"{digests}", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=6000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--ab", nargs="+", metavar="TREE",
                    help="A/B the unranked main path of these checkouts "
                         "(run order, e.g. PARENT . . PARENT) instead of "
                         "the smoke run")
    args = ap.parse_args(argv)
    if args.ab:
        return run_ab(args)
    try:
        device = run(args)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
