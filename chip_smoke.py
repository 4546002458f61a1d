#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--docs N] [--seed S]

Phases, each reported on its own lines:

1. device and build — the card's name and power limit (nvidia-smi), then
   every CUDA kernel source in src/repro_torch/kernels/csrc built at once
   (one nvcc per source, in parallel) and its build seconds;
2. index — a corpus of `--docs` documents (default lexicon, mean length
   800 words, seeded) and its additional + ordinary indexes, built on the
   host and moved to the card;
3. kernels — each kernel against its plain PyTorch version on the card,
   on seeded edge cases and on the largest inputs the main path gives it,
   exact equality required; times with CUDA events (L2 flushed before each
   launch) beside the memory bound; one `kernels` JSON line;
4. main path — the paper's query stream (phrase + every-other-word near
   queries of 3-5 words) in batches through `AdditionalIndexEngine(...,
   device="cuda").search_batch` and the `OrdinaryEngine` baseline, plus a
   stop-heavy near batch; every response checked field by field against
   the same engine on the CPU, the first 16 against the brute-force
   oracle; the kernels' launch counters must rise in this phase.

Any failed check exits non-zero.  The last line of standard output is
`{"ok": true, "device": {...}}`.  Without a CUDA device, or without the
repository's sources beside it, the script fails without a result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import multiprocessing
import os
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


def intersect_bound(a, b):
    """N * (5 * Pa + 4 * Pb) bytes; a lower-bound search per a element."""
    N, pa = a.shape
    pb = b.shape[1]
    nbytes = N * (5 * pa + 4 * pb) + 4 * N
    return nbytes, N * pa * (2 + 3 * max(1, pb.bit_length()))


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# the brute-force oracle runs in forked workers, which inherit this state
# instead of receiving the multi-GB corpus and index by pickle
_ORACLE = {}


def _oracle(i):
    """brute_force_search's (positional set, doc-level set) for oracle
    request i."""
    from repro_torch.core import brute_force_search
    corpus, index, requests = _ORACLE["corpus"], _ORACLE["index"], \
        _ORACLE["requests"]
    return brute_force_search(corpus, index, requests[i].surface_ids,
                              mode=requests[i].mode)


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
# main
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
    kind = torch.cuda.get_device_name(0)
    say("device", name=json.dumps(kind), count=torch.cuda.device_count(),
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
    timed = [r for b in batches[1:] for r in b] + stop_batch
    # the O(corpus) oracle for the first 16 timed requests runs in forked
    # workers (numpy only; forked before any tensor exists) while the card
    # phases below proceed; it is collected before the timed main path
    _ORACLE.update(corpus=corpus, index=index, requests=timed[:16])
    pool = stack.enter_context(ProcessPoolExecutor(
        max_workers=min(8, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("fork")))
    oracle_futures = [pool.submit(_oracle, i) for i in range(16)]

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

    # record the inputs the main path gives each kernel (one warm-up batch)
    rec_unpack = Recorder(bx.unpack_postings, lambda arena, idx: idx.numel())
    rec_inter = Recorder(bx.banded_intersect_rows, lambda a, b, bands: a.numel())
    bx.unpack_postings, bx.banded_intersect_rows = rec_unpack, rec_inter
    try:
        engines["additional"].search_batch(batches[0])
    finally:
        bx.unpack_postings = rec_unpack.fn
        bx.banded_intersect_rows = rec_inter.fn
    check(rec_unpack.best is not None and rec_inter.best is not None,
          "the warm-up batch reached no kernel")

    # -- 3. kernels against their plain versions -----------------------------
    rng = np.random.default_rng(args.seed)
    err = {"unpack_postings": 0, "banded_intersect_rows": 0}

    pp = width_class_store(np, PackedPostings, BLOCK, PACK_WIDTHS, rng)
    arena = {"lanes": torch.from_numpy(pp.lanes).cuda(),
             "blk_meta": torch.from_numpy(pp.meta_matrix()).cuda()}
    idx = torch.arange(pp.n_padded + 500, dtype=torch.int32,
                       device=arena["lanes"].device)
    cases = [(arena, idx)]
    cases.append(rec_unpack.best)
    for arena_c, idx_c in cases:
        got = ops.unpack_postings(arena_c, idx_c)
        want = ops.unpack_postings_plain(arena_c, idx_c)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            d = int((g.long() - w.long()).abs().max()) if g.numel() else 0
            err["unpack_postings"] = max(err["unpack_postings"], d)
    decoded = ops.unpack_postings(arena, idx)
    for f, name in enumerate(("doc", "pos", "dist")):
        check(np.array_equal(decoded[f][:pp.n].cpu().numpy(),
                             pp.decode(name)), f"unpack != codec ({name})")

    for pa, pb in ((128, 128), (256, 1024), (1024, 4096), (1024, 32768)):
        a, b, bands = (torch.from_numpy(x).cuda()
                       for x in rebased_rows(np, rng, 8, pa, pb))
        got = ops.banded_intersect_rows(a, b, bands)
        want = ops.banded_intersect_rows_plain(a, b, bands)
        torch.cuda.synchronize()
        d = int((got.int() - want.int()).abs().max())
        err["banded_intersect_rows"] = max(err["banded_intersect_rows"], d)
        check(bool(want.any()), "intersect edge case without hits")
    a, b, bands = rec_inter.best
    got = ops.banded_intersect_rows(a, b, bands)
    want = ops.banded_intersect_rows_plain(a, b, bands)
    torch.cuda.synchronize()
    err["banded_intersect_rows"] = max(err["banded_intersect_rows"],
                                       int((got.int() - want.int()).abs().max()))
    check(all(v == 0 for v in err.values()), f"kernel != plain version: {err}")

    # times at the largest main-path inputs
    arena_m, idx_m = rec_unpack.best
    a_m, b_m, bands_m = rec_inter.best
    timing = {
        "unpack_postings": (
            time_cuda_ms(torch, lambda: ops.unpack_postings(arena_m, idx_m)),
            time_cuda_ms(torch, lambda: ops.unpack_postings_plain(arena_m, idx_m)),
            bound_ms(*unpack_bound(torch, arena_m, idx_m))),
        "banded_intersect_rows": (
            time_cuda_ms(torch, lambda: ops.banded_intersect_rows(a_m, b_m, bands_m)),
            time_cuda_ms(torch, lambda: ops.banded_intersect_rows_plain(
                a_m, b_m, bands_m)),
            bound_ms(*intersect_bound(a_m, b_m))),
    }
    say("kernel_shapes", unpack_postings=tuple(idx_m.shape),
        banded_intersect_rows=f"a{tuple(a_m.shape)}b{tuple(b_m.shape)}")
    t_phase = phase_done("kernels", t_phase)
    oracle = [f.result() for f in oracle_futures]    # workers idle from here
    t_phase = phase_done("oracle_wait", t_phase)

    # -- 4. main path ---------------------------------------------------------
    counters = {"unpack_postings": ops.unpack_postings_cuda,
                "banded_intersect_rows": ops.banded_intersect_rows_cuda}
    for fn in counters.values():
        fn.launches = 0
    results, stats = {}, {}
    for name, eng in engines.items():
        ex = eng.batch_executor
        if name != "additional":
            eng.search_batch(batches[0])                     # warm-up
        torch.cuda.synchronize()
        lat, out = [], []
        for k in ex.timings:
            ex.timings[k] = 0.0
        for batch in batches[1:]:
            t0 = time.perf_counter()
            out.extend(eng.search_batch(batch))
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        split = dict(ex.timings)
        t0 = time.perf_counter()
        stop_out = eng.search_batch(stop_batch)
        torch.cuda.synchronize()
        stop_s = time.perf_counter() - t0
        results[name] = out + stop_out
        stats[name] = (lat, split, stop_s)
    launches = {k: fn.launches for k, fn in counters.items()}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path never launched: {launches}")
    t_phase = phase_done("main_path", t_phase)

    fields = ("doc", "pos", "postings_read", "used_fallback", "doc_only",
              "subplan_types")
    mismatches = {}
    for name, eng in engines.items():
        cpu = type(eng)(index, device="cpu")
        want = [r for i in range(1, n_b + 1)
                for r in cpu.search_batch(batches[i])]
        want += cpu.search_batch(stop_batch)
        bad = 0
        for w, g in zip(want, results[name]):
            for f in fields:
                wv, gv = getattr(w, f), getattr(g, f)
                same = (np.array_equal(wv, gv) and wv.dtype == gv.dtype
                        if isinstance(wv, np.ndarray) else wv == gv)
                if not same:
                    bad += 1
                    break
        mismatches[f"{name}_vs_cpu"] = bad
        del cpu
    t_phase = phase_done("cpu_check", t_phase)
    bad = 0
    for (positional, doc_level), r in zip(oracle, results["additional"][:16]):
        if r.doc_only:
            bad += set(r.doc.tolist()) != doc_level
        else:
            bad += set(zip(r.doc.tolist(), r.pos.tolist())) != positional
    mismatches["additional_vs_oracle_16"] = bad
    say("check", **mismatches)
    check(all(v == 0 for v in mismatches.values()),
          f"responses differ: {mismatches}")
    for v in results["additional"]:
        check(len(v.doc) == len(v.pos), "doc/pos length mismatch")

    for name, (lat, split, stop_s) in stats.items():
        n_req = n_b * bs
        say("main_path", engine=name, batches=n_b, batch_size=bs,
            qps=f"{n_req / sum(lat):.1f}",
            batch_p50_ms=f"{percentile(lat, 50) * 1e3:.2f}",
            batch_p99_ms=f"{percentile(lat, 99) * 1e3:.2f}",
            stop_near_batch_ms=f"{stop_s * 1e3:.2f}",
            **{f"{k}_s": f"{v:.4f}" for k, v in split.items()})
    post = {name: sum(r.postings_read for r in rs)
            for name, rs in results.items()}
    say("postings", additional=post["additional"], ordinary=post["ordinary"],
        ratio=f"{post['ordinary'] / max(post['additional'], 1):.2f}")
    say("memory", max_memory_allocated=torch.cuda.max_memory_allocated())
    n_batches = 2 * (n_b + 2) - 1     # both engines: warm-up (ordinary only),
    say("launches", **launches,        # timed batches, stop-heavy batch
        batches=n_batches)

    replaces = {"unpack_postings": "src/repro/kernels/unpack.py:39",
                "banded_intersect_rows": "src/repro/kernels/intersect.py:58"}
    sources = {"unpack_postings": "src/repro_torch/kernels/csrc/unpack.cu",
               "banded_intersect_rows":
                   "src/repro_torch/kernels/csrc/intersect.cu"}
    kernels = []
    for name in ("unpack_postings", "banded_intersect_rows"):
        ms, plain_ms, (b_ms, b_by) = timing[name]
        kernels.append({"name": name, "route": "cuda", "source": sources[name],
                        "replaces": replaces[name],
                        "launches": launches[name],
                        "max_abs_err": err[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None})
    say("phase", name="total", seconds=f"{time.perf_counter() - t_run:.1f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    return {"platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=6000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=64)
    args = ap.parse_args(argv)
    try:
        device = run(args)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
