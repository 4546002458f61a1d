"""One run of one cell: set-up, the measured window, the traced window's
reduction, and the comparison with the reference.

    set-up   the inputs from the configuration (bench/inputs.py), the
             program's index (`repro_torch.core.build_all`) and engine on
             the device, the run's pool of batches and one pass over it
             (the first run in a checkout also builds the kernels and the
             index here, and keeps both in the checkout's caches)
    window   a closed loop of the mix's batches through the engine's
             `search_batch` for `seconds`, each batch issued when the last
             one has answered
    check    a sample of the window's requests, drawn from the seed,
             answered again by the reference (bench/reference/) once the
             window has closed and the program's state is freed
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import json
import os
import pickle
import resource
import sys
import time
from pathlib import Path

import numpy as np

import devtrace
import generator
import judge
import roofline
from inputs import make_corpus, make_lexicon, rng_for
from reference.search import Reference

BENCH = Path(__file__).resolve().parent
METRICS_DIR = BENCH / "metrics"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_SECONDS = 10.0
ENGINES = ("additional", "ordinary")


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_reader(name: str):
    """The reader of metric `name`: `read(record)` in bench/metrics/<name>.py,
    which returns the value or None where it finds nothing to read."""
    import importlib.util
    path = METRICS_DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules (`sys.modules` by default) whose top-level name is the
    JAX stack's or the JAX package's, compared whole."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.split(".", 1)[0] for m in names}.intersection(FORBIDDEN))


def requests_of(core, cfg: dict, specs: list[dict]) -> list:
    """The program's requests (`core` is repro_torch.core) for query specs,
    under the configuration's service."""
    service = cfg["service"]
    return [core.SearchRequest(s["surface_ids"], mode=s["mode"],
                               window=s["window"], rank=bool(service["rank"]),
                               top_k=service["top_k"])
            for s in specs]


def build_program(cfg: dict, lex, doc_offsets, tokens):
    """The program's index over the benchmark's corpus.  The program makes
    its lexicon from the same configuration and seed; its tables must
    equal the benchmark's, or the two sides would search different data."""
    from repro_torch import core
    lc = core.LexiconConfig(**cfg["lexicon"], seed=int(cfg["lexicon_seed"]))
    plex, pana = core.make_lexicon_and_analyzer(lc)
    check_lexicon(pana, plex, lex)
    corpus = core.Corpus(doc_offsets=doc_offsets, tokens=tokens)
    return core.build_all(corpus, plex, pana, core.IndexParams(**cfg["index"]))


def check_lexicon(pana, plex, lex) -> None:
    """The program's lexicon tables must equal the benchmark's, or the two
    sides would search different data."""
    if not (np.array_equal(pana.form_offsets, lex.form_offsets)
            and np.array_equal(pana.form_ids, lex.form_ids)
            and np.array_equal(plex.base_tier, lex.base_tier)):
        raise RuntimeError("the program's lexicon tables differ from the "
                           "benchmark's for the same seed")


# the configuration's keys that the index depends on
INDEX_INPUTS = ("n_docs", "mean_doc_len", "sigma_doc_len", "burstiness",
                "stop_mass", "corpus_seed", "lexicon_seed", "lexicon", "index")


def index_key(cfg: dict) -> str:
    """The cache key of a configuration's index: the configuration's index
    inputs, the benchmark's input generators, the program's sources and the
    versions of numpy and torch."""
    import torch
    import repro_torch
    h = hashlib.sha256(json.dumps({k: cfg.get(k) for k in INDEX_INPUTS},
                                  sort_keys=True).encode())
    h.update(f"{np.__version__} {torch.__version__}".encode())
    h.update((BENCH / "inputs.py").read_bytes())
    pkg = Path(repro_torch.__file__).resolve().parent
    for p in sorted(pkg.rglob("*.py")):
        h.update(str(p.relative_to(pkg)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:32]


def cached_index(cfg: dict, lex, doc_offsets, tokens, cache_dir):
    """(index, built): the program's index over the benchmark's corpus,
    loaded from `cache_dir` where an earlier run of this checkout kept it,
    else built and kept there.  Without `cache_dir` it is built."""
    if cache_dir is None:
        return build_program(cfg, lex, doc_offsets, tokens), True
    path = Path(cache_dir) / f"index-{index_key(cfg)}.pkl"
    if path.is_file():
        with open(path, "rb") as f:
            index = pickle.load(f)
        check_lexicon(index.analyzer, index.lexicon, lex)
        if index.n_docs != len(doc_offsets) - 1:
            raise RuntimeError(f"{path}: {index.n_docs} documents, the "
                               f"configuration has {len(doc_offsets) - 1}")
        return index, False
    index = build_program(cfg, lex, doc_offsets, tokens)
    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_suffix(".part")
    with open(part, "wb") as f:
        pickle.dump(index, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(part, path)
    return index, True


def host_counters() -> dict:
    """The host's steal time (seconds, all cores, /proc/stat), this
    process's CPU seconds and its context switches: read around the window,
    they say whether the host or the process's own work moved its time."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": time.process_time(), "nvcsw": ru.ru_nvcsw,
           "nivcsw": ru.ru_nivcsw, "steal_s": None}
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        out["steal_s"] = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def make_engine(cfg: dict, index, device):
    from repro_torch import core
    kind = cfg["engine"]
    if kind not in ENGINES:
        raise ValueError(f"unknown engine {kind!r}")
    cls = core.AdditionalIndexEngine if kind == "additional" else core.OrdinaryEngine
    return cls(index, device=device)


def run_cell(cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device: str, metrics: dict, t_start: float,
             log=print, index_cache=None) -> dict:
    """One run; returns the result line's object.  `metrics` maps the names
    this run reports (the cell's end-to-end metrics, or with `trace` its
    per-layer ones) to their units.  `log` takes the lines for standard
    error.  `index_cache` is the directory that keeps the built index
    between runs (none: built in every run)."""
    import torch

    from repro_torch import core
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    # -- set-up --------------------------------------------------------------
    lex = make_lexicon(cfg)
    doc_offsets, tokens = make_corpus(cfg, lex)
    t0 = time.perf_counter()
    index, built = cached_index(cfg, lex, doc_offsets, tokens, index_cache)
    index_s = time.perf_counter() - t0
    pool = generator.pool(mix, doc_offsets, tokens, lex, seed)
    pool_reqs = [requests_of(core, cfg, b) for b in pool]
    mem0 = torch.cuda.memory_allocated() if cuda else 0
    engine = make_engine(cfg, index, device)
    engine.batch_executor.dev.device_arena           # the arena on the card
    sync()
    index_bytes = (torch.cuda.memory_allocated() - mem0) if cuda else None
    for reqs in pool_reqs:                          # every shape of the window
        engine.search_batch(reqs)
    sync()
    ex = engine.batch_executor
    for k in ex.timings:
        ex.timings[k] = 0.0
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    log(f"[setup] seconds={setup_s:.3f} index_s={index_s:.3f} "
        f"index_built={built} "
        f"tokens={len(tokens)} docs={len(doc_offsets) - 1} "
        f"index_bytes={index_bytes} batches_in_pool={len(pool)}")

    # -- window --------------------------------------------------------------
    # a traced run profiles the first TRACE_SECONDS of its window and ends
    # there: the profiler's events of a longer window take minutes to read
    import repro_torch.kernels.ops as ops
    if trace:
        seconds = min(seconds, TRACE_SECONDS)
    lat, answered = [], []
    with contextlib.ExitStack() as stack:
        if trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = stack.enter_context(torch.profiler.profile(activities=acts))
            stack.enter_context(devtrace.spans(torch))
            if cuda:
                calls = stack.enter_context(devtrace.KernelCalls(ops))
        stack.enter_context(torch.profiler.record_function("bench.window"))
        host0 = host_counters()
        tw = time.perf_counter()
        for b in generator.order(len(pool_reqs), seed):
            ts = time.perf_counter()
            with torch.profiler.record_function("bench.batch"):
                out = engine.search_batch(pool_reqs[b])
                sync()
            te = time.perf_counter()
            lat.append(te - ts)
            answered.append((b, out))
            if te - tw >= seconds:
                break
        window_s = te - tw
        host1 = host_counters()
    gc.unfreeze()
    host = {k: None if host0[k] is None else host1[k] - host0[k]
            for k in host0}
    n_req = sum(len(out) for _, out in answered)
    lat_ms = np.asarray(lat) * 1e3
    log(f"[window] seconds={window_s:.3f} batches={len(answered)} "
        f"requests={n_req} qps={n_req / window_s:.3f} batch_p95_ms="
        f"{np.percentile(lat_ms, 95):.3f} batch_p50_ms="
        f"{np.percentile(lat_ms, 50):.3f}")
    log("[host] " + " ".join(f"{k}={v}" for k, v in host.items()))
    timings = dict(ex.timings)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

    record = {
        "window_s": window_s, "batches": len(answered), "requests": n_req,
        "latencies_s": [x for x, (_, out) in zip(lat, answered)
                        for _ in range(len(out))],
        "setup_s": setup_s, "index_bytes": index_bytes,
        "tokens": int(len(tokens)), "timings": timings,
        "postings": sum(int(r.postings_read) for _, out in answered
                        for r in out),
        "trace": None, "kernels": {},
    }
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if trace:
        reduced = devtrace.reduce_trace(prof.profiler.kineto_results.events())
        del prof
        if cuda:
            record["kernels"] = kernel_shares(torch, calls, reduced)
            del calls
        device_info["busy_s"] = reduced["busy_s"]
        device_info["window_s"] = reduced["window_s"]
        breakdown = {"device_ops": reduced["device_ops"],
                     "idle_gaps": reduced["idle_gaps"]}
        log(f"[trace] window_s={reduced['window_s']:.6f} "
            f"busy_s={reduced['busy_s']:.6f} kernels={reduced['n_kernels']} "
            f"calls={json.dumps(record['kernels'])}")
        reduced["kernels"] = None           # the per-launch list, read
        record["trace"] = reduced
    values = {}
    for name in metrics:
        v = load_reader(name)(record)
        if v is not None:
            values[name] = float(v)

    # -- check ---------------------------------------------------------------
    flat = [(pi, j, r) for pi, out in answered for j, r in enumerate(out)]
    del engine, ex, index, answered, record
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    n = min(int(mix["sample"]), len(flat))
    pick = np.sort(rng_for(seed, 0x5A).choice(len(flat), size=n, replace=False))
    specs = [pool[flat[k][0]][flat[k][1]] for k in pick]
    resps = [flat[k][2] for k in pick]
    ref = reference_for(cfg, lex, doc_offsets, tokens)
    service = cfg["service"]
    answers = [ref.answer(s["surface_ids"], s["mode"], s["window"],
                          bool(service["rank"]), service["top_k"])
               for s in specs]
    limits = cfg["limits"]
    compared, wrong = judge.judge(specs, resps, answers,
                                  bool(service["rank"]), service["top_k"],
                                  limits.get("score_rel_gap", 0.0))
    check_s = time.perf_counter() - t0
    correct = all(compared[k] <= limits[k] for k in compared)
    for k in wrong[:5]:
        log(f"[wrong] request={json.dumps(specs[k])}")
    log(f"[check] sampled={n} seconds={check_s:.3f}")
    result = {"correct": bool(correct), "attempted": n_req, "failed": 0,
              "metrics": {k: {"value": v, "unit": metrics[k]}
                          for k, v in values.items()},
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": v, "limit": limits[k]}
                          for k, v in compared.items()}
    return result


def reference_for(cfg: dict, lex, doc_offsets, tokens, **kw) -> Reference:
    idx = cfg["index"]
    return Reference(lex, doc_offsets, tokens, idx["min_len"], idx["max_len"],
                     idx["near_window"], service=cfg["engine"], **kw)


def kernel_shares(torch, calls, reduced: dict) -> dict:
    """Per kernel: the recorded calls' least seconds (roofline.py) and the
    trace's seconds of the same launches, the first `n` of the window."""
    out = {}
    for k, (_, cuda_name) in devtrace.KERNELS.items():
        recorded = calls.calls[k]
        secs = devtrace.kernel_seconds(reduced, cuda_name)
        n = min(len(recorded), len(secs))
        if n == 0:
            continue
        least = sum(roofline.least_seconds(*roofline.call_bound(torch, k, a))
                    for a in recorded[:n])
        out[k] = {"calls": n, "launches": calls.launched[k],
                  "least_s": least, "trace_s": sum(secs[:n])}
    return out
