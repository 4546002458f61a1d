"""The one traffic generator.  A mix is a data file, `bench/traffic/<mix>.json`,
whose parameters this module reads; a new mix is a new data file.

Every request is drawn from an indexed document, as in the paper's
experiment (arXiv:1801.09079: "phrases are selected from an already-indexed
document"): a document, a word count k and a start position are drawn
once per draw, and each entry of the mix's `templates` turns them into one
query, taking every `stride`-th word.  Per template:

    mode           "phrase" | "near" | "kword"
    stride         [lo, hi]  words between query words (drawn per draw)
    stop_inject    share of queries whose one random word is replaced by a
                   stop surface (one of the mix's `stop_pool` first stop
                   surfaces)
    window         kword only: {"jitter": [lo, hi], "min", "max",
                   "wide_share", "wide": [lo, hi]}: W = clamp(span - 1 +
                   jitter, min, max), or, for `wide_share` of the
                   queries, W drawn from `wide`

The mix also gives `k` ([lo, hi]), `batch` (requests a batch),
`pool_batches` (the run's pool of batches: set-up runs each batch once, and
the window cycles through the pool, a new order each pass), optionally
`pool_seed` (the pool is then drawn once from it, and every run seed runs
the same requests in another order; without it the pool is drawn from the
run's `--seed`) and `sample` (requests of the window compared with the
reference, drawn from `--seed`).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from inputs import rng_for

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"
MODES = ("phrase", "near", "kword")


def load_mix(name: str) -> dict:
    path = TRAFFIC_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    mix = json.loads(path.read_text())
    for t in mix["templates"]:
        if t["mode"] not in MODES:
            raise ValueError(f"{name}: unknown mode {t['mode']!r}")
    return mix


def stop_pool(lex, n: int, first: int = 400) -> list[int]:
    """The first `n` surfaces below `first` that have a stop basic form."""
    has = lex.surface_has_stop()[:first]
    return [int(s) for s in np.nonzero(has)[0][:n]]


def _draw(rng, lo_hi) -> int:
    lo, hi = lo_hi
    return int(rng.integers(lo, hi + 1))


def _window(rng, spec: dict, span: int) -> int:
    if rng.random() < float(spec.get("wide_share", 0.0)):
        return _draw(rng, spec["wide"])
    w = span - 1 + _draw(rng, spec["jitter"])
    return max(int(spec["min"]), min(w, int(spec["max"])))


def queries(mix: dict, doc_offsets: np.ndarray, tokens: np.ndarray, lex,
            n: int, seed: int) -> list[dict]:
    """`n` query specs {"surface_ids", "mode", "window"} drawn from
    `seed`."""
    rng = rng_for(seed, 0x7A)
    stops = stop_pool(lex, int(mix.get("stop_pool", 8)))
    templates = mix["templates"]
    n_docs = len(doc_offsets) - 1
    out = []
    while len(out) < n:
        d = int(rng.integers(n_docs))
        toks = tokens[doc_offsets[d]:doc_offsets[d + 1]]
        k = _draw(rng, mix["k"])
        strides = [_draw(rng, t["stride"]) for t in templates]
        span = max(s * (k - 1) + 1 for s in strides)
        if len(toks) <= span + 1:
            continue
        st = int(rng.integers(0, len(toks) - span))
        for t, s in zip(templates, strides):
            q = toks[st:st + s * (k - 1) + 1:s].tolist()
            if rng.random() < float(t.get("stop_inject", 0.0)):
                q[int(rng.integers(k))] = int(rng.choice(stops))
            window = None
            if t["mode"] == "kword":
                window = _window(rng, t["window"], s * (k - 1) + 1)
            out.append({"surface_ids": q, "mode": t["mode"],
                        "window": window})
    return out[:n]


def pool(mix: dict, doc_offsets: np.ndarray, tokens: np.ndarray, lex,
         seed: int) -> list[list[dict]]:
    """The run's pool of batches: from the mix's `pool_seed` where it gives
    one, else from the run's `seed`."""
    b = int(mix["batch"])
    specs = queries(mix, doc_offsets, tokens, lex,
                    int(mix["pool_batches"]) * b,
                    int(mix.get("pool_seed", seed)))
    return [specs[i:i + b] for i in range(0, len(specs), b)]


def order(n_batches: int, seed: int):
    """Batch indices of the window: pass after pass over the pool, each
    pass in a new order drawn from the run's seed."""
    rng = rng_for(seed, 0x0D)
    while True:
        yield from rng.permutation(n_batches).tolist()
