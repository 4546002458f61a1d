"""The benchmark's inputs: the lexicon's surface -> basic-form table and
tiers, and the corpus tokens.

Frozen copies of the port's generators (`repro_torch/core/analyzer.py`
`Analyzer.__init__` and `repro_torch/core/corpus.py::generate_corpus`),
kept here so that a change to the program cannot change what it is
measured on.  Both are drawn from seeds in the configuration, not from a
run's `--seed`: a deployment's dictionary and the documents of its shard
are fixed, and each seed then runs the same work in another order (the
traffic's requests are a fixed pool too: bench/generator.py).
"""
from __future__ import annotations

import dataclasses

import numpy as np

TIER_STOP, TIER_FREQUENT, TIER_ORDINARY = 0, 1, 2


def seed_words(seed: int) -> list[int]:
    """A seed of any size or sign as SeedSequence words (non-negative)."""
    s = int(seed) % (1 << 128)
    return [s & 0xFFFFFFFF, (s >> 32) & 0xFFFFFFFF, (s >> 64) & 0xFFFFFFFF,
            s >> 96]


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """An independent generator per (seed, tags): each input stream draws
    from its own."""
    return np.random.default_rng(seed_words(seed) + list(tags))


@dataclasses.dataclass(frozen=True)
class Lexicon:
    """primary / secondary: [n_surface] int32 basic forms (-1: none);
    base_tier: [n_base] int8 (0 stop, 1 frequent, 2 ordinary)."""
    n_surface: int
    n_base: int
    n_stop: int
    n_frequent: int
    primary: np.ndarray
    secondary: np.ndarray
    base_tier: np.ndarray

    @property
    def form_offsets(self) -> np.ndarray:
        counts = 1 + (self.secondary >= 0).astype(np.int64)
        out = np.zeros(self.n_surface + 1, np.int64)
        np.cumsum(counts, out=out[1:])
        return out

    @property
    def form_ids(self) -> np.ndarray:
        off = self.form_offsets
        out = np.empty(off[-1], np.int32)
        out[off[:-1]] = self.primary
        has = self.secondary >= 0
        out[off[1:][has] - 1] = self.secondary[has]
        return out

    def forms(self, surface: int) -> list[int]:
        s = int(self.secondary[surface])
        return [int(self.primary[surface])] + ([s] if s >= 0 else [])

    def surface_has_stop(self) -> np.ndarray:
        """[n_surface] bool: the surface has a stop basic form."""
        sec = self.secondary
        return (self.primary < self.n_stop) | ((sec >= 0) & (sec < self.n_stop))


def make_lexicon(config: dict) -> Lexicon:
    """The surface -> basic-form table of a configuration, from its
    `lexicon` sizes and `lexicon_seed`: a monotone primary map (Zipf rank
    of the surface -> rank of the basic form) and, for `multi_form_frac`
    of the surfaces, a log-uniform second form.  Basic-form ids are
    frequency ranks, so the tiers are ranges: [0, n_stop) stop, then
    n_frequent frequent, the rest ordinary."""
    cfg, seed = config["lexicon"], int(config["lexicon_seed"])
    n_s, n_b = int(cfg["n_surface"]), int(cfg["n_base"])
    n_stop, n_freq = int(cfg["n_stop"]), int(cfg["n_frequent"])
    if not (n_stop + n_freq < n_b <= n_s) or n_stop > 1024:
        raise ValueError(f"bad lexicon sizes {cfg}")
    rng = np.random.default_rng(int(seed) + 0xA11A)
    primary = (np.arange(n_s, dtype=np.int64) * n_b // n_s).astype(np.int32)
    has_second = rng.random(n_s) < float(cfg["multi_form_frac"])
    log_rank = rng.uniform(0.0, np.log(n_b), size=n_s)
    secondary = np.exp(log_rank).astype(np.int32) % n_b
    has_second &= secondary != primary
    tier = np.full(n_b, TIER_ORDINARY, np.int8)
    tier[:n_stop] = TIER_STOP
    tier[n_stop:n_stop + n_freq] = TIER_FREQUENT
    return Lexicon(n_s, n_b, n_stop, n_freq, primary,
                   np.where(has_second, secondary, -1).astype(np.int32), tier)


def zipf_probs(n: int, s: float) -> np.ndarray:
    p = np.arange(1, n + 1, dtype=np.float64) ** (-s)
    return p / p.sum()


def make_corpus(cfg: dict, lex: Lexicon):
    """The corpus of configuration `cfg` (its corpus keys at the top level),
    from its `corpus_seed`: (doc_offsets [n_docs + 1] int64, tokens [T]
    int32 surface ids).  Log-normal document lengths, Zipf draws over the
    surfaces with the stop surfaces re-weighted to carry `stop_mass` of the
    tokens, then in-document burstiness (a token re-drawn from up to 63
    positions earlier in its document)."""
    rng = rng_for(int(cfg["corpus_seed"]), 0xC0)
    probs = zipf_probs(lex.n_surface, float(cfg["lexicon"]["zipf_s"]))
    stop_mass = cfg.get("stop_mass")
    if stop_mass is not None:
        mask = lex.surface_has_stop()
        t, q = float(stop_mass), float(probs[mask].sum())
        if not (0.0 < t < 1.0 and 0.0 < q < 1.0):
            raise ValueError(f"degenerate stop_mass {t} / raw mass {q}")
        alpha = t * (1.0 - q) / (q * (1.0 - t))
        probs = np.where(mask, probs * alpha, probs)
        probs = probs / probs.sum()
    n_docs = int(cfg["n_docs"])
    lengths = rng.lognormal(np.log(float(cfg["mean_doc_len"])),
                            float(cfg["sigma_doc_len"]), n_docs)
    lengths = np.maximum(lengths.astype(np.int64), 8)
    doc_offsets = np.zeros(n_docs + 1, np.int64)
    np.cumsum(lengths, out=doc_offsets[1:])
    total = int(doc_offsets[-1])
    tokens = np.searchsorted(np.cumsum(probs), rng.random(total)).astype(np.int32)
    np.minimum(tokens, lex.n_surface - 1, out=tokens)
    burst = float(cfg["burstiness"])
    if burst > 0:
        lag = rng.integers(1, 64, size=total)
        src = np.maximum(np.arange(total) - lag, 0)
        doc_of = np.repeat(np.arange(n_docs), lengths)
        take = (rng.random(total) < burst) & (doc_of[src] == doc_of)
        tokens[take] = tokens[src[take]]
    return doc_offsets, tokens
