"""Synthetic text corpus with Zipfian token statistics.

The paper's experiments index 45 GB of fiction/magazine text (~130k documents).
We synthesize a corpus with the same *statistical* drivers: Zipf token
frequencies (so the top-700 basic forms carry a large share of token mass),
log-normal document lengths, and mild topical burstiness (a document re-uses
the ordinary words it has already used, which makes first-occurrence
compression in stream 1 meaningful, exactly as in real text).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.lexicon import LexiconConfig


@dataclasses.dataclass(frozen=True)
class CorpusConfig:
    n_docs: int = 2_000
    mean_doc_len: float = 900.0
    sigma_doc_len: float = 0.6
    burstiness: float = 0.25   # prob. of re-sampling a recent token in-doc
    seed: int = 0
    stop_mass: float | None = None
                               # target share of tokens carrying a stop basic
                               # form.  The raw Zipf draw over this synthetic
                               # lexicon lands at ~64% stop tokens — far
                               # above real running text (~40% in English
                               # fiction; the paper's 700-lemma Russian list
                               # is comparable) — which inflates every
                               # additional-index-over-corpus ratio.  When
                               # set (and `generate_corpus` is given the
                               # stop-surface mask), stop-surface
                               # probabilities are rescaled so the expected
                               # stop share hits this target; None keeps the
                               # raw Zipf draw.


@dataclasses.dataclass
class Corpus:
    """doc_offsets: [n_docs+1] int64 into tokens; tokens: [T] int32 surface ids."""

    doc_offsets: np.ndarray
    tokens: np.ndarray

    @property
    def n_docs(self) -> int:
        return len(self.doc_offsets) - 1

    @property
    def n_tokens(self) -> int:
        return int(self.doc_offsets[-1])

    def doc(self, i: int) -> np.ndarray:
        return self.tokens[self.doc_offsets[i] : self.doc_offsets[i + 1]]

    def doc_ids_per_token(self) -> np.ndarray:
        """[T] int32 document id of every token."""
        out = np.zeros(self.n_tokens, dtype=np.int32)
        out[self.doc_offsets[1:-1]] = 1
        return np.cumsum(out, dtype=np.int32)

    def positions_per_token(self) -> np.ndarray:
        """[T] int32 in-document ordinal of every token (paper's P)."""
        t = np.arange(self.n_tokens, dtype=np.int64)
        starts = np.repeat(self.doc_offsets[:-1], np.diff(self.doc_offsets))
        return (t - starts).astype(np.int32)


def zipf_probs(n: int, s: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-s)
    return p / p.sum()


def generate_corpus(lex_cfg: LexiconConfig, cfg: CorpusConfig,
                    stop_mask: np.ndarray | None = None) -> Corpus:
    """`stop_mask` ([n_surface] bool: surface has a stop basic form) enables
    the `cfg.stop_mass` re-weighting — scale stop-surface probabilities by
    the unique factor that moves the expected stop-token share from the raw
    Zipf mass q to the target t (α = t(1-q) / (q(1-t))), then renormalize.
    Rank order within each class is untouched, so the corpus stays Zipfian.
    """
    rng = np.random.default_rng(cfg.seed + 0xC0)
    probs = zipf_probs(lex_cfg.n_surface, lex_cfg.zipf_s)
    if cfg.stop_mass is not None:
        if stop_mask is None:
            raise ValueError(
                "CorpusConfig.stop_mass is set but generate_corpus got no "
                "stop_mask — the re-weighting would silently no-op (pass "
                "the [n_surface] stop-surface mask; see benchmarks/common)")
        t = float(cfg.stop_mass)
        q = float(probs[stop_mask].sum())
        if not (0.0 < t < 1.0 and 0.0 < q < 1.0):
            raise ValueError(f"degenerate stop_mass target {t} / raw mass {q}")
        alpha = t * (1.0 - q) / (q * (1.0 - t))
        probs = np.where(stop_mask, probs * alpha, probs)
        probs = probs / probs.sum()

    lengths = rng.lognormal(np.log(cfg.mean_doc_len), cfg.sigma_doc_len, cfg.n_docs)
    lengths = np.maximum(lengths.astype(np.int64), 8)
    doc_offsets = np.zeros(cfg.n_docs + 1, dtype=np.int64)
    np.cumsum(lengths, out=doc_offsets[1:])
    total = int(doc_offsets[-1])

    # Base Zipf draw for every token (inverse-CDF; fast for multi-million T).
    cdf = np.cumsum(probs)
    tokens = np.searchsorted(cdf, rng.random(total)).astype(np.int32)

    # Burstiness: with prob `burstiness`, replace a token with one drawn from a
    # short window earlier in the same document (vectorized approximation of
    # per-doc topical re-use).
    if cfg.burstiness > 0:
        lag = rng.integers(1, 64, size=total)
        src = np.maximum(np.arange(total) - lag, 0)
        doc_of = np.repeat(np.arange(cfg.n_docs), lengths)
        same_doc = doc_of[src] == doc_of
        take = (rng.random(total) < cfg.burstiness) & same_doc
        tokens[take] = tokens[src[take]]

    return Corpus(doc_offsets=doc_offsets, tokens=tokens)
