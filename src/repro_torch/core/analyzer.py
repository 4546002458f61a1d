"""Simulated morphological analyzer: surface word -> list of basic forms.

The paper's analyzer (Russian dictionary, ~200k basic forms) maps each surface
word form to one or more basic-form numbers; e.g. <rose> -> {rise, rose}.  The
dictionary is unavailable, so we synthesize a deterministic analyzer with the
properties the algorithms actually depend on:

  * every surface form has >= 1 basic form;
  * a configurable fraction has a second basic form;
  * second forms may land in a *different* frequency tier, exercising the
    paper's query-splitting rule (PROCESSING QUERIES section);
  * basic-form frequency ranks follow the surface Zipf ranks, so tier
    membership (stop / frequent / ordinary) is realistic.

If a word is absent from the dictionary the paper treats the word itself as
its basic form — here every surface id maps onto the basic-form range, so the
fallback is implicit.

Layout is CSR so that both host (numpy) and device (torch) sides can consume it.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.lexicon import Lexicon, LexiconConfig


class Analyzer:
    """CSR map surface-id -> basic-form ids.

    Attributes
    ----------
    form_offsets : [n_surface + 1] int64
    form_ids     : [total_forms] int32  (basic-form ids)
    """

    def __init__(self, config: LexiconConfig):
        self.config = config
        rng = np.random.default_rng(config.seed + 0xA11A)
        n_s, n_b = config.n_surface, config.n_base

        # Primary basic form: monotone surjection surface-rank -> base-rank,
        # preserving Zipf ordering (surface 0 = most frequent maps to base 0).
        primary = (np.arange(n_s, dtype=np.int64) * n_b // n_s).astype(np.int32)

        # Secondary basic form for a random subset ("rose" -> {rise, rose}).
        has_second = rng.random(n_s) < config.multi_form_frac
        # Log-uniform rank so second forms span all tiers (incl. stop forms --
        # needed to exercise query splitting).
        log_rank = rng.uniform(0.0, np.log(n_b), size=n_s)
        secondary = np.exp(log_rank).astype(np.int32) % n_b
        has_second &= secondary != primary

        counts = 1 + has_second.astype(np.int64)
        self.form_offsets = np.zeros(n_s + 1, dtype=np.int64)
        np.cumsum(counts, out=self.form_offsets[1:])
        self.form_ids = np.empty(self.form_offsets[-1], dtype=np.int32)
        self.form_ids[self.form_offsets[:-1]] = primary
        self.form_ids[self.form_offsets[1:][has_second] - 1] = secondary[has_second]

        self._primary = primary
        self._secondary = np.where(has_second, secondary, -1).astype(np.int32)

    # -- vectorized accessors -------------------------------------------------
    @property
    def primary(self) -> np.ndarray:
        """[n_surface] int32 primary basic form."""
        return self._primary

    @property
    def secondary(self) -> np.ndarray:
        """[n_surface] int32 second basic form or -1."""
        return self._secondary

    def forms_of(self, surface_id: int) -> list[int]:
        lo, hi = self.form_offsets[surface_id], self.form_offsets[surface_id + 1]
        return self.form_ids[lo:hi].tolist()

    def forms_batch(self, surface_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Dense [N, 2] int32 forms (-1 pad) + [N] counts, vectorized."""
        prim = self._primary[surface_ids]
        sec = self._secondary[surface_ids]
        out = np.stack([prim, sec], axis=-1).astype(np.int32)
        return out, 1 + (sec >= 0).astype(np.int32)


def make_lexicon_and_analyzer(config: LexiconConfig) -> tuple[Lexicon, Analyzer]:
    return Lexicon(config), Analyzer(config)
