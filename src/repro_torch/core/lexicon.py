"""Three-tier lexicon over *basic forms* (lemmas), per Veretennikov 2013.

The paper classifies the basic forms of words (not surface forms) into three
frequency tiers:

  * stop basic forms        (paper: 700 most frequent)
  * frequently-used forms   (paper: next 2 100)
  * ordinary forms          (everything else)

Basic-form IDs are assigned in frequency-rank order (id 0 = most frequent), so
tier membership is a pure range check and never needs a table lookup on device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

TIER_STOP = 0
TIER_FREQUENT = 1
TIER_ORDINARY = 2

TIER_NAMES = {TIER_STOP: "stop", TIER_FREQUENT: "frequent", TIER_ORDINARY: "ordinary"}


@dataclasses.dataclass(frozen=True)
class LexiconConfig:
    """Synthetic-lexicon parameters.

    The paper's absolute tier sizes (700 stop / 2100 frequent) are kept; the
    vocabulary is scaled from Russian's ~200k basic forms to keep test-corpus
    build times reasonable while preserving the Zipf shape that makes the
    technique matter.
    """

    n_surface: int = 50_000       # surface vocabulary size
    n_base: int = 40_000          # number of distinct basic forms
    n_stop: int = 700             # paper: 700
    n_frequent: int = 2_100       # paper: 2100
    multi_form_frac: float = 0.12  # fraction of surfaces with 2 basic forms
    zipf_s: float = 1.0           # Zipf exponent for token sampling
    seed: int = 0

    def __post_init__(self):
        assert self.n_stop + self.n_frequent < self.n_base
        assert self.n_base <= self.n_surface


class Lexicon:
    """Tier structure over basic forms.

    Attributes
    ----------
    base_tier : [n_base] int8 — tier of each basic form.
    stop_local : [n_base] int32 — dense local id (0..n_stop-1) for stop forms,
        -1 otherwise.  Local ids are what gets packed into stop-phrase keys
        (10 bits each; requires n_stop <= 1024).
    """

    def __init__(self, config: LexiconConfig):
        self.config = config
        n = config.n_base
        self.base_tier = np.full(n, TIER_ORDINARY, dtype=np.int8)
        self.base_tier[: config.n_stop] = TIER_STOP
        self.base_tier[config.n_stop : config.n_stop + config.n_frequent] = TIER_FREQUENT
        self.stop_local = np.full(n, -1, dtype=np.int32)
        self.stop_local[: config.n_stop] = np.arange(config.n_stop, dtype=np.int32)
        if config.n_stop > 1024:
            raise ValueError("stop-phrase key packing supports at most 1024 stop forms")

    # -- tier predicates (vectorized over basic-form id arrays) --------------
    def tier(self, base_ids: np.ndarray) -> np.ndarray:
        return self.base_tier[base_ids]

    def is_stop(self, base_ids: np.ndarray) -> np.ndarray:
        return base_ids < self.config.n_stop

    def is_frequent(self, base_ids: np.ndarray) -> np.ndarray:
        c = self.config
        return (base_ids >= c.n_stop) & (base_ids < c.n_stop + c.n_frequent)

    def is_ordinary(self, base_ids: np.ndarray) -> np.ndarray:
        return base_ids >= self.config.n_stop + self.config.n_frequent

    def processing_distance(self, base_ids: np.ndarray) -> np.ndarray:
        """Paper: ProcessingDistance depends on the frequency of w (5..7).

        More frequent words get a *larger* window (they appear in more set
        phrases); we linearly step 7 -> 5 across the frequent tier.
        """
        c = self.config
        rank_in_tier = np.clip(base_ids - c.n_stop, 0, c.n_frequent - 1)
        third = c.n_frequent // 3  # thirds of the frequent tier
        pd = 7 - rank_in_tier // max(third, 1)
        return np.clip(pd, 5, 7).astype(np.int32)
