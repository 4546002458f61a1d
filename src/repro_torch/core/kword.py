"""K-word proximity search over multi-component keys (arXiv:2009.02684).

The improved K-word proximity algorithm asks: find documents (and anchor
occurrences) where ALL K query words fall inside one (window + 1)-wide
position span — any order, any mix of stop / frequent / ordinary forms.
The additional indexes of arXiv:1801.09079 / 1812.07640 make the stop-heavy
case cheap: the planner (`Planner._plan_kword`, QTYPE_KWORD) decomposes the
query into a minimal multi-component-key *cover* — a (s1, s2, anchor)
triple as the anchor seed filter when one is admissible, (s, anchor) pairs
for the remaining stop slots, expanded pairs for frequent slots, ordinary /
basic postings as the last resort — every choice by occ-count cost, so the
plan reads measurably fewer postings than a Sphinx-style full-list plan.

Join semantics
--------------
An anchor occurrence p matches iff there is one occurrence per remaining
slot, in p's document, such that max(positions incl. p) - min <= window.
Equivalently: some window start t in [-W, 0] (relative to p) has every
slot's candidate set intersect [p + t, p + t + W].  Both executors decide
that with per-slot *delta masks* — bit (d + W) set iff the slot has a
candidate at signed offset d from p — then AND the per-slot window scans
(`t_bits`) over all slots:

  * device: `ops.banded_delta_mask_rows` (the masks and their
    `delta_mask_t_bits` from one kernel launch on the card) +
    `ops.kword_window_hits` (int32 lanes => W <= KW_DEVICE_MAX_WINDOW;
    wider windows ride the flex escape exactly like cap-overflowing
    plans);
  * flex (this module): the same math in host numpy int64
    (W <= KW_FLEX_MAX_WINDOW).

The ranked path reuses the banded min-delta score accumulation
(arXiv:2108.00410): every constraint group's score contribution is the
in-band minimum key distance, accumulated in the canonical float32 order;
only the *found* bit is overridden by the span join — a span match implies
an in-band hit for every group, so scores of surviving anchors are
bit-identical to the near-mode accumulation the executors already share.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.lexicon import TIER_ORDINARY, TIER_STOP

MODE_KWORD = "kword"

# Device (batched / serve) kword window cap: the delta mask keeps bit
# (d + W) <= 30 inside an int32 lane (kernels/ops._KW_MAX_BAND).  Wider
# windows are valid requests and route to the flexible executor, whose
# int64 host masks reach KW_FLEX_MAX_WINDOW.
KW_DEVICE_MAX_WINDOW = 15
KW_FLEX_MAX_WINDOW = 31


def pick_kword_anchor(tiered, occ_counts) -> int:
    """The rarest non-stop slot (ordinary preferred) — same statistic as the
    near-mode pivot rule, on the same CLUSTER-GLOBAL counts, so doc-sharded
    deployments anchor every shard identically (the bit-identity
    precondition).  tiered: [(tier, [forms]), ...] per slot."""
    ordinary = [i for i, (t, _) in enumerate(tiered) if t == TIER_ORDINARY]
    eligible = ordinary or [i for i, (t, _) in enumerate(tiered)
                            if t != TIER_STOP]
    if not eligible:
        return -1                    # all-stop tier combination: no anchor
    return min(eligible,
               key=lambda i: sum(int(occ_counts[f]) for f in tiered[i][1]))


# ---------------------------------------------------------------------------
# flex-path span join (host numpy, int64 masks)
# ---------------------------------------------------------------------------

def kword_delta_mask(a: np.ndarray, b_sorted: np.ndarray,
                     window: int) -> np.ndarray:
    """int64 delta mask per anchor key: bit (d + window) set iff `b_sorted`
    holds a + d, for each signed d in [-window, window].  Anchor and
    candidate keys share the global (doc << POS_BITS | pos) codec, so key
    arithmetic IS position arithmetic inside one document (the PHRASE_BIAS
    headroom guarantees d never borrows across the doc boundary)."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b_sorted, np.int64)
    mask = np.zeros(a.shape, np.int64)
    for d in range(-window, window + 1):
        lo = np.searchsorted(b, a + d, side="left")
        hi = np.searchsorted(b, a + d, side="right")
        mask |= np.where(hi > lo, np.int64(1) << (d + window), np.int64(0))
    return mask


def kword_t_bits(mask: np.ndarray, window: int) -> np.ndarray:
    """Window scan of one slot's delta mask: bit t set iff the slot has a
    candidate inside the window starting at offset t - window from the
    anchor (t in [0, window]).  The K-way combine is a plain AND."""
    low = (np.int64(1) << (window + 1)) - 1
    bits = np.zeros_like(mask)
    for t in range(window + 1):
        bits |= np.where((mask >> t) & low != 0,
                         np.int64(1) << t, np.int64(0))
    return bits


def kword_span_ok(a: np.ndarray, group_keys: list, window: int) -> np.ndarray:
    """bool per anchor key: every group in `group_keys` (sorted int64 key
    arrays, sentinel-padded) has a candidate inside one shared
    (window + 1)-wide span containing the anchor — the flexible executor's
    K-way windowed join (device twin: ops.kword_window_hits)."""
    t_and = np.full(np.asarray(a).shape, -1, np.int64)
    for b in group_keys:
        t_and &= kword_t_bits(kword_delta_mask(a, b, window), window)
    return t_and != 0
