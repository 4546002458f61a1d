"""Query planning (paper: ANSWERING QUERIES / PROCESSING QUERIES).

The planner runs host-side.  It

  1. expands each query word into its basic forms (morphological analyzer),
  2. *splits* the query whenever one word's forms span different frequency
     tiers (the paper's PROCESSING QUERIES rule) -- one subquery per tier
     combination, results to be unioned,
  3. classifies every subquery into the paper's Type 1-4 — plus Type 5
     (QTYPE_MULTI), this repo's multi-component-key plan: a NEAR-mode
     subquery containing stop forms is no longer confined to sequential
     matching (the paper's Type-4 rule); it splits around its stop words
     into multi-key lookups ((s, pivot) pairs / (s1, s2, pivot) triples,
     arXiv:1812.07640 / 2006.07954) plus the residual ordinary/expanded
     fetches, all keyed at the pivot position — true windowed semantics,
  4. resolves every posting fetch down to explicit (start, length) slices in
     the index arrays, so the device executor is pure array math,
  5. accounts the paper's primary metric -- the number of postings read.

Plan vocabulary
---------------
A *FetchGroup* is the union of posting lists standing in for one query slot
(one group per slot; several fetches per group when a slot has several basic
forms or a stop-phrase part has several form combinations).  The executor
turns each group into a sorted array of anchor keys and intersects the groups
(band-width 0 = precise phrase; W > 0 = word-set-with-distance).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np

from repro_torch.core.builder import IndexSet
from repro_torch.core.kword import MODE_KWORD, pick_kword_anchor
from repro_torch.core.lexicon import TIER_FREQUENT, TIER_ORDINARY, TIER_STOP
from repro_torch.core.postings import MAX_STOP_PHRASE_LEN

MODE_PHRASE = "phrase"   # precise: order + adjacency
MODE_NEAR = "near"       # word set: all words within a window of the pivot

QTYPE_MULTI = 5          # windowed near+stop via multi-component keys
QTYPE_KWORD = 6          # K-word span proximity via multi-key cover


@dataclasses.dataclass(frozen=True)
class ResolvedFetch:
    stream: str                    # 'basic' | 'first' | 'expanded' | 'stop'
    start: int
    length: int
    offset: int                    # phrase offset of the *stored/anchor* word
    required_dist: Optional[int] = None   # expanded, phrase mode: exact dist
    max_abs_dist: Optional[int] = None    # expanded, near mode: |dist| <= W
    pivot_from_dist: bool = False  # expanded, near mode: pivot pos = pos + dist
    stop_checks: tuple = ()        # ((delta, stop_local), ...) via stream 3
    read_near_stop: bool = False   # stream 3 is read alongside (counts twice)
    # ranking metadata (arXiv:2108.00410): this fetch's postings are keyed at
    # the anchor and their |dist| payload IS the slot word's distance from it
    # (near-mode expanded / multi-key fetches) — the score contribution reads
    # w(|dist|).  False => the slot's distance is the banded key distance
    # (full-list fetches) or 0 (precise-phrase keys).
    score_delta_from_dist: bool = False

    @property
    def postings_read(self) -> int:
        return self.length * (2 if self.read_near_stop else 1)


@dataclasses.dataclass
class FetchGroup:
    slot: int
    fetches: list[ResolvedFetch]
    band: int = 0                  # intersection band width vs. the anchor
    score_slot: Optional[int] = None   # the query slot this group scores
                                       # (None: covers several slots / a part)

    @property
    def postings_read(self) -> int:
        return sum(f.postings_read for f in self.fetches)


@dataclasses.dataclass
class SubPlan:
    qtype: int                     # 1..4 (paper's query types)
    mode: str
    groups: list[FetchGroup]
    fallback_groups: list[FetchGroup] = dataclasses.field(default_factory=list)
    supported: bool = True
    note: str = ""
    n_slots: int = 0               # query slots of this tier combination —
                                   # the ranked executors' per-anchor score is
                                   # biased by (n_slots - len(groups)) so
                                   # every slot contributes exactly once even
                                   # when groups merge or imply slots
    kw_window: Optional[int] = None  # QTYPE_KWORD only: the span width W —
                                     # every constraint group is banded at W
                                     # and the executors run the K-way
                                     # windowed join instead of pairwise
                                     # membership (core/kword.py)

    @property
    def postings_read(self) -> int:
        return sum(g.postings_read for g in self.groups)


@dataclasses.dataclass
class QueryPlan:
    subplans: list[SubPlan]        # results are unioned (query splitting)

    @property
    def postings_read(self) -> int:
        return sum(p.postings_read for p in self.subplans)


# ---------------------------------------------------------------------------


def pick_pivot(tiered, occ_counts) -> int:
    """Paper's 'basic word': the rarest non-stop slot (ordinary preferred)."""
    ordinary = [i for i, (t, _) in enumerate(tiered) if t == TIER_ORDINARY]
    eligible = ordinary or [i for i, (t, _) in enumerate(tiered) if t != TIER_STOP]
    return min(eligible, key=lambda i: sum(int(occ_counts[f]) for f in tiered[i][1]))


def split_query_parts(n: int, min_len: int, max_len: int) -> list[tuple[int, int]]:
    """Split an n-word stop phrase into (start, length) parts with
    min_len <= length <= max_len, covering every word; the final part may
    overlap its predecessor when the tail would otherwise be too short."""
    parts = []
    i = 0
    while i < n:
        L = min(max_len, n - i)
        if L < min_len:                       # short tail: overlap backwards
            parts.append((n - min_len, min_len))
            break
        rem = n - i - L
        if 0 < rem < min_len:                 # shrink so the tail is viable
            L = max(L - (min_len - rem), min_len)
        parts.append((i, L))
        i += L
    return parts


class Planner:
    def __init__(self, index: IndexSet, windowed_near_stop: bool = True,
                 occ_counts=None):
        self.index = index
        self.lex = index.lexicon
        # `occ_counts` overrides the pivot/seed statistics with CLUSTER-WIDE
        # counts: a doc-sharded deployment (serve.front) plans every shard
        # with the global numbers so pick_pivot lands on the same slot
        # everywhere — the precondition for bit-identical shard merges.
        self.refresh_occ_counts(occ_counts)
        # expanded-pair reach per basic form: max(ProcessingDistance,
        # near_window) — precomputed once; planning is on the per-query
        # latency path
        self._pair_reach = np.maximum(
            index.lexicon.processing_distance(
                np.arange(index.lexicon.config.n_base)),
            index.params.near_window)
        # True (default): near-mode subqueries containing stop forms get the
        # multi-component-key windowed plan (QTYPE_MULTI).  False restores
        # the paper's Type-4 sequential confinement (kept for the benchmark's
        # before/after comparison).
        self.windowed_near_stop = windowed_near_stop

    # -- public API ---------------------------------------------------------

    def refresh_occ_counts(self, occ_counts=None):
        """Re-snapshot the pivot/seed occurrence statistics.

        The counts are deliberately a snapshot (planning must not race a
        mutating index), but a mutable corpus — segments landing via
        `core.segments.SegmentManager` — must re-snapshot on every
        generation bump or pivot choice drifts from the true statistics.
        `occ_counts=None` re-reads the planner's own index; pass the
        cluster-global sum for doc-sharded / segmented deployments."""
        self._occ_counts = (self.index.base_occ_counts() if occ_counts is None
                            else np.asarray(occ_counts))

    def plan(self, surface_ids: list[int], mode: str = MODE_PHRASE,
             window: Optional[int] = None, ranked: bool = False) -> QueryPlan:
        """`ranked=True` plans for per-slot proximity scoring: multi-key stop
        slots stay one pair group per slot (no triple merging, no identical-
        form-set dedup) so every slot carries its own distance payload —
        match semantics are identical, only the group decomposition differs.
        """
        if window is None:
            if mode == MODE_KWORD:
                # kword windows are semantic (the span width) — no implicit
                # default; SearchRequest.__post_init__ enforces the same
                raise ValueError("kword mode requires an explicit window")
            # near-mode default: the near window (2*(MaxLength-1)) — every
            # slot of the paper's 2.2 every-other-word procedure is within
            # reach of any pivot, making source recall structural
            window = self.index.params.near_window
        form_lists = [self.index.analyzer.forms_of(s) for s in surface_ids]
        subplans = []
        for tiered in self._split_by_tier(form_lists):
            sp = self._plan_subquery(tiered, mode, window, ranked)
            sp.n_slots = len(tiered)
            subplans.append(sp)
        return QueryPlan(subplans=subplans)

    # -- query splitting (paper: PROCESSING QUERIES) -------------------------

    def _split_by_tier(self, form_lists):
        """Yield per-slot (tier, [forms]) lists, one per tier combination."""
        per_slot_choices = []
        for forms in form_lists:
            tiers = {}
            for f in forms:
                tiers.setdefault(int(self.lex.base_tier[f]), []).append(f)
            per_slot_choices.append(sorted(tiers.items()))
        for combo in itertools.product(*per_slot_choices):
            yield list(combo)   # [(tier, [forms]), ...] per slot

    # -- classification + dispatch ------------------------------------------

    def _plan_subquery(self, tiered, mode, window, ranked=False) -> SubPlan:
        tiers = [t for t, _ in tiered]
        if mode == MODE_KWORD:
            return self._plan_kword(tiered, window, ranked)
        if all(t == TIER_STOP for t in tiers):
            return self._plan_type1(tiered)
        if any(t == TIER_STOP for t in tiers):
            if mode == MODE_NEAR and self.windowed_near_stop:
                return self._plan_type5(tiered, window, ranked)
            return self._plan_type4(tiered, mode, window)
        if all(t == TIER_FREQUENT for t in tiers):
            return self._plan_type2(tiered, mode, window)
        return self._plan_type3(tiered, mode, window)

    # -- helpers --------------------------------------------------------------

    def _slot_count(self, forms) -> int:
        return int(sum(self._occ_counts[f] for f in forms))

    def _pick_pivot(self, tiered) -> int:
        return pick_pivot(tiered, self._occ_counts)

    def _basic_group(self, slot, forms, band=0, first_only=False) -> FetchGroup:
        idx = self.index.basic.first_occ if first_only else self.index.basic.occurrences
        stream = "first" if first_only else "basic"
        fetches = []
        for f in forms:
            s, e = idx.find(f)
            if e > s:
                fetches.append(ResolvedFetch(stream=stream, start=s, length=e - s,
                                             offset=slot))
        return FetchGroup(slot=slot, fetches=fetches, band=band,
                          score_slot=slot)

    def _pivot_group(self, slot, forms, stop_checks) -> FetchGroup:
        """Pivot occurrences verified against near-stop stream 3 (Type 4)."""
        fetches = []
        for f in forms:
            s, e = self.index.basic.occurrences.find(f)
            if e > s:
                fetches.append(ResolvedFetch(
                    stream="basic", start=s, length=e - s, offset=slot,
                    stop_checks=tuple(stop_checks), read_near_stop=bool(stop_checks)))
        return FetchGroup(slot=slot, fetches=fetches, band=0)

    def _expanded_group(self, slot, forms, pivot_slot, pivot_forms, mode, window) -> Optional[FetchGroup]:
        """Union of expanded (w, v=pivot) fetches over form combinations.

        Returns None when the expanded index CANNOT cover the slot — the
        required distance / window exceeds the pair reach
        (max(ProcessingDistance, near_window)) for some orientation, so a
        lookup would silently under-cover.  The caller must then fall back
        to a basic fetch for the slot (paper Type 3: "In the case of words
        for which no expanded index exists, we use an ordinary index").

        Returns a fetchless group when every combination was looked up
        within reach and no pair exists — then no within-reach match exists
        anywhere and the group correctly kills the subplan."""
        exp = self.index.expanded
        fetches = []
        for w, v in itertools.product(forms, pivot_forms):
            for stored_w, stored_v, mirrored in ((w, v, False), (v, w, True)):
                reach = int(self._pair_reach[stored_w])
                rd = (slot - pivot_slot) if mirrored else (pivot_slot - slot)
                if (abs(rd) if mode == MODE_PHRASE else window) > reach:
                    return None      # under-coverage: slot needs basic fetches
                s, e = exp.pairs.find(stored_w * exp.n_base + stored_v)
                if e == s:
                    continue
                # stored postings: (doc, pos of stored_w, dist to stored_v)
                anchor_offset = pivot_slot if mirrored else slot
                if mode == MODE_PHRASE:
                    fetches.append(ResolvedFetch(
                        stream="expanded", start=s, length=e - s,
                        offset=anchor_offset, required_dist=rd))
                else:
                    fetches.append(ResolvedFetch(
                        stream="expanded", start=s, length=e - s,
                        offset=anchor_offset, max_abs_dist=window,
                        pivot_from_dist=not mirrored,
                        score_delta_from_dist=True))
                break   # canonical orientation found
        return FetchGroup(slot=slot, fetches=fetches, band=0, score_slot=slot)

    def _fallback_groups(self, tiered) -> list[FetchGroup]:
        """Distance-disregarding doc search: stream 1 only (paper step 3)."""
        groups = []
        for i, (t, forms) in enumerate(tiered):
            if t == TIER_STOP:
                continue    # stop words carry no meaning doc-level
            groups.append(self._basic_group(i, forms, first_only=True))
        return groups

    # -- Type 1: all stop words ----------------------------------------------

    def _plan_type1(self, tiered) -> SubPlan:
        n = len(tiered)
        p = self.index.params
        if n < p.min_len:
            return SubPlan(qtype=1, mode=MODE_PHRASE, groups=[], supported=False,
                           note="single stop word: not indexed (paper: stop words "
                                "are never searched alone)")
        # split into parts of <= MaxLength (paper: EXPERIMENTS "the phrase may
        # be divided into parts ... results are combined")
        parts = split_query_parts(n, p.min_len, p.max_len)
        groups = []
        for part_start, L in parts:
            fetches = []
            slot_forms = [tiered[part_start + j][1] for j in range(L)]
            for combo in itertools.product(*slot_forms):
                locals_ = [int(self.lex.stop_local[f]) for f in combo]
                s, e = self.index.stop_phrase.find(locals_)
                if e > s:
                    fetches.append(ResolvedFetch(stream="stop", start=s,
                                                 length=e - s, offset=part_start))
            groups.append(FetchGroup(slot=part_start, fetches=fetches, band=0))
        return SubPlan(qtype=1, mode=MODE_PHRASE, groups=groups)

    # -- Type 2: all frequently used ------------------------------------------

    def _plan_type2(self, tiered, mode, window) -> SubPlan:
        n = len(tiered)
        pivot = self._pick_pivot(tiered)
        groups = []
        fell_back = False
        if n == 1:
            groups.append(self._basic_group(0, tiered[0][1]))
        else:
            for i, (t, forms) in enumerate(tiered):
                if i == pivot:
                    continue
                g = self._expanded_group(i, forms, pivot, tiered[pivot][1], mode, window)
                if g is None:   # beyond pair reach: exact basic fetches instead
                    g = self._basic_group(i, forms,
                                          band=window if mode == MODE_NEAR else 0)
                    fell_back = True
                groups.append(g)
            if fell_back:
                # basic fallbacks don't imply the pivot's own presence the
                # way expanded (w, pivot) pairs do — and near mode needs a
                # band-0 seed — so the pivot's occurrences join the plan
                groups.insert(0, self._basic_group(pivot, tiered[pivot][1]))
        return SubPlan(qtype=2, mode=mode, groups=groups,
                       fallback_groups=self._fallback_groups(tiered))

    # -- Type 3: no stop, at least one ordinary --------------------------------

    def _plan_type3(self, tiered, mode, window) -> SubPlan:
        pivot = self._pick_pivot(tiered)
        groups = []
        n_expanded = 0
        for i, (t, forms) in enumerate(tiered):
            if i == pivot:
                continue
            g = None
            if t == TIER_FREQUENT:
                g = self._expanded_group(i, forms, pivot, tiered[pivot][1], mode, window)
                if g is not None and g.fetches:
                    n_expanded += 1
            if g is None:
                band = window if mode == MODE_NEAR else 0
                g = self._basic_group(i, forms, band=band)
            groups.append(g)
        # the pivot's own occurrences are needed when no expanded group pins
        # its positions (all-ordinary query) or in near mode (band anchors)
        if n_expanded == 0 or mode == MODE_NEAR:
            groups.insert(0, self._basic_group(pivot, tiered[pivot][1]))
        return SubPlan(qtype=3, mode=mode, groups=groups,
                       fallback_groups=self._fallback_groups(tiered))

    # -- Type 4: stop words mixed with others ----------------------------------

    def _plan_type4(self, tiered, mode, window) -> SubPlan:
        # paper (STRUCTURE OF SEARCH EXPERIMENTS): "If one of the query words
        # has a stop basic form, the search is confined to sequential words."
        mode = MODE_PHRASE
        pivot = self._pick_pivot(tiered)
        p = self.index.params
        stop_checks, unsupported = [], []
        for i, (t, forms) in enumerate(tiered):
            if t != TIER_STOP:
                continue
            delta = i - pivot
            if abs(delta) > p.max_distance:
                unsupported.append(i)
                continue
            # any of the slot's stop forms at the required delta satisfies it
            stop_checks.append((delta, tuple(int(self.lex.stop_local[f]) for f in forms)))
        groups = [self._pivot_group(pivot, tiered[pivot][1], stop_checks)]
        for i, (t, forms) in enumerate(tiered):
            if i == pivot or t == TIER_STOP:
                continue
            g = None
            if t == TIER_FREQUENT:
                g = self._expanded_group(i, forms, pivot, tiered[pivot][1], mode, window)
            if g is None:
                band = window if mode == MODE_NEAR else 0
                g = self._basic_group(i, forms, band=band)
            groups.append(g)
        note = ""
        if unsupported:
            note = f"stop slots {unsupported} beyond MaxDistance of pivot; phrase split required"
        return SubPlan(qtype=4, mode=mode, groups=groups,
                       fallback_groups=self._fallback_groups(tiered), note=note)

    # -- Type 5: windowed near + stop via multi-component keys -----------------

    def _pair_group(self, slot, stop_forms, pivot_forms, window) -> FetchGroup:
        """(s, pivot) two-component lookups: postings are occurrences of s
        with the pivot form within NeighborDistance, keyed at the pivot
        position (pos + dist) and masked to |dist| <= window — band-0
        against the seed, exactly like an expanded near fetch."""
        mk = self.index.multi_key
        fetches = []
        for s, v in itertools.product(stop_forms, pivot_forms):
            st, e = mk.find_pair(int(s), int(v))
            if e > st:
                fetches.append(ResolvedFetch(
                    stream="multi", start=st, length=e - st, offset=slot,
                    max_abs_dist=window, pivot_from_dist=True,
                    score_delta_from_dist=True))
        return FetchGroup(slot=slot, fetches=fetches, band=0, score_slot=slot)

    def _triple_group(self, slot, s1, s2, pivot_forms, window) -> Optional[FetchGroup]:
        """(s1, s2, pivot) three-component lookup covering TWO stop slots in
        one group: postings are pivot occurrences with both stops within
        NeighborDistance, anchored at the pivot position with dist =
        max(nearest |d1|, nearest |d2|) — so |dist| <= window answers "both
        stops inside the window".  None when no pivot form has the key (no
        windowed match can exist: the caller plants an empty group)."""
        mk = self.index.multi_key
        fetches = []
        for v in pivot_forms:
            st, e = mk.find_triple(int(s1), int(s2), int(v))
            if e > st:
                fetches.append(ResolvedFetch(
                    stream="multi", start=st, length=e - st, offset=slot,
                    max_abs_dist=window, pivot_from_dist=False,
                    score_delta_from_dist=True))
        if not fetches:
            return None
        return FetchGroup(slot=slot, fetches=fetches, band=0)

    def _ordinary_band_group(self, slot, forms, window) -> FetchGroup:
        """Escape for window > NeighborDistance: the stop form's full
        ordinary-index posting list, banded against the pivot — correct at
        any window, at the full posting-list cost the multi-key index
        exists to avoid."""
        fetches = []
        for f in forms:
            s, e = self.index.ordinary.find(f)
            if e > s:
                fetches.append(ResolvedFetch(stream="ordinary", start=s,
                                             length=e - s, offset=slot))
        return FetchGroup(slot=slot, fetches=fetches, band=window,
                          score_slot=slot)

    def _multi_key_groups(self, stop_slots, pivot_forms, window,
                          ranked=False) -> list[FetchGroup]:
        """One constraint group per distinct stop-slot form set: identical
        form sets impose identical window constraints (one occurrence may
        satisfy several slots), single-form slots with distinct forms pair
        into three-component lookups, the rest use two-component lookups.

        `ranked` keeps one PAIR group per stop slot (no triple merging, no
        dedup): each slot then carries its own |dist| payload, which is what
        the per-slot proximity score reads.  Triples gated off at build time
        (IndexParams.triple_pair_min_count — uncommon (s1, s2) pairs) fall
        back to the same two pair lookups; semantics are identical either
        way, only postings_read differs."""
        mk = self.index.multi_key
        if window > mk.neighbor_distance:
            return [self._ordinary_band_group(i, forms, window)
                    for i, forms in stop_slots]
        if ranked:
            return [self._pair_group(i, forms, pivot_forms, window)
                    for i, forms in stop_slots]
        uniq, seen = [], set()
        for i, forms in stop_slots:
            key = tuple(sorted(forms))
            if key in seen:
                continue
            seen.add(key)
            uniq.append((i, forms))
        groups = []
        singles = [(i, forms[0]) for i, forms in uniq if len(forms) == 1]
        pair_back = []        # gated (uncommon) triples -> two pair lookups
        for k in range(0, len(singles) - 1, 2):
            (i1, s1), (i2, s2) = singles[k], singles[k + 1]
            if not mk.has_triple_pair(int(s1), int(s2)):
                pair_back.extend([(i1, s1), (i2, s2)])
                continue
            g = self._triple_group(i1, s1, s2, pivot_forms, window)
            if g is None:
                # the stops never co-occur near any pivot form, so the
                # windowed intersection is empty: a fetchless group kills
                # the subplan (the doc-only fallback still runs)
                g = FetchGroup(slot=i1, fetches=[], band=0)
            groups.append(g)
        if len(singles) % 2:
            pair_back.append(singles[-1])
        for i, s in pair_back:
            groups.append(self._pair_group(i, (s,), pivot_forms, window))
        for i, forms in uniq:
            if len(forms) > 1:
                groups.append(self._pair_group(i, forms, pivot_forms, window))
        return groups

    def _plan_type5(self, tiered, window, ranked=False) -> SubPlan:
        """Windowed near-mode subquery containing stop forms: split around
        the stop words (arXiv:1812.07640) — the pivot's own occurrences
        seed, non-stop slots constrain as in Type 3 near, and every stop
        slot becomes a multi-component key lookup keyed at the pivot
        position.  No Type-4 sequential confinement."""
        pivot = self._pick_pivot(tiered)
        pivot_forms = tiered[pivot][1]
        groups = [self._basic_group(pivot, pivot_forms)]
        for i, (t, forms) in enumerate(tiered):
            if i == pivot or t == TIER_STOP:
                continue
            g = None
            if t == TIER_FREQUENT:
                g = self._expanded_group(i, forms, pivot, pivot_forms,
                                         MODE_NEAR, window)
            if g is None:
                g = self._basic_group(i, forms, band=window)
            groups.append(g)
        stop_slots = [(i, forms) for i, (t, forms) in enumerate(tiered)
                      if t == TIER_STOP]
        groups.extend(self._multi_key_groups(stop_slots, pivot_forms, window,
                                             ranked=ranked))
        return SubPlan(qtype=QTYPE_MULTI, mode=MODE_NEAR, groups=groups,
                       fallback_groups=self._fallback_groups(tiered))

    # -- QTYPE_KWORD: K-word span proximity via multi-key cover ----------------

    def _kword_pair_group(self, slot, stop_forms, anchor_forms, window) -> FetchGroup:
        """(s, anchor) two-component lookups for one kword stop slot, keyed
        at the STOP word's own position (pos, not pos + dist): the K-way
        join needs each slot's candidate positions, not pivot echoes.  The
        |dist| <= window mask prunes to postings whose anchor co-occurrence
        is inside the span — every in-band stop occurrence of any matching
        anchor survives it (its own (s, anchor) co-occurrence is within
        W <= NeighborDistance), so the banded in-band set per anchor is
        exactly the full occurrence set's."""
        mk = self.index.multi_key
        fetches = []
        for s, v in itertools.product(stop_forms, anchor_forms):
            st, e = mk.find_pair(int(s), int(v))
            if e > st:
                fetches.append(ResolvedFetch(
                    stream="multi", start=st, length=e - st, offset=slot,
                    max_abs_dist=window, pivot_from_dist=False))
        return FetchGroup(slot=slot, fetches=fetches, band=window,
                          score_slot=slot)

    def _kword_stop_group(self, slot, forms, anchor_forms, window) -> FetchGroup:
        """Cover choice for a kword stop slot: the multi-key pair lookup
        (W <= NeighborDistance only) vs the ordinary full posting list,
        by postings-read cost.  An EMPTY pair group is exact and wins: the
        stop never co-occurs within NeighborDistance >= W of any anchor
        form, so no span match exists and the group kills the subplan
        (the doc-only fallback still runs)."""
        mk = self.index.multi_key
        ordn = self._ordinary_band_group(slot, forms, window)
        if window > mk.neighbor_distance:
            return ordn
        pair = self._kword_pair_group(slot, forms, anchor_forms, window)
        return pair if pair.postings_read <= ordn.postings_read else ordn

    def _kword_expanded_group(self, slot, forms, anchor_forms, window) -> Optional[FetchGroup]:
        """Expanded (w, v) cover for a kword frequent slot, keyed at the
        SLOT word's position: pos itself when the slot word is the stored
        anchor (direct), pos + dist when the query anchor is (mirrored) —
        the inverse of the near-mode pivot keying.  None when the window
        exceeds the pair reach for some orientation (under-coverage: the
        caller falls back to basic fetches); an empty group is exact (no
        within-reach co-occurrence anywhere) and kills the subplan."""
        exp = self.index.expanded
        fetches = []
        for w, v in itertools.product(forms, anchor_forms):
            for stored_w, stored_v, mirrored in ((w, v, False), (v, w, True)):
                reach = int(self._pair_reach[stored_w])
                if window > reach:
                    return None
                s, e = exp.pairs.find(stored_w * exp.n_base + stored_v)
                if e == s:
                    continue
                # stored postings: (doc, pos of stored_w, dist to stored_v)
                fetches.append(ResolvedFetch(
                    stream="expanded", start=s, length=e - s, offset=slot,
                    max_abs_dist=window, pivot_from_dist=mirrored))
                break   # canonical orientation found
        return FetchGroup(slot=slot, fetches=fetches, band=window,
                          score_slot=slot)

    def _kword_triple_seed(self, anchor_slot, s1, s2, anchor_forms,
                           window) -> Optional[FetchGroup]:
        """(s1, s2, anchor) three-component seed filter: anchor occurrences
        with BOTH stops within NeighborDistance, masked to |dist| =
        max(nearest |d1|, nearest |d2|) <= window — a necessary condition
        for any span match (both in-span stops sit within W of the anchor),
        and usually far shorter than the anchor's basic posting list: the
        'triples first' cost win of the K-word cover.  None when no anchor
        form has the key."""
        mk = self.index.multi_key
        fetches = []
        for v in anchor_forms:
            st, e = mk.find_triple(int(s1), int(s2), int(v))
            if e > st:
                fetches.append(ResolvedFetch(
                    stream="multi", start=st, length=e - st,
                    offset=anchor_slot, max_abs_dist=window,
                    pivot_from_dist=False))
        if not fetches:
            return None
        return FetchGroup(slot=anchor_slot, fetches=fetches, band=0,
                          score_slot=anchor_slot)

    def _plan_kword(self, tiered, window, ranked=False) -> SubPlan:
        """K-word span proximity (arXiv:2009.02684): anchor on the rarest
        non-stop slot; one band-W constraint group per remaining slot —
        each covered by the cheapest admissible index (multi-key pairs /
        expanded pairs / ordinary / basic, by occ-count cost) and keyed at
        its OWN word's positions; the seed is the anchor's basic list or,
        when cheaper, a (s1, s2, anchor) triple filter.  The executors
        evaluate the K-way windowed join over these groups (core/kword.py).
        """
        anchor = pick_kword_anchor(tiered, self._occ_counts)
        if anchor < 0:
            return SubPlan(qtype=QTYPE_KWORD, mode=MODE_KWORD, groups=[],
                           supported=False, kw_window=window,
                           note="all-stop kword tier combination: no "
                                "non-stop slot to anchor the span join on")
        anchor_forms = tiered[anchor][1]
        mk = self.index.multi_key
        constraints = []
        stop_singles = []
        stop_seen = set()
        for i, (t, forms) in enumerate(tiered):
            if i == anchor:
                continue
            if t == TIER_STOP:
                if len(forms) == 1:
                    stop_singles.append((i, int(forms[0])))
                if not ranked:
                    # identical form sets impose identical span constraints
                    # (one occurrence may satisfy several slots); ranked
                    # keeps per-slot groups for per-slot score payloads
                    key = tuple(sorted(forms))
                    if key in stop_seen:
                        continue
                    stop_seen.add(key)
                constraints.append(
                    self._kword_stop_group(i, forms, anchor_forms, window))
            else:
                g = None
                if t == TIER_FREQUENT:
                    g = self._kword_expanded_group(i, forms, anchor_forms,
                                                   window)
                basic = self._basic_group(i, forms, band=window)
                if g is None or g.postings_read > basic.postings_read:
                    g = basic
                constraints.append(g)
        # seed: the anchor's own occurrences, or a triple filter when one is
        # admissible and cheaper (triples first, pairs for the remainder)
        seed = self._basic_group(anchor, anchor_forms)
        if window <= mk.neighbor_distance:
            best_triple = None
            for (i1, s1), (i2, s2) in itertools.combinations(stop_singles, 2):
                if s1 == s2 or not mk.has_triple_pair(s1, s2):
                    continue
                trip = self._kword_triple_seed(anchor, s1, s2, anchor_forms,
                                               window)
                if trip is None:
                    # admitted (s1, s2) key with no postings for any anchor
                    # form: the stops never co-occur near an anchor, so the
                    # span join is empty — a fetchless seed kills the
                    # subplan (the doc-only fallback still runs)
                    seed = FetchGroup(slot=anchor, fetches=[], band=0)
                    best_triple = None
                    break
                if (best_triple is None
                        or trip.postings_read < best_triple.postings_read):
                    best_triple = trip
            if (best_triple is not None
                    and best_triple.postings_read < seed.postings_read):
                seed = best_triple
        return SubPlan(qtype=QTYPE_KWORD, mode=MODE_KWORD,
                       groups=[seed] + constraints,
                       fallback_groups=self._fallback_groups(tiered),
                       kw_window=window)
