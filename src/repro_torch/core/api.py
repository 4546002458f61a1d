"""Typed request/response API — the ONE public search surface.

Every search entry point of the port (`AdditionalIndexEngine`,
`OrdinaryEngine`) consumes a `SearchRequest` and returns a
`SearchResponse`; the types are the reference package's, field for field,
so responses of the two packages compare directly.  The port's executors
answer phrase, near and K-word requests, ranked or not.

Proximity relevance (arXiv:2108.00410)
--------------------------------------
`SearchRequest.rank=True` turns on on-device proximity scoring, computed
from the SAME (doc, pos, dist) postings the match already fetches — zero
extra postings read.  The model follows Veretennikov's relevance-ranking
follow-up on these exact indexes: the score of a match *anchor* (a pivot /
phrase-start occurrence at position ``p``) is a sum of per-query-slot
contributions that decay with the slot word's distance from the anchor,

    score(anchor) = sum_i  w(d_i),      w(d) = 1 / (1 + d)

where ``d_i`` is the distance from the anchor to the nearest matching
occurrence of slot *i* (0 for the pivot itself and for every slot of a
precise-phrase match; the ``dist`` payload of expanded / multi-component-key
postings; the banded key distance for full posting-list slots).  A
document's relevance is the sum over its anchors (duplicated anchors across
tier-split subqueries dedupe by max), so a phrase occurring twice outranks
one occurrence, and tighter word sets outrank looser ones.  Doc-only
fallback hits (the paper's distance-disregarding step 3) carry
`RankingParams.doc_only_score`.

The executors compute contributions in float32 in one canonical order
(per-task bias, then the seed group, then each constraint group), which is
what makes ranked output bit-identical between `engine.search_batch`, the
flexible per-query executor, and the reference's serve tier.
"""
from __future__ import annotations

import dataclasses

import numpy as np

MODE_PHRASE = "phrase"
MODE_NEAR = "near"
MODE_KWORD = "kword"

# kword window bounds (== core.kword.KW_FLEX_MAX_WINDOW; literal here so the
# API layer stays import-free of the planner stack): the flexible executor's
# int64 delta masks reach W = 31; the device executors handle W <= 15 and
# route wider windows to flex automatically.
_KWORD_MAX_WINDOW = 31

# -- serving statuses (serve.front) -----------------------------------------
# Every response handed out by the serving front door carries exactly one of
# these.  Engine / serve-tier responses are exact by construction, so the
# dataclass default is STATUS_SERVED_EXACT and only the front door ever
# downgrades it.
STATUS_SERVED_EXACT = "SERVED_EXACT"        # all shards answered, on time
STATUS_SERVED_DEGRADED = "SERVED_DEGRADED"  # partial shards and/or past the
                                            # deadline: results are a correct
                                            # merge of the contributing shards
STATUS_SHED = "SHED"                        # admission control refused the
                                            # request: no search executed

@dataclasses.dataclass(frozen=True)
class RankingParams:
    """Knobs of the proximity relevance model (see module docstring).

    `proximity_scale` multiplies every positional score host-side (both
    executors apply it after the device pass); `doc_only_score` is the flat relevance assigned to
    distance-disregarding fallback hits, which therefore rank below any
    positional hit at the default 0.0.
    """
    proximity_scale: float = 1.0
    doc_only_score: float = 0.0


@dataclasses.dataclass(frozen=True)
class SearchRequest:
    """One query: surface ids + match semantics + ranking controls.

    mode      : MODE_PHRASE (order + adjacency), MODE_NEAR (word set within
                `window` of the pivot), or MODE_KWORD (K-word proximity,
                arXiv:2009.02684: every query word inside ONE
                (window + 1)-wide position span, any order — anchors are
                occurrences of the rarest non-stop word; the planner covers
                stop slots with multi-component-key lookups, see
                core/kword.py).  kword requires K >= 2 words and an explicit
                window in [1, 31]; windows <= 15 run on the device
                executors, wider ones ride the flexible escape path.
    window    : near-mode window; None = IndexParams.near_window.
                kword mode: the span width (required, 1..31).
    top_k     : ranked => keep the top_k highest-scoring documents;
                unranked => truncate the flat anchor arrays (the legacy
                `max_results` semantics).  None = unlimited.
    rank      : compute proximity relevance and order hits by it.
    ranking   : scoring weights (ignored unless rank=True).
    deadline_ms : latency budget for the serving front door (relative; the
                front converts it to an absolute deadline at admission and
                sheds the request if it cannot be met).  None = the front's
                default.  Engines ignore it — a direct engine call always
                runs to completion.
    """
    surface_ids: tuple
    mode: str = MODE_PHRASE
    window: int | None = None
    top_k: int | None = None
    rank: bool = False
    ranking: RankingParams = RankingParams()
    deadline_ms: float | None = None

    def __post_init__(self):
        object.__setattr__(self, "surface_ids",
                           tuple(int(s) for s in self.surface_ids))
        if self.mode not in (MODE_PHRASE, MODE_NEAR, MODE_KWORD):
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.mode == MODE_KWORD:
            if len(self.surface_ids) < 2:
                raise ValueError("kword mode needs at least 2 query words")
            if self.window is None or not 1 <= int(self.window) <= _KWORD_MAX_WINDOW:
                raise ValueError(
                    f"kword mode needs an explicit window in "
                    f"[1, {_KWORD_MAX_WINDOW}], got {self.window!r}")
        if self.top_k is not None and self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be > 0")

    def plan_signature(self) -> tuple:
        """Hashable identity of the *plan* this request compiles to — every
        field that changes the result, and nothing that doesn't.  Two
        requests with equal signatures get bit-identical responses, which is
        what makes it the front door's cache key.  `deadline_ms` is
        deliberately excluded: it shapes scheduling, not results."""
        return (self.surface_ids, self.mode, self.window, self.top_k,
                self.rank, self.ranking.proximity_scale,
                self.ranking.doc_only_score)


@dataclasses.dataclass(frozen=True)
class DocHit:
    """One ranked document: relevance score, its match anchors, and the
    subplan (tier-split subquery) indices that produced them."""
    doc: int
    score: float
    positions: np.ndarray          # anchor positions, ascending (empty when
                                   # the hit came from the doc-only fallback)
    subplans: tuple = ()           # indices into SearchResponse.subplan_types

    def __repr__(self):
        return (f"DocHit(doc={self.doc}, score={self.score:.4f}, "
                f"n_pos={len(self.positions)}, subplans={self.subplans})")


@dataclasses.dataclass
class SearchResponse:
    """Search outcome.  Flat per-anchor arrays (`doc`, `pos`, ascending by
    (doc, pos) — or per-doc when `doc_only`) keep the unranked path as cheap
    as the pre-API result object; ranked fields and the `hits` view are
    filled / built only when the request asked for ranking.
    """
    doc: np.ndarray                # per-anchor doc ids (per-doc if doc_only)
    pos: np.ndarray                # anchor positions (-1 when doc_only)
    postings_read: int
    used_fallback: bool
    doc_only: bool
    subplan_types: tuple = ()
    # -- ranked fields (None unless request.rank) ---------------------------
    ranked: bool = False
    anchor_scores: np.ndarray | None = None   # float32, aligned with doc/pos
    anchor_subplans: np.ndarray | None = None  # uint64 bitmask per anchor
                                               # (exact for subplans 0..63,
                                               # omitted beyond)
    doc_ids: np.ndarray | None = None         # ranked docs (top_k applied)
    doc_scores: np.ndarray | None = None      # float32, aligned with doc_ids
    request: SearchRequest | None = None
    # -- execution provenance -----------------------------------------------
    # positional-key count per supported subplan: how many anchor keys each
    # tier-split subquery matched BEFORE the union/dedup merge.  This is what
    # lets a doc-sharded front door reconstruct the global fallback decision
    # (a subplan falls back iff it has fallback groups and zero positional
    # keys across ALL shards) without re-executing anything.
    subplan_pos_hits: tuple = ()
    # -- serving transport metadata (set by serve.front only) ---------------
    status: str = STATUS_SERVED_EXACT
    shards: tuple = ()             # doc-shard indices that contributed
    cached: bool = False           # served from the hot-query result cache
    shed_reason: str = ""          # SHED / DEGRADED: why ("" otherwise)
    latency_ms: float | None = None
    _hits: list | None = dataclasses.field(default=None, repr=False)

    def __len__(self):
        return len(self.doc_ids) if self.ranked else len(self.doc)

    @property
    def hits(self) -> list[DocHit]:
        """Ranked DocHit view (score desc, doc asc).  Unranked responses
        yield doc-ascending hits with score 0.0 and no provenance."""
        if self._hits is None:
            self._hits = self._build_hits()
        return self._hits

    def _build_hits(self) -> list[DocHit]:
        if not self.ranked:
            docs = np.unique(self.doc)
            if self.doc_only:
                return [DocHit(int(d), 0.0, np.empty(0, np.int32))
                        for d in docs]
            return [DocHit(int(d), 0.0,
                           np.sort(self.pos[self.doc == d]).astype(np.int32))
                    for d in docs]
        out = []
        for d, s in zip(self.doc_ids.tolist(), self.doc_scores.tolist()):
            if self.doc_only:
                out.append(DocHit(int(d), float(s), np.empty(0, np.int32),
                                  self._doc_subplans(d)))
                continue
            sel = self.doc == d
            out.append(DocHit(int(d), float(s),
                              np.sort(self.pos[sel]).astype(np.int32),
                              self._doc_subplans(d)))
        return out

    def _doc_subplans(self, d) -> tuple:
        if self.anchor_subplans is None:
            return ()
        mask = int(np.bitwise_or.reduce(
            self.anchor_subplans[self.doc == d], initial=np.uint64(0)))
        return tuple(i for i in range(min(len(self.subplan_types), 64))
                     if mask >> i & 1)

