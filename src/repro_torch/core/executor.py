"""Per-query execution of query plans (the flexible path), in PyTorch.

The planner resolves every fetch to (start, length) slices; this executor
walks a plan in Python: slice -> packed-block unpack (core/postings.py's
bit-packed store, decoded by kernels/ops.unpack_postings — the CUDA kernel
on the card) -> key construction -> banded k-way intersection -> anchor
unpacking.  It is the escape hatch of the batched executor
(core/batch_executor.py) for plans that exceed its table caps, and the
result-parity oracle for it: `merge_subplan_results` is the one merge tail
both executors share.

Ranked requests (api.py) run `_run_groups_ranked`: the same banded
intersection, plus a per-group minimum of (key distance + stored |dist|
delta) probed against composite-sorted keys — accumulated into per-anchor
float32 proximity scores in the SAME order as the batched bucket step, so
flex-routed plans rank bit-identically.  K-word requests (core/kword.py)
filter the seed's anchors with the K-way span join (`kword_span_ok`, host
int64 masks up to W <= 31).  `merge_subplan_results` dedups anchors (max
score), sums per-doc scores and orders documents (score desc, doc asc).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import SearchRequest, SearchResponse
from repro_torch.core.builder import IndexSet
from repro_torch.core.kword import kword_span_ok
from repro_torch.core.planner import (FetchGroup, MODE_PHRASE, QueryPlan,
                                      ResolvedFetch, SubPlan)
from repro_torch.core.postings import NS_SHIFT, PHRASE_BIAS, POS_BITS
from repro_torch.kernels.ops import (I32_SENTINEL, SCORE_DELTA_BITS,
                                     SCORE_DELTA_MASK, unpack_postings)

SENTINEL = 2**62                # pads; sorts after every real key


def resolve_device(device=None) -> torch.device:
    """The engine's device: the card unless the caller asks for the CPU.
    Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")
    return dev


def _next_pow2(n: int, floor: int = 256) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def order_groups_seed_first(groups, ranked=False):
    """Seed-first execution order shared by the batched tensorizer and the
    flexible ranked path (identical order => identical float32 score
    accumulation => bit-identical ranked output).  None when no valid seed
    exists (no band-0 group and no near-stop-checked pivot).

    Unranked seeds pick the smallest band-0 group by *resolved* posting
    count — a pure speed heuristic (the surviving key set is seed-invariant).
    Ranked seeds take the FIRST band-0 group in plan order: plan order is
    lexicon/params-driven, so deployments that resolve different posting
    lengths still accumulate float32 scores in one order."""
    ns = [g for g in groups if any(f.stop_checks for f in g.fetches)]
    if ns:
        seed = ns[0]
    else:
        band0 = [g for g in groups if g.band == 0]
        if not band0:
            return None
        if ranked:
            seed = band0[0]
        else:
            seed = min(band0, key=lambda g: sum(f.length for f in g.fetches))
    return [seed] + [g for g in groups if g is not seed]


def proximity_w(delta):
    """w(d) = 1 / (1 + d), float32 — the proximity decay of the relevance
    model (api.py; arXiv:2108.00410's decreasing distance weight)."""
    return 1.0 / (1.0 + delta.float())


def scored_probe(comp_sorted, probe, band: int):
    """Banded min-delta membership against a composite-sorted key list.

    comp_sorted : [Pb] int64 ascending (key << SCORE_DELTA_BITS | delta,
                  pads = any value above every real composite); probe: [Pa]
                  int64 (key << SCORE_DELTA_BITS, invalid entries padded
                  like comp — the caller masks them out).  Returns int32
                  delta_total [Pa]: min over b with |key(b) - key(a)| <=
                  band of (key distance + b's stored delta), or I32_SENTINEL
                  when no such b.  Two probes suffice: within an equal-key
                  run the first entry carries the minimal stored delta
                  (composite order), and stored deltas are zero in every
                  band > 0 group by plan construction (dist-carrying fetches
                  are always band-0)."""
    Pb = comp_sorted.shape[0]
    idx = torch.searchsorted(comp_sorted, probe, side="left")
    e_hi = comp_sorted[idx.clamp(0, Pb - 1)]
    e_lo = comp_sorted[(idx - 1).clamp(0, Pb - 1)]
    a_key = probe >> SCORE_DELTA_BITS
    kd_hi = (e_hi >> SCORE_DELTA_BITS) - a_key
    kd_lo = a_key - (e_lo >> SCORE_DELTA_BITS)
    ok_hi = (idx < Pb) & (kd_hi <= band)
    ok_lo = (idx > 0) & (kd_lo <= band)
    cand_hi = torch.where(ok_hi, (kd_hi + (e_hi & SCORE_DELTA_MASK)).int(),
                          I32_SENTINEL)
    cand_lo = torch.where(ok_lo, (kd_lo + (e_lo & SCORE_DELTA_MASK)).int(),
                          I32_SENTINEL)
    return torch.minimum(cand_hi, cand_lo)


def _band_member(a, a_valid, b_sorted, band: int):
    """a_valid & (exists b in [a - band, a + band]); int64 keys."""
    lo = torch.searchsorted(b_sorted, a - band, side="left")
    hi = torch.searchsorted(b_sorted, a + band, side="right")
    return a_valid & (hi > lo)


def _near_stop_ok(slots, packed_targets, target_valid):
    """slots [N, K]; packed_targets [C, M]: per check C, any of M ids at the
    required delta must appear among the K slots; all checks must pass."""
    eq = slots[:, :, None, None] == packed_targets[None, None, :, :]
    eq = eq & target_valid[None, None, :, :]
    per_check = eq.any(dim=3).any(dim=1)            # [N, C]
    return per_check.all(dim=1)


def _rank_docs(doc_ids: np.ndarray, doc_scores: np.ndarray,
               top_k: int | None):
    """Order docs by (score desc, doc asc) and keep the first `top_k` — the
    reference's `jax.lax.top_k` selection, whose ties break toward the lower
    index (= the lower doc: `doc_ids` arrive ascending)."""
    idx = np.lexsort((doc_ids, -doc_scores.astype(np.float64)))
    if top_k is not None:
        idx = idx[:top_k]
    return doc_ids[idx], doc_scores[idx]


def merge_subplan_results(all_keys: list, doc_only_keys: list, postings: int,
                          used_fallback: bool, types: tuple,
                          request: SearchRequest,
                          all_scores: list | None = None) -> SearchResponse:
    """Union per-subplan key sets into a SearchResponse.

    Shared by the flexible and batched executors — their result parity
    depends on this tail being literally the same code.  Positional keys win
    over doc-only fallback keys; keys are unpacked doc/pos via the global
    63-bit codec.

    Ranked (`request.rank` with `all_scores` aligned to `all_keys`):
    duplicate anchors across subplans dedupe by MAX score, per-anchor
    subplan provenance ORs over duplicates, document relevance is the
    float32 sum of its anchors' scores, and documents order by (score desc,
    doc asc) with `top_k` selection."""
    ranked = request.rank
    top_k = request.top_k
    rank_p = request.ranking
    resp = SearchResponse(
        doc=np.empty(0, np.int32), pos=np.empty(0, np.int32),
        postings_read=postings, used_fallback=used_fallback, doc_only=False,
        subplan_types=tuple(types), ranked=ranked, request=request,
        subplan_pos_hits=tuple(len(k) for k in all_keys))
    have_pos = any(len(k) for k in all_keys)
    if have_pos and not ranked:
        keys = np.unique(np.concatenate(all_keys))
        resp.doc = (keys >> POS_BITS).astype(np.int32)
        resp.pos = ((keys & ((1 << POS_BITS) - 1)) - PHRASE_BIAS).astype(np.int32)
        if top_k is not None:           # legacy max_results truncation
            resp.doc, resp.pos = resp.doc[:top_k], resp.pos[:top_k]
        return resp
    if have_pos:
        scale = np.float32(rank_p.proximity_scale)
        keys = np.concatenate(all_keys)
        scores = np.concatenate(
            [np.asarray(s, np.float32) for s in all_scores]) * scale
        # provenance bitmask: exact for the first 64 subplans, omitted (not
        # misattributed) beyond; scores are unaffected
        masks = np.concatenate(
            [np.full(len(k), np.uint64(1) << i if i < 64 else np.uint64(0),
                     np.uint64)
             for i, k in enumerate(all_keys)])
        order = np.lexsort((-scores.astype(np.float64), keys))
        k_s, s_s, m_s = keys[order], scores[order], masks[order]
        first = np.ones(len(k_s), bool)
        first[1:] = k_s[1:] != k_s[:-1]
        starts = np.nonzero(first)[0]
        uniq_keys = k_s[starts]
        uniq_scores = s_s[starts]                   # max score per anchor
        uniq_masks = np.bitwise_or.reduceat(m_s, starts)
        resp.doc = (uniq_keys >> POS_BITS).astype(np.int32)
        resp.pos = ((uniq_keys & ((1 << POS_BITS) - 1))
                    - PHRASE_BIAS).astype(np.int32)
        resp.anchor_scores = uniq_scores
        resp.anchor_subplans = uniq_masks
        dfirst = np.ones(len(resp.doc), bool)
        dfirst[1:] = resp.doc[1:] != resp.doc[:-1]
        dstarts = np.nonzero(dfirst)[0]
        doc_ids = resp.doc[dstarts].copy()
        doc_scores = np.add.reduceat(uniq_scores, dstarts).astype(np.float32)
        resp.doc_ids, resp.doc_scores = _rank_docs(doc_ids, doc_scores, top_k)
        return resp
    if doc_only_keys:
        docs = np.unique(np.concatenate(doc_only_keys))
        resp.doc = docs.astype(np.int32)
        resp.pos = np.full(len(resp.doc), -1, dtype=np.int32)
        resp.doc_only = True
        if ranked:
            resp.anchor_scores = np.full(len(resp.doc),
                                         rank_p.doc_only_score, np.float32)
            resp.doc_ids = resp.doc.copy()
            resp.doc_scores = resp.anchor_scores.copy()
            if top_k is not None:
                resp.doc_ids = resp.doc_ids[:top_k]
                resp.doc_scores = resp.doc_scores[:top_k]
        elif top_k is not None:
            resp.doc, resp.pos = resp.doc[:top_k], resp.pos[:top_k]
        return resp
    if ranked:
        resp.anchor_scores = np.empty(0, np.float32)
        resp.doc_ids = np.empty(0, np.int32)
        resp.doc_scores = np.empty(0, np.float32)
    return resp


def arena_tensors(packed, device) -> dict:
    """A packed store's `lanes` + `blk_meta` as int32 tensors on `device`."""
    return {"lanes": torch.from_numpy(packed.lanes).to(device),
            "blk_meta": torch.from_numpy(packed.meta_matrix()).to(device)}


class DeviceIndex:
    """Per-stream packed postings as tensors on the executor's device — the
    same bit-packed block representation as the batched arena, one store
    per stream; fetch slices are unpacked on the device."""

    STREAMS = ("basic", "first", "expanded", "stop", "ordinary", "multi")

    def __init__(self, index: IndexSet, device):
        from repro_torch.core.batch_executor import ensure_packed_streams
        packed = ensure_packed_streams(index)
        self.device = torch.device(device)
        self._arenas = {name: arena_tensors(packed[name], self.device)
                        for name in self.STREAMS}
        self.near_stop = torch.from_numpy(
            np.asarray(index.basic.near_stop)).to(self.device)
        self.max_distance = index.basic.max_distance

    def unpack(self, stream: str, s: int, e: int):
        """(doc, pos, dist) int32 device tensors for postings [s, e).  The
        slice is decoded exactly — no ordinal past the stream's tail is
        read."""
        idx = torch.arange(s, e, dtype=torch.int32, device=self.device)
        return unpack_postings(self._arenas[stream], idx)


class Executor:
    def __init__(self, index: IndexSet, device):
        self.index = index
        self.dev = DeviceIndex(index, device)
        self.device = self.dev.device

    # -- key construction -----------------------------------------------------

    def _phrase_keys(self, doc, pos, offset):
        shifted = pos.long() - offset + PHRASE_BIAS
        return (doc.long() << POS_BITS) | shifted

    def _plain_keys(self, doc, pos):
        return (doc.long() << POS_BITS) | (pos.long() + PHRASE_BIAS)

    def _fetch_keys(self, f: ResolvedFetch, mode: str):
        d = self.dev
        s, e = f.start, f.start + f.length
        doc, pos, dist = d.unpack(f.stream, s, e)
        if f.stream == "stop":
            return self._phrase_keys(doc, pos, f.offset)
        if f.stream == "first":
            return doc.long()
        if f.stream in ("expanded", "multi"):
            # dist-carrying streams share one keying rule (the math the
            # batched gather mirrors in bucket_step_math).  Phrase mode
            # (expanded only): anchor keys + exact-distance mask.  Near
            # mode: keys at the pivot position — pos + dist when
            # pivot_from_dist (expanded fetches, (s, v) pairs), pos itself
            # otherwise ((s1, s2, v) triples); |dist| <= window masks the band.
            if f.stream == "expanded" and mode == MODE_PHRASE:
                keys = self._phrase_keys(doc, pos, f.offset)
                mask = dist == f.required_dist
            else:
                pivot_pos = pos + (dist if f.pivot_from_dist else 0)
                keys = self._plain_keys(doc, pivot_pos)
                mask = dist.abs() <= f.max_abs_dist
            return torch.where(mask, keys, SENTINEL)
        if f.stream == "ordinary":
            if mode == MODE_PHRASE:
                return self._phrase_keys(doc, pos, f.offset)
            return self._plain_keys(doc, pos)
        # basic occurrences (possibly with near-stop verification)
        if mode == MODE_PHRASE:
            keys = self._phrase_keys(doc, pos, f.offset)
        else:
            keys = self._plain_keys(doc, pos)
        if f.stop_checks:
            slots = d.near_stop[s:e]
            D = d.max_distance
            C = len(f.stop_checks)
            M = max(len(ids) for _, ids in f.stop_checks)
            packed = np.full((C, M), -2, dtype=np.int16)
            valid = np.zeros((C, M), dtype=bool)
            for ci, (delta, ids) in enumerate(f.stop_checks):
                for mi, sid in enumerate(ids):
                    packed[ci, mi] = ((delta + D) << NS_SHIFT) | sid
                    valid[ci, mi] = True
            ok = _near_stop_ok(slots, torch.from_numpy(packed).to(self.device),
                               torch.from_numpy(valid).to(self.device))
            keys = torch.where(ok, keys, SENTINEL)
        return keys

    def _fetch_delta(self, f: ResolvedFetch):
        """Per-posting slot delta for ranked scoring: the |dist| payload when
        the planner marked the fetch `score_delta_from_dist` (near-mode
        expanded / multi-key lookups, keyed at the anchor), else 0 (precise
        keys — the key distance carries any remaining spread)."""
        if not f.score_delta_from_dist:
            return torch.zeros((f.length,), dtype=torch.int32,
                               device=self.device)
        _, _, dist = self.dev.unpack(f.stream, f.start, f.start + f.length)
        return dist.abs()

    def _group_keys(self, g: FetchGroup, mode: str):
        """Sorted, sentinel-padded int64 key tensor for one fetch group
        (padded to the reference's pow2 width, which its seed choice
        reads)."""
        parts = [self._fetch_keys(f, mode) for f in g.fetches]
        total = sum(int(p.shape[0]) for p in parts)
        buf = torch.full((_next_pow2(max(total, 1)),), SENTINEL,
                         dtype=torch.int64, device=self.device)
        if parts:
            buf[:total] = torch.cat(parts)
        return torch.sort(buf).values

    def _group_composites(self, g: FetchGroup, mode: str):
        """Ascending (key << SCORE_DELTA_BITS | delta) composites of one
        group for the ranked probe; invalid keys and pow2 pads are
        SENTINEL."""
        keys = torch.cat([self._fetch_keys(f, mode) for f in g.fetches])
        delta = torch.cat([self._fetch_delta(f) for f in g.fetches])
        buf = torch.full((_next_pow2(keys.shape[0], floor=128),), SENTINEL,
                         dtype=torch.int64, device=self.device)
        buf[:keys.shape[0]] = torch.where(
            keys < SENTINEL, (keys << SCORE_DELTA_BITS) | delta.long(),
            SENTINEL)
        return torch.sort(buf).values

    # -- plan execution ---------------------------------------------------------

    def _run_groups(self, groups: list[FetchGroup], mode: str):
        """Banded k-way intersection; returns surviving anchor keys (np)."""
        if not groups:
            return np.empty(0, dtype=np.int64)
        if any(not g.fetches for g in groups):
            return np.empty(0, dtype=np.int64)   # a slot with no postings
        keyed = [(g, self._group_keys(g, mode)) for g in groups]
        # seed must be a band-0 group; prefer the smallest for speed
        band0 = [kg for kg in keyed if kg[0].band == 0]
        seed = min(band0, key=lambda kg: int(kg[1].shape[0]))
        a = seed[1]
        a_valid = a < SENTINEL
        for g, b in keyed:
            if g is seed[0]:
                continue
            a_valid = _band_member(a, a_valid, b, int(g.band))
        res = a[a_valid].cpu().numpy()
        return res[res < SENTINEL]

    def _kword_span_mask(self, sp: SubPlan, a: np.ndarray) -> np.ndarray:
        """K-way windowed join over the subplan's constraint groups for the
        anchor keys `a` (core/kword.py; host int64 masks, so windows up to
        KW_FLEX_MAX_WINDOW — the wide-window / cap-overflow escape the
        batched executor routes to)."""
        ordered = order_groups_seed_first(sp.groups, ranked=True)
        bs = [self._group_keys(g, sp.mode).cpu().numpy() for g in ordered[1:]]
        return kword_span_ok(a, bs, int(sp.kw_window))

    def _run_groups_kword(self, sp: SubPlan):
        """Unranked kword: seed anchors filtered by the K-way span join
        (every slot inside one (W + 1)-wide window containing the anchor)
        instead of pairwise banded membership."""
        groups = sp.groups
        if not groups or any(not g.fetches for g in groups):
            return np.empty(0, dtype=np.int64)
        ordered = order_groups_seed_first(groups, ranked=True)
        if ordered is None:
            return np.empty(0, dtype=np.int64)
        a = self._group_keys(ordered[0], sp.mode).cpu().numpy()
        sel = (a < SENTINEL) & self._kword_span_mask(sp, a)
        return a[sel]

    def _run_groups_ranked(self, sp: SubPlan):
        """Ranked twin of _run_groups: surviving anchors AND their proximity
        scores, accumulated in the SAME float32 order as the batched bucket
        step (bias, seed self-delta, then each constraint group seed-first),
        so identical group sets give bit-identical scores.  K-word subplans
        replace the found bit with the span join."""
        groups = sp.groups
        empty = (np.empty(0, np.int64), np.empty(0, np.float32))
        if not groups or any(not g.fetches for g in groups):
            return empty
        ordered = order_groups_seed_first(groups, ranked=True)
        if ordered is None:
            return empty
        seed = ordered[0]
        a = torch.cat([self._fetch_keys(f, sp.mode) for f in seed.fetches])
        d_self = torch.cat([self._fetch_delta(f) for f in seed.fetches])
        a_valid = a < SENTINEL
        score = float(sp.n_slots - len(groups)) + proximity_w(d_self)
        probe = torch.where(a_valid, a << SCORE_DELTA_BITS, SENTINEL)
        for g in ordered[1:]:
            comp = self._group_composites(g, sp.mode)
            delta_g = scored_probe(comp, probe, int(g.band))
            hit = delta_g < I32_SENTINEL
            a_valid &= hit
            score = score + torch.where(hit, proximity_w(delta_g), 0.0)
        a_np = a.cpu().numpy()
        sel = a_valid.cpu().numpy()
        if sp.kw_window is not None:
            # a span match implies an in-band hit for every group, so the
            # score accumulated above is exact for every survivor
            sel = sel & self._kword_span_mask(sp, a_np)
        return a_np[sel], score.cpu().numpy().astype(np.float32)[sel]

    def execute(self, plan: QueryPlan,
                request: SearchRequest) -> SearchResponse:
        ranked = request.rank
        all_keys, all_scores = [], []
        doc_only_keys = []
        postings = 0
        used_fallback = False
        types = []
        for sp in plan.subplans:
            if not sp.supported:
                continue
            types.append(sp.qtype)
            postings += sp.postings_read
            scores = np.empty(0, np.float32)
            if ranked:
                keys, scores = self._run_groups_ranked(sp)
            elif sp.kw_window is not None:
                keys = self._run_groups_kword(sp)
            else:
                keys = self._run_groups(sp.groups, sp.mode)
            if len(keys) == 0 and sp.fallback_groups:
                # paper: "if no result is obtained, we disregard the distance"
                used_fallback = True
                postings += sum(g.postings_read for g in sp.fallback_groups)
                dkeys = self._run_groups(sp.fallback_groups, MODE_PHRASE)
                doc_only_keys.append(dkeys)
                keys = keys[:0]
            all_keys.append(keys)
            all_scores.append(scores)
        return merge_subplan_results(all_keys, doc_only_keys, postings,
                                     used_fallback, tuple(types), request,
                                     all_scores=all_scores)
