"""Per-query execution of query plans (the flexible path), in PyTorch.

The planner resolves every fetch to (start, length) slices; this executor
walks a plan in Python: slice -> packed-block unpack (core/postings.py's
bit-packed store, decoded by kernels/ops.unpack_postings — the CUDA kernel
on the card) -> key construction -> banded k-way intersection -> anchor
unpacking.  It is the escape hatch of the batched executor
(core/batch_executor.py) for plans that exceed its table caps, and the
result-parity oracle for it: `merge_subplan_results` is the one merge tail
both executors share.

This slice answers unranked phrase and near requests; ranked and K-word
requests raise `NotImplementedError` (`require_ported`) instead of
returning a different answer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.api import SearchRequest, SearchResponse
from repro_torch.core.builder import IndexSet
from repro_torch.core.kword import MODE_KWORD
from repro_torch.core.planner import (FetchGroup, MODE_PHRASE, QueryPlan,
                                      ResolvedFetch)
from repro_torch.core.postings import NS_SHIFT, PHRASE_BIAS, POS_BITS
from repro_torch.kernels.ops import unpack_postings

SENTINEL = 2**62                # pads; sorts after every real key


def resolve_device(device=None) -> torch.device:
    """The engine's device: the card unless the caller asks for the CPU.
    Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the port on the CPU")
    return dev


def require_ported(request: SearchRequest, plan: QueryPlan | None = None):
    """Refuse what later slices port, rather than answer it differently."""
    if request.rank:
        raise NotImplementedError("ranked search is ported in a later slice")
    if request.mode == MODE_KWORD or (
            plan is not None
            and any(sp.mode == MODE_KWORD for sp in plan.subplans)):
        raise NotImplementedError("K-word search is ported in a later slice")


def _next_pow2(n: int, floor: int = 256) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def order_groups_seed_first(groups):
    """Seed-first execution order of the batched tensorizer.  None when no
    valid seed exists (no band-0 group and no near-stop-checked pivot).
    The seed is the near-stop-checked pivot, else the smallest band-0 group
    by *resolved* posting count — a pure speed heuristic (the surviving key
    set is seed-invariant).  (The reference's ranked seed rule waits for
    the ranked slice.)"""
    ns = [g for g in groups if any(f.stop_checks for f in g.fetches)]
    if ns:
        seed = ns[0]
    else:
        band0 = [g for g in groups if g.band == 0]
        if not band0:
            return None
        seed = min(band0, key=lambda g: sum(f.length for f in g.fetches))
    return [seed] + [g for g in groups if g is not seed]


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


def merge_subplan_results(all_keys: list, doc_only_keys: list, postings: int,
                          used_fallback: bool, types: tuple,
                          request: SearchRequest) -> SearchResponse:
    """Union per-subplan key sets into a SearchResponse.

    Shared by the flexible and batched executors — their result parity
    depends on this tail being literally the same code.  Positional keys win
    over doc-only fallback keys; keys are unpacked doc/pos via the global
    63-bit codec.  (The reference's ranked tail waits for the ranked
    slice.)"""
    top_k = request.top_k
    resp = SearchResponse(
        doc=np.empty(0, np.int32), pos=np.empty(0, np.int32),
        postings_read=postings, used_fallback=used_fallback, doc_only=False,
        subplan_types=tuple(types), ranked=False, request=request,
        subplan_pos_hits=tuple(len(k) for k in all_keys))
    if any(len(k) for k in all_keys):
        keys = np.unique(np.concatenate(all_keys))
        resp.doc = (keys >> POS_BITS).astype(np.int32)
        resp.pos = ((keys & ((1 << POS_BITS) - 1)) - PHRASE_BIAS).astype(np.int32)
        if top_k is not None:           # legacy max_results truncation
            resp.doc, resp.pos = resp.doc[:top_k], resp.pos[:top_k]
        return resp
    if doc_only_keys:
        docs = np.unique(np.concatenate(doc_only_keys))
        resp.doc = docs.astype(np.int32)
        resp.pos = np.full(len(resp.doc), -1, dtype=np.int32)
        resp.doc_only = True
        if top_k is not None:
            resp.doc, resp.pos = resp.doc[:top_k], resp.pos[:top_k]
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

    def execute(self, plan: QueryPlan,
                request: SearchRequest) -> SearchResponse:
        require_ported(request, plan)
        all_keys = []
        doc_only_keys = []
        postings = 0
        used_fallback = False
        types = []
        for sp in plan.subplans:
            if not sp.supported:
                continue
            types.append(sp.qtype)
            postings += sp.postings_read
            keys = self._run_groups(sp.groups, sp.mode)
            if len(keys) == 0 and sp.fallback_groups:
                # paper: "if no result is obtained, we disregard the distance"
                used_fallback = True
                postings += sum(g.postings_read for g in sp.fallback_groups)
                dkeys = self._run_groups(sp.fallback_groups, MODE_PHRASE)
                doc_only_keys.append(dkeys)
                keys = keys[:0]
            all_keys.append(keys)
        return merge_subplan_results(all_keys, doc_only_keys, postings,
                                     used_fallback, tuple(types), request)
