"""Plain NumPy reference of the search service's answers.

It works every answer out again from the corpus tokens and the lexicon's
surface -> basic-form table (bench/inputs.py), with one ordinary inverted
list of token positions per basic form, and nothing of the program: no
index, no plan, no postings.  The semantics are the papers' as the
program states them:

* the query is split whenever a word's basic forms fall into different
  tiers (arXiv:1801.09079, "processing queries"): one subquery per
  combination of tiers, whose answers are unioned;
* a subquery of stop words only matches contiguously, in any order
  (a multiset of stop forms), in parts of at most MaxLength words; it has
  no document-level fallback;
* otherwise a phrase matches its words at consecutive positions; a near
  query matches where every word occurs within `window` positions of the
  pivot, the rarest non-stop word (ordinary words first, ties to the
  earlier word); a K-word query (arXiv:2009.02684) matches where all K
  words fit one span of `window` + 1 positions around an occurrence of
  the anchor word, chosen as the pivot (a subquery of stop words only has
  no anchor and no answer);
* the anchors are the phrase starts, pivot and anchor positions; when no
  subquery has one, the answer is the documents holding every non-stop
  word of some subquery (the distance-disregarding step), doc-only;
* the ordinary service (the papers' baseline, one inverted file over
  every basic form, stop words included) does not split the query: a
  word matches any of its forms, a phrase matches at consecutive
  positions whatever its words, the near pivot is the rarest word, stop
  words included, the K-word anchor the rarest word with a non-stop form
  (any word when none has one), and there is no document-level answer;
* ranked (arXiv:2108.00410): an anchor scores w(0) = 1 for each word of a
  phrase or all-stop match, and 1 + sum over the other words of
  w(d) = 1 / (1 + d), d the distance to that word's nearest occurrence in
  the window; an anchor found by several subqueries keeps its highest
  score; a document scores the sum of its anchors; the top k documents
  order by (score descending, document ascending).

Scores are float64 here.  `score_dtype="bfloat16"` rounds every weight
and every partial sum to bfloat16: the control, one precision below the
float32 that the configuration states.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

TIER_STOP, TIER_ORDINARY = 0, 2
POS_SHIFT = 32
POS_BIAS = 1 << 30


def anchor_keys(doc, pos) -> np.ndarray:
    """(doc, pos) pairs as sorted unique int64 keys."""
    doc = np.asarray(doc, np.int64)
    pos = np.asarray(pos, np.int64)
    return np.unique((doc << POS_SHIFT) | (pos + POS_BIAS))


def bf16(x) -> np.ndarray:
    """Round float values to bfloat16 (nearest, ties to even), as float64."""
    f = np.asarray(x, np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def split_parts(n: int, min_len: int, max_len: int) -> list[tuple[int, int]]:
    """(start, length) parts of an n-word stop phrase, each of min_len to
    max_len words, covering every word; a short tail overlaps backwards."""
    parts, i = [], 0
    while i < n:
        L = min(max_len, n - i)
        if L < min_len:
            parts.append((n - min_len, min_len))
            break
        rem = n - i - L
        if 0 < rem < min_len:
            L = max(L - (min_len - rem), min_len)
        parts.append((i, L))
        i += L
    return parts


@dataclasses.dataclass
class Answer:
    """keys: sorted anchor keys (positional); docs: doc-only documents;
    scores: {key: score} and doc_scores: {doc: score} when ranked."""
    keys: np.ndarray
    doc_only: bool
    docs: np.ndarray
    scores: dict | None = None
    doc_scores: dict | None = None


class Reference:
    def __init__(self, lex, doc_offsets: np.ndarray, tokens: np.ndarray,
                 min_len: int, max_len: int, near_window: int,
                 service: str = "additional", score_dtype: str = "float64",
                 first_per_doc: bool = False):
        """`service` "ordinary" answers as one inverted file over every
        basic form does (see `answer`).  `first_per_doc` keeps each
        document's first anchor only: the exact services' control, which
        breaks their guarantee that every occurrence is returned."""
        if service not in ("additional", "ordinary"):
            raise ValueError(f"unknown service {service!r}")
        self.service = service
        self.lex = lex
        self.min_len, self.max_len = int(min_len), int(max_len)
        self.near_window = int(near_window)
        self.score_dtype = score_dtype
        self.first_per_doc = first_per_doc
        tokens = np.asarray(tokens, np.int64)
        T = len(tokens)
        self.T = T
        lengths = np.diff(doc_offsets)
        self.doc_of = np.repeat(np.arange(len(lengths), dtype=np.int64),
                                lengths)
        self.doc_start = np.asarray(doc_offsets[:-1], np.int64)[self.doc_of]
        self.doc_end = np.asarray(doc_offsets[1:], np.int64)[self.doc_of]
        self.tok_prim = lex.primary[tokens].astype(np.int64)
        self.tok_sec = lex.secondary[tokens].astype(np.int64)
        # one inverted list per basic form: ascending token indices
        has = self.tok_sec >= 0
        g = np.arange(T, dtype=np.int64)
        forms = np.concatenate([self.tok_prim, self.tok_sec[has]])
        gs = np.concatenate([g, g[has]])
        order = np.argsort(forms * T + gs, kind="stable")
        self.post = gs[order]
        counts = np.bincount(forms, minlength=lex.n_base)
        self.occ = counts
        self.post_off = np.zeros(lex.n_base + 1, np.int64)
        np.cumsum(counts, out=self.post_off[1:])

    # -- helpers -------------------------------------------------------------

    def occurrences(self, forms) -> np.ndarray:
        """Ascending token indices holding any of `forms`."""
        parts = [self.post[self.post_off[f]:self.post_off[f + 1]]
                 for f in forms]
        return np.unique(np.concatenate(parts)) if parts else np.empty(0, np.int64)

    def tier_splits(self, surface_ids) -> list:
        per_slot = []
        for s in surface_ids:
            tiers: dict = {}
            for f in self.lex.forms(s):
                tiers.setdefault(int(self.lex.base_tier[f]), []).append(f)
            per_slot.append(sorted(tiers.items()))
        return list(itertools.product(*per_slot))

    def _subqueries(self, surface_ids) -> list:
        """[(tier, forms) per word] per subquery: the tier splits, or for
        the ordinary service one subquery of every word's forms, its tier
        that of the word's least frequent form."""
        if self.service == "additional":
            return self.tier_splits(surface_ids)
        out = []
        for s in surface_ids:
            forms = self.lex.forms(s)
            out.append((int(self.lex.base_tier[forms].max()), forms))
        return [out]

    def _pivot(self, tiered, mode: str) -> int:
        """The anchor word of a subquery: -1 where it has none."""
        if mode == "phrase":
            return 0
        if self.service == "additional":
            return self.pivot(tiered)
        count = [sum(int(self.occ[f]) for f in forms) for _, forms in tiered]
        if mode == "near":
            return int(np.argmin(count))
        eligible = [i for i, (t, _) in enumerate(tiered) if t != TIER_STOP]
        return min(eligible or range(len(tiered)), key=lambda i: count[i])

    def pivot(self, tiered) -> int:
        """The additional indexes' pivot: the rarest ordinary word, else
        the rarest non-stop word (-1 for a subquery of stop words)."""
        ordinary = [i for i, (t, _) in enumerate(tiered) if t == TIER_ORDINARY]
        eligible = ordinary or [i for i, (t, _) in enumerate(tiered)
                                if t != TIER_STOP]
        if not eligible:
            return -1
        return min(eligible,
                   key=lambda i: sum(int(self.occ[f]) for f in tiered[i][1]))

    def _w(self, d):
        w = 1.0 / (1.0 + np.asarray(d, np.float64))
        return bf16(w) if self.score_dtype == "bfloat16" else w

    def _add(self, a, b):
        s = np.asarray(a, np.float64) + np.asarray(b, np.float64)
        return bf16(s) if self.score_dtype == "bfloat16" else s

    def _keys(self, t) -> np.ndarray:
        t = np.asarray(t, np.int64)
        return (self.doc_of[t] << POS_SHIFT) | (t - self.doc_start[t] + POS_BIAS)

    def _nearest(self, occ: np.ndarray, t: np.ndarray, window: int):
        """Per anchor index t: distance to the nearest occurrence in `occ`
        within `window` positions and the same document, or -1."""
        lo = np.maximum(t - window, self.doc_start[t])
        hi = np.minimum(t + window, self.doc_end[t] - 1)
        j = np.searchsorted(occ, t)
        best = np.full(len(t), -1, np.int64)
        n = len(occ)
        for cand in (j, j - 1):
            ok = (cand >= 0) & (cand < n)
            c = np.where(ok, occ[np.clip(cand, 0, max(n - 1, 0))] if n else 0, 0)
            ok &= (c >= lo) & (c <= hi)
            d = np.abs(c - t)
            best = np.where(ok & ((best < 0) | (d < best)), d, best)
        return best

    def _offset_masks(self, occ: np.ndarray, t: np.ndarray, window: int):
        """Per anchor: int64 bit (d + window) set iff `occ` holds t + d in
        t's document, |d| <= window."""
        mask = np.zeros(len(t), np.int64)
        for d in range(-window, window + 1):
            u = t + d
            inside = (u >= self.doc_start[t]) & (u < self.doc_end[t])
            j = np.searchsorted(occ, u)
            hit = inside & (j < len(occ))
            hit &= occ[np.minimum(j, len(occ) - 1)] == u if len(occ) else False
            mask |= np.where(hit, np.int64(1) << (d + window), 0)
        return mask

    # -- subquery matchers ---------------------------------------------------

    def _stop_anchors(self, tiered) -> np.ndarray:
        """Token indices of phrase starts of an all-stop subquery."""
        n = len(tiered)
        n_stop = self.lex.n_stop
        sp = np.where(self.tok_prim < n_stop, self.tok_prim, -1)
        ss = np.where((self.tok_sec >= 0) & (self.tok_sec < n_stop),
                      self.tok_sec, -1)
        result = None
        for pstart, L in split_parts(n, self.min_len, self.max_len):
            slot_forms = [set(tiered[pstart + j][1]) for j in range(L)]
            union = sorted(set().union(*slot_forms))
            occ0 = self.occurrences(sorted(slot_forms[0]))
            cand = np.unique((occ0[:, None] - np.arange(L)[None]).ravel())
            cand = cand[(cand >= 0) & (cand + L <= self.T)]
            cand = cand[self.doc_of[cand] == self.doc_of[cand + L - 1]]
            for j in range(L):
                u = cand + j
                cand = cand[np.isin(sp[u], union) | np.isin(ss[u], union)]
            hits = []
            for t in cand.tolist():
                tok_forms = [{f for f in (sp[t + j], ss[t + j])
                              if f >= 0 and f in union} for j in range(L)]
                if any(all(tok_forms[j] & slot_forms[p[j]] for j in range(L))
                       for p in itertools.permutations(range(L))):
                    hits.append(t - pstart)
            hits = np.asarray(hits, np.int64)
            result = hits if result is None else np.intersect1d(result, hits)
        return result

    def _phrase_anchors(self, occs) -> np.ndarray:
        n = len(occs)
        cand = occs[0]
        for i in range(1, n):
            cand = np.intersect1d(cand, occs[i] - i, assume_unique=True)
        cand = cand[(cand >= 0) & (cand + n <= self.T)]
        return cand[self.doc_of[cand] == self.doc_of[cand + n - 1]]

    def _near(self, occs, pivot: int, window: int):
        t = occs[pivot]
        score = self._w(np.zeros(len(t)))
        ok = np.ones(len(t), bool)
        for i, occ in enumerate(occs):
            if i == pivot:
                continue
            d = self._nearest(occ, t, window)
            ok &= d >= 0
            score = self._add(score, self._w(np.maximum(d, 0)))
        return t[ok], score[ok]

    def _kword(self, occs, anchor: int, window: int):
        t = occs[anchor]
        low = (np.int64(1) << (window + 1)) - 1
        starts = np.full(len(t), (np.int64(1) << (window + 1)) - 1, np.int64)
        score = self._w(np.zeros(len(t)))
        for i, occ in enumerate(occs):
            if i == anchor:
                continue
            mask = self._offset_masks(occ, t, window)
            bits = np.zeros(len(t), np.int64)
            for w0 in range(window + 1):
                bits |= np.where((mask >> w0) & low != 0,
                                 np.int64(1) << w0, 0)
            starts &= bits
            d = self._nearest(occ, t, window)
            score = self._add(score, self._w(np.maximum(d, 0)))
        ok = starts != 0
        return t[ok], score[ok]

    # -- one request ---------------------------------------------------------

    def answer(self, surface_ids, mode: str, window: int | None = None,
               rank: bool = False, top_k: int | None = None) -> Answer:
        if mode == "near" and window is None:
            window = self.near_window
        if mode == "kword" and window is None:
            raise ValueError("kword needs a window")
        best: dict = {}
        all_keys = []
        doc_level: set = set()
        for tiered in self._subqueries(surface_ids):
            n = len(tiered)
            if self.service == "additional" and mode != "kword" and all(
                    t == TIER_STOP for t, _ in tiered):
                if n >= self.min_len:
                    t = self._stop_anchors(tiered)
                    keys = self._keys(t)
                    all_keys.append(keys)
                    if rank:
                        self._keep_best(best, keys,
                                        self._stop_score(n, len(keys)))
                continue
            pivot = self._pivot(tiered, mode)
            if pivot < 0:
                continue
            occs = [self.occurrences(forms) for _, forms in tiered]
            if mode == "phrase":
                t = self._phrase_anchors(occs)
                score = self._stop_score(n, len(t))
            elif mode == "near":
                t, score = self._near(occs, pivot, window)
            else:
                t, score = self._kword(occs, pivot, window)
            keys = self._keys(t)
            all_keys.append(keys)
            if rank:
                self._keep_best(best, keys, score)
            if self.service == "ordinary":
                continue
            docs = None
            for (tier, _), occ in zip(tiered, occs):
                if tier == TIER_STOP:
                    continue
                d = set(np.unique(self.doc_of[occ]).tolist())
                docs = d if docs is None else docs & d
            if docs:
                doc_level |= docs
        keys = (np.unique(np.concatenate(all_keys)) if all_keys
                else np.empty(0, np.int64))
        if self.first_per_doc and len(keys):
            d = keys >> POS_SHIFT
            keys = keys[np.r_[True, d[1:] != d[:-1]]]
        if len(keys):
            ans = Answer(keys, False, np.empty(0, np.int64))
            if rank:
                ans.scores = {int(k): best[int(k)] for k in keys}
                ans.doc_scores = self._doc_scores(ans.scores)
            return ans
        docs = np.asarray(sorted(doc_level), np.int64)
        ans = Answer(keys, len(docs) > 0, docs)
        if rank:
            ans.scores = {}
            ans.doc_scores = {int(d): 0.0 for d in docs}
        return ans

    def _stop_score(self, n: int, m: int) -> np.ndarray:
        s = self._w(np.zeros(m))
        for _ in range(n - 1):
            s = self._add(s, self._w(np.zeros(m)))
        return s

    @staticmethod
    def _keep_best(best: dict, keys, scores):
        for k, s in zip(keys.tolist(), np.asarray(scores).tolist()):
            if k not in best or s > best[k]:
                best[k] = s

    def _doc_scores(self, scores: dict) -> dict:
        out: dict = {}
        for k in sorted(scores):
            d = k >> POS_SHIFT
            prev = out.get(d, 0.0)
            s = prev + scores[k]
            out[d] = float(bf16(s)) if self.score_dtype == "bfloat16" else s
        return out


def top_docs(doc_scores: dict, top_k: int | None) -> list:
    """Documents by (score descending, document ascending), first top_k."""
    order = sorted(doc_scores, key=lambda d: (-doc_scores[d], d))
    return order if top_k is None else order[:top_k]
