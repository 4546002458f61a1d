"""Index construction (paper: ALGORITHM FOR INDEX CREATION).

Builds, from a tokenized corpus + morphological analyzer:

  * the three-stream basic index (all non-stop basic forms),
  * the expanded (w, v) index for frequently-used words,
  * the stop-phrase index for MinLength..MaxLength stop-word phrases,
  * the multi-component key index — (s, v) pairs and (s1, s2, v) triples
    around stop forms (arXiv:1812.07640 / arXiv:2006.07954) that give
    near-mode queries containing stop words true windowed semantics,
  * an "ordinary" single inverted index (the Sphinx-style baseline the paper
    compares against — every basic form, stop words included).

Everything is vectorized numpy (index construction is offline, exactly as in
the paper); a paper-literal Queue/`Process` implementation is kept as the
reference oracle for the stop-phrase enumeration and cross-checked in tests.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from repro_torch.core.analyzer import Analyzer
from repro_torch.core.basic_index import BasicIndex
from repro_torch.core.corpus import Corpus
from repro_torch.core.expanded_index import ExpandedIndex
from repro_torch.core.lexicon import Lexicon
from repro_torch.core.multi_key_index import MultiKeyIndex
from repro_torch.core.postings import (
    CSR,
    DenseCSR,
    MAX_STOP_PHRASE_LEN,
    PackedPostings,
    pack_dist_pair,
    pack_multi_pair_key,
    pack_multi_triple_key,
    pack_near_stop_slot,
    pack_stop_phrase_key,
)
from repro_torch.core.stop_phrase_index import StopPhraseIndex


@dataclasses.dataclass(frozen=True)
class IndexParams:
    min_len: int = 2           # MinLength (stop-phrase index)
    max_len: int = 5           # MaxLength (paper uses 5)
    max_distance: int = 5      # MaxDistance for stream 3 (paper: 5-7)
    near_window: int = 8       # default NEAR-mode window = NeighborDistance
                               # of the multi-key index and the minimum reach
                               # of expanded pairs.  8 = 2*(5-1): the paper's
                               # 2.2 every-other-word queries (<= 5 words)
                               # are within-window of ANY pivot by
                               # construction, which is what makes
                               # near_stop_confined_misses == 0 structural
                               # rather than empirical (the follow-up papers
                               # run MaxDistance up to 9 for the same
                               # reason).  <= 15 so triple distance pairs
                               # pack into the int8 dpair payload.
    near_slots: int = 20       # fixed-width stream-3 slots per occurrence;
                               # 4*max_distance (2 forms x 2D positions) is
                               # lossless -- smaller trades recall for size
    chunk: int = 1 << 20       # build-time chunking to bound peak memory
    triple_pair_min_count: int = 0
                               # multi-key size dial (ROADMAP): keep
                               # (s1, s2, v) triples only for (s1, s2) stop
                               # pairs with at least this many triple
                               # postings — the planner answers gated pairs
                               # with two two-component lookups instead
                               # (identical semantics, more postings read).
                               # 0 = keep every triple (no gating).
    neighbor_distance: int = 0
                               # multi-key size dial, decoupled from
                               # near_window: NeighborDistance of the (s, v)
                               # pair / (s1, s2, v) triple index.  0 (the
                               # default) follows near_window, preserving
                               # the structural recall guarantee; a smaller
                               # value shrinks the multi-key index roughly
                               # linearly, and near windows wider than it
                               # fall back to banded full ordinary-index
                               # reads (the planner's existing
                               # window > NeighborDistance guard) — correct
                               # at any window, at full-list cost.

    @property
    def multi_key_neighbor_distance(self) -> int:
        return self.neighbor_distance or self.near_window

    def __post_init__(self):
        assert 2 <= self.min_len <= self.max_len <= MAX_STOP_PHRASE_LEN
        assert 1 <= self.near_window <= 15
        assert 0 <= self.neighbor_distance <= 15   # dpair nibble payloads
        if self.near_slots < 4 * self.max_distance:
            import warnings
            warnings.warn("near_slots < 4*max_distance: stream-3 verification "
                          "may drop stop words in dense stop runs (lossy)")


@dataclasses.dataclass
class TokenForms:
    """Per-token expansion of the analyzer output, split by tier.

    s1/s2: up to two *stop* basic forms per token (as stop-local ids; -1 pad).
    n1/n2: up to two *non-stop* basic forms per token (as base ids; -1 pad).
    """

    doc_of: np.ndarray
    pos_of: np.ndarray
    s1_local: np.ndarray
    s2_local: np.ndarray
    n1: np.ndarray
    n2: np.ndarray

    @property
    def stop_mask(self) -> np.ndarray:
        return self.s1_local >= 0


def expand_token_forms(corpus: Corpus, lexicon: Lexicon, analyzer: Analyzer) -> TokenForms:
    prim = analyzer.primary[corpus.tokens]
    sec = analyzer.secondary[corpus.tokens]
    prim_stop = lexicon.is_stop(prim)
    sec_exists = sec >= 0
    sec_stop = sec_exists & lexicon.is_stop(np.maximum(sec, 0))

    s1 = np.where(prim_stop, prim, np.where(sec_stop, sec, -1))
    s2 = np.where(prim_stop & sec_stop, sec, -1)
    to_local = lambda b: np.where(b >= 0, lexicon.stop_local[np.maximum(b, 0)], -1).astype(np.int32)

    prim_ns = ~prim_stop
    sec_ns = sec_exists & ~sec_stop
    n1 = np.where(prim_ns, prim, np.where(sec_ns, sec, -1)).astype(np.int32)
    n2 = np.where(prim_ns & sec_ns, sec, -1).astype(np.int32)

    return TokenForms(
        doc_of=corpus.doc_ids_per_token(),
        pos_of=corpus.positions_per_token(),
        s1_local=to_local(s1),
        s2_local=to_local(s2),
        n1=n1,
        n2=n2,
    )


# ---------------------------------------------------------------------------
# basic index (3 streams)
# ---------------------------------------------------------------------------

def build_basic_index(tf: TokenForms, lexicon: Lexicon, params: IndexParams) -> BasicIndex:
    T = len(tf.doc_of)
    g_idx = np.arange(T, dtype=np.int64)
    m1, m2 = tf.n1 >= 0, tf.n2 >= 0
    bases = np.concatenate([tf.n1[m1], tf.n2[m2]])
    g = np.concatenate([g_idx[m1], g_idx[m2]])

    order = np.lexsort((tf.pos_of[g], tf.doc_of[g], bases))
    bases, g = bases[order], g[order]
    doc, pos = tf.doc_of[g], tf.pos_of[g]

    occurrences = DenseCSR.from_ids(
        bases, lexicon.config.n_base, {"doc": doc, "pos": pos}, presorted=True
    )

    # stream 1: first occurrence per (base, doc) + count
    boundary = np.ones(len(bases), dtype=bool)
    boundary[1:] = (bases[1:] != bases[:-1]) | (doc[1:] != doc[:-1])
    starts = np.nonzero(boundary)[0]
    run_len = np.diff(np.append(starts, len(bases))).astype(np.int32)
    first_occ = DenseCSR.from_ids(
        bases[starts], lexicon.config.n_base,
        {"doc": doc[starts], "pos": pos[starts], "count": run_len},
        presorted=True,
    )

    # stream 3: near-stop slots per occurrence, nearest-first, K slots
    D, K = params.max_distance, params.near_slots
    deltas = np.array([s * d for d in range(1, D + 1) for s in (-1, 1)], dtype=np.int64)
    near = np.full((len(g), K), -1, dtype=np.int16)
    col_rank = np.abs(deltas)  # nearest-first priority (already interleaved)
    for lo in range(0, len(g), params.chunk):
        gs = g[lo : lo + params.chunk]
        part = gs[:, None] + deltas[None, :]
        inb = (part >= 0) & (part < T)
        pc = np.clip(part, 0, T - 1)
        same = inb & (tf.doc_of[pc] == tf.doc_of[gs][:, None])
        cands, ranks = [], []
        for s_local in (tf.s1_local, tf.s2_local):
            sl = s_local[pc]
            ok = same & (sl >= 0)
            cands.append(np.where(ok, pack_near_stop_slot(
                np.broadcast_to(deltas[None, :], sl.shape), sl, D),
                np.int16(-1)).astype(np.int16))
            ranks.append(np.where(ok, col_rank[None, :], 1 << 20))
        cand = np.concatenate(cands, axis=1)
        rank = np.concatenate(ranks, axis=1)
        take = np.argsort(rank, axis=1, kind="stable")[:, :K]
        near[lo : lo + params.chunk] = np.take_along_axis(cand, take, axis=1)

    return BasicIndex(occurrences=occurrences, first_occ=first_occ,
                      near_stop=near, max_distance=D,
                      packed_occ=_pack_stream(occurrences),
                      packed_first=_pack_stream(first_occ))


# ---------------------------------------------------------------------------
# expanded (w, v) index
# ---------------------------------------------------------------------------

def build_expanded_index(tf: TokenForms, lexicon: Lexicon, params: IndexParams) -> ExpandedIndex:
    T = len(tf.doc_of)
    n_base = lexicon.config.n_base
    g_idx = np.arange(T, dtype=np.int64)

    # occurrences of frequently-used basic forms (w side)
    m1 = (tf.n1 >= 0) & lexicon.is_frequent(np.maximum(tf.n1, 0))
    m2 = (tf.n2 >= 0) & lexicon.is_frequent(np.maximum(tf.n2, 0))
    w_base = np.concatenate([tf.n1[m1], tf.n2[m2]]).astype(np.int64)
    w_g = np.concatenate([g_idx[m1], g_idx[m2]])
    # pair reach: ProcessingDistance, floored at the near window so the
    # expanded fast path covers default near-mode queries end to end (the
    # planner's _expanded_group guards any window beyond this reach)
    w_pd = np.maximum(lexicon.processing_distance(w_base), params.near_window)

    keys_parts, doc_parts, pos_parts, dist_parts = [], [], [], []
    max_pd = int(w_pd.max(initial=0))
    for d in range(1, max_pd + 1):
        for sd in (d, -d):
            part = w_g + sd
            inb = (part >= 0) & (part < T)
            pc = np.clip(part, 0, T - 1)
            ok_base = inb & (tf.doc_of[pc] == tf.doc_of[w_g]) & (d <= w_pd)
            for col in (tf.n1, tf.n2):
                v = col[pc].astype(np.int64)
                ok = ok_base & (v >= 0)
                if not ok.any():
                    continue
                w_ok, v_ok = w_base[ok], v[ok]
                # canonical orientation: when both frequent and v < w the pair
                # is stored under (v, w) (emitted from v's side); w == v keeps
                # only the positive direction.
                both_freq = lexicon.is_frequent(v_ok)
                keep = ~(both_freq & (v_ok < w_ok)) & ~((v_ok == w_ok) & (sd < 0))
                if not keep.any():
                    continue
                w_k, v_k, g_k = w_ok[keep], v_ok[keep], w_g[ok][keep]
                keys_parts.append(w_k * n_base + v_k)
                doc_parts.append(tf.doc_of[g_k])
                pos_parts.append(tf.pos_of[g_k])
                dist_parts.append(np.full(len(g_k), sd, dtype=np.int8))

    # same-token pairs (dist 0): a token whose two basic forms straddle the
    # frequent tier is its own (w, v) co-occurrence.  Near-mode windows
    # include the pivot position itself, so without these the expanded path
    # would miss matches the basic-fetch path (and the oracle) finds.
    both = (tf.n1 >= 0) & (tf.n2 >= 0)
    f1 = lexicon.is_frequent(np.maximum(tf.n1, 0)) & both
    f2 = lexicon.is_frequent(np.maximum(tf.n2, 0)) & both
    m0 = f1 | f2
    if m0.any():
        a, b = tf.n1[m0].astype(np.int64), tf.n2[m0].astype(np.int64)
        bf = f1[m0] & f2[m0]
        w0 = np.where(bf, np.minimum(a, b), np.where(f1[m0], a, b))
        v0 = np.where(bf, np.maximum(a, b), np.where(f1[m0], b, a))
        g0 = g_idx[m0]
        keys_parts.append(w0 * n_base + v0)
        doc_parts.append(tf.doc_of[g0])
        pos_parts.append(tf.pos_of[g0])
        dist_parts.append(np.zeros(len(g0), dtype=np.int8))

    pairs = _csr_from_parts(keys_parts, {"doc": doc_parts, "pos": pos_parts,
                                         "dist": dist_parts})
    return ExpandedIndex(pairs=pairs, n_base=n_base,
                         packed=_pack_stream(pairs))


# ---------------------------------------------------------------------------
# multi-component key index (pairs + triples around stop forms)
# ---------------------------------------------------------------------------

def build_multi_key_index(tf: TokenForms, lexicon: Lexicon,
                          params: IndexParams) -> MultiKeyIndex:
    """Multi-component keys around stop forms (see multi_key_index.py).

    Pairs are emitted from the stop side (one pass per signed delta,
    vectorized over every stop occurrence); triples use the arXiv:2006.07954
    two-phase construction: (1) per non-stop occurrence, the NEAREST
    distance to each distinct stop form within NeighborDistance; (2) all
    s1 < s2 combinations per occurrence, enumerated as offset-pairs over
    the (occurrence, stop form)-sorted record list.  Delta 0 (one token
    carrying both a stop and a non-stop form) is included — near-mode
    windows contain the pivot position itself.  NeighborDistance =
    `params.multi_key_neighbor_distance` (= near_window unless the
    `neighbor_distance` size dial shrinks it).
    """
    T = len(tf.doc_of)
    n_base = lexicon.config.n_base
    n_stop = lexicon.config.n_stop
    D = params.multi_key_neighbor_distance
    g_idx = np.arange(T, dtype=np.int64)

    # -- pairs: (s, v), emitted from each stop occurrence -------------------
    s_base = np.concatenate([c[c >= 0].astype(np.int64)
                             for c in (tf.s1_local, tf.s2_local)])
    s_g = np.concatenate([g_idx[c >= 0] for c in (tf.s1_local, tf.s2_local)])
    keys_p, doc_p, pos_p, dist_p = [], [], [], []
    for sd in range(-D, D + 1):
        part = s_g + sd
        inb = (part >= 0) & (part < T)
        pc = np.clip(part, 0, T - 1)
        ok_base = inb & (tf.doc_of[pc] == tf.doc_of[s_g])
        for col in (tf.n1, tf.n2):
            v = col[pc].astype(np.int64)
            ok = ok_base & (v >= 0)
            if not ok.any():
                continue
            keys_p.append(pack_multi_pair_key(s_base[ok], v[ok], n_base))
            doc_p.append(tf.doc_of[s_g[ok]])
            pos_p.append(tf.pos_of[s_g[ok]])
            dist_p.append(np.full(int(ok.sum()), sd, dtype=np.int8))
    pairs = _csr_from_parts(keys_p, {"doc": doc_p, "pos": pos_p,
                                     "dist": dist_p})

    # -- triples: (s1, s2, v), one posting per v occurrence -----------------
    v_base = np.concatenate([c[c >= 0].astype(np.int64)
                             for c in (tf.n1, tf.n2)])
    v_g = np.concatenate([g_idx[c >= 0] for c in (tf.n1, tf.n2)])
    keys_t, doc_t, pos_t, dist_t, dpair_t = [], [], [], [], []
    for lo in range(0, len(v_base), params.chunk):
        vb, vg = v_base[lo:lo + params.chunk], v_g[lo:lo + params.chunk]
        r_idx = np.arange(len(vb), dtype=np.int64)
        rec_r, rec_s, rec_d = [], [], []
        for sd in range(-D, D + 1):
            part = vg + sd
            inb = (part >= 0) & (part < T)
            pc = np.clip(part, 0, T - 1)
            ok_base = inb & (tf.doc_of[pc] == tf.doc_of[vg])
            for col in (tf.s1_local, tf.s2_local):
                s = col[pc].astype(np.int64)
                ok = ok_base & (s >= 0)
                if not ok.any():
                    continue
                rec_r.append(r_idx[ok])
                rec_s.append(s[ok])
                rec_d.append(np.full(int(ok.sum()), abs(sd), dtype=np.int64))
        if not rec_r:
            continue
        r = np.concatenate(rec_r)
        s = np.concatenate(rec_s)
        d = np.concatenate(rec_d)
        # phase 1: nearest distance per (occurrence, stop form)
        rs = r * n_stop + s
        order = np.lexsort((d, rs))
        rs, r, s, d = rs[order], r[order], s[order], d[order]
        keep = np.ones(len(rs), dtype=bool)
        keep[1:] = rs[1:] != rs[:-1]
        r, s, d = r[keep], s[keep], d[keep]
        # phase 2: all s1 < s2 pairs per occurrence (s ascends within each
        # r segment, so offset-pairs enumerate each combination once)
        off = 1
        while off < len(r):
            same = r[:-off] == r[off:]
            if not same.any():
                break
            i = np.nonzero(same)[0]
            s1, d1 = s[i], d[i]
            s2, d2 = s[i + off], d[i + off]
            ri = r[i]
            keys_t.append(pack_multi_triple_key(s1, s2, vb[ri], n_stop))
            doc_t.append(tf.doc_of[vg[ri]])
            pos_t.append(tf.pos_of[vg[ri]])
            dist_t.append(np.maximum(d1, d2).astype(np.int8))
            dpair_t.append(pack_dist_pair(d1, d2))
            off += 1
    triples = _csr_from_parts(keys_t, {"doc": doc_t, "pos": pos_t,
                                       "dist": dist_t, "dpair": dpair_t})
    triples, admitted = _gate_triples(triples, n_stop,
                                      params.triple_pair_min_count)
    return MultiKeyIndex(pairs=pairs, triples=triples, n_base=n_base,
                         n_stop=n_stop, neighbor_distance=D,
                         triple_stop_pairs=admitted,
                         packed_pairs=_pack_stream(pairs),
                         packed_triples=_pack_stream(triples))


def _gate_triples(triples: CSR, n_stop: int, min_count: int):
    """Size dial: drop triples of uncommon (s1, s2) stop pairs (fewer than
    `min_count` postings across all pivots).  Returns (filtered CSR, sorted
    admitted pair codes) — or (triples, None) when gating is off."""
    if min_count <= 0:
        return triples, None
    key_pair = triples.keys % (n_stop * n_stop)       # s2 * n_stop + s1
    s1 = key_pair % n_stop
    s2 = key_pair // n_stop
    pair_code = s1 * n_stop + s2
    counts = np.diff(triples.offsets)
    pair_total = np.zeros(n_stop * n_stop, np.int64)
    np.add.at(pair_total, pair_code, counts)
    admitted = np.nonzero(pair_total >= min_count)[0].astype(np.int64)
    keep_key = pair_total[pair_code] >= min_count
    if keep_key.all():
        return triples, admitted
    keep_post = np.repeat(keep_key, counts)
    flat_keys = np.repeat(triples.keys, counts)[keep_post]
    cols = {k: v[keep_post] for k, v in triples.columns.items()}
    return CSR.from_unsorted(flat_keys, cols, presorted=True), admitted


def _pack_stream(store) -> PackedPostings:
    """Bit-packed device twin of a posting store's (doc, pos, dist) columns.

    Every device stream packs the SAME field triple (zeros standing in for
    absent dist — a constant block is width class 0, i.e. free), so the
    executors' unified arena is one `concat_packed` away.  The triples'
    `dpair` payload stays host-side only (introspection / construction
    tests) and is never shipped."""
    cols = store.columns
    n = len(cols["doc"])
    dist = cols.get("dist")
    return PackedPostings.from_columns(
        {"doc": cols["doc"], "pos": cols["pos"],
         "dist": dist if dist is not None else np.zeros(n, np.int8)},
        fields=("doc", "pos", "dist"))


def _csr_from_parts(key_parts: list, col_parts: dict[str, list]) -> CSR:
    """Concatenate emitted parts into a (key, doc, pos)-lexsorted CSR."""
    if not key_parts:
        empty_cols = {"doc": np.empty(0, np.int32), "pos": np.empty(0, np.int32),
                      "dist": np.empty(0, np.int8), "dpair": np.empty(0, np.int8)}
        return CSR.from_unsorted(np.empty(0, np.int64),
                                 {k: empty_cols[k] for k in col_parts})
    keys = np.concatenate(key_parts)
    cols = {k: np.concatenate(v) for k, v in col_parts.items()}
    order = np.lexsort((cols["pos"], cols["doc"], keys))
    return CSR.from_unsorted(keys[order],
                             {k: v[order] for k, v in cols.items()},
                             presorted=True)


def reference_multi_key_postings(tf: TokenForms, lexicon: Lexicon,
                                 params: IndexParams):
    """Literal nested-loop reference for the multi-key construction — the
    oracle the vectorized builder is cross-checked against in tests.

    Returns (pairs, triples): pairs = list of (key, doc, pos, dist) tuples;
    triples = list of (key, doc, pos, max_dist, (d1, d2)) tuples.
    """
    T = len(tf.doc_of)
    D = params.multi_key_neighbor_distance
    n_base, n_stop = lexicon.config.n_base, lexicon.config.n_stop
    pairs, triples = [], []
    for g in range(T):
        stop_forms = [int(c[g]) for c in (tf.s1_local, tf.s2_local) if c[g] >= 0]
        ns_forms = [int(c[g]) for c in (tf.n1, tf.n2) if c[g] >= 0]
        # pairs from the stop side
        for s in stop_forms:
            for sd in range(-D, D + 1):
                u = g + sd
                if not (0 <= u < T) or tf.doc_of[u] != tf.doc_of[g]:
                    continue
                for v in (int(c[u]) for c in (tf.n1, tf.n2) if c[u] >= 0):
                    pairs.append((int(pack_multi_pair_key(s, v, n_base)),
                                  int(tf.doc_of[g]), int(tf.pos_of[g]), sd))
        # triples from the non-stop side: nearest distance per stop form
        for v in ns_forms:
            nearest: dict[int, int] = {}
            for sd in range(-D, D + 1):
                u = g + sd
                if not (0 <= u < T) or tf.doc_of[u] != tf.doc_of[g]:
                    continue
                for s in (int(c[u]) for c in (tf.s1_local, tf.s2_local)
                          if c[u] >= 0):
                    nearest[s] = min(nearest.get(s, D + 1), abs(sd))
            forms = sorted(nearest)
            for i, s1 in enumerate(forms):
                for s2 in forms[i + 1:]:
                    d1, d2 = nearest[s1], nearest[s2]
                    triples.append((
                        int(pack_multi_triple_key(s1, s2, v, n_stop)),
                        int(tf.doc_of[g]), int(tf.pos_of[g]),
                        max(d1, d2), (d1, d2)))
    return pairs, triples


# ---------------------------------------------------------------------------
# stop-phrase index
# ---------------------------------------------------------------------------

def _multi_form_window_keys(tf: TokenForms, start: int, L: int):
    """All form-choice combinations for one window (paper's Process cycle)."""
    choices = []
    for t in range(start, start + L):
        c = [tf.s1_local[t]]
        if tf.s2_local[t] >= 0:
            c.append(tf.s2_local[t])
        choices.append(c)
    keys = []
    for combo in itertools.product(*choices):
        keys.append(int(pack_stop_phrase_key(np.sort(np.array(combo, np.int64))[None, :])[0]))
    return keys


def build_stop_phrase_index(tf: TokenForms, params: IndexParams) -> StopPhraseIndex:
    T = len(tf.doc_of)
    stop = tf.stop_mask
    multi = tf.s2_local >= 0

    all_keys, all_doc, all_pos = [], [], []
    for L in range(params.min_len, params.max_len + 1):
        if T < L:
            continue
        win_stop = np.lib.stride_tricks.sliding_window_view(stop, L)
        valid = win_stop.all(axis=1) & (tf.doc_of[: T - L + 1] == tf.doc_of[L - 1 :])
        starts = np.nonzero(valid)[0]
        if len(starts) == 0:
            continue
        win_multi = np.lib.stride_tricks.sliding_window_view(multi, L)[starts].any(axis=1)

        single = starts[~win_multi]
        if len(single):
            ids = np.lib.stride_tricks.sliding_window_view(tf.s1_local, L)[single]
            keys = pack_stop_phrase_key(np.sort(ids.astype(np.int64), axis=1))
            all_keys.append(keys)
            all_doc.append(tf.doc_of[single])
            all_pos.append(tf.pos_of[single])

        for st in starts[win_multi]:
            ks = _multi_form_window_keys(tf, int(st), L)
            all_keys.append(np.array(ks, dtype=np.int64))
            all_doc.append(np.full(len(ks), tf.doc_of[st], dtype=np.int32))
            all_pos.append(np.full(len(ks), tf.pos_of[st], dtype=np.int32))

    if all_keys:
        keys = np.concatenate(all_keys)
        doc = np.concatenate(all_doc).astype(np.int32)
        pos = np.concatenate(all_pos).astype(np.int32)
        order = np.lexsort((pos, doc, keys))
        phrases = CSR.from_unsorted(keys[order], {"doc": doc[order], "pos": pos[order]},
                                    presorted=True)
    else:
        phrases = CSR.from_unsorted(np.empty(0, np.int64),
                                    {"doc": np.empty(0, np.int32),
                                     "pos": np.empty(0, np.int32)})
    return StopPhraseIndex(phrases=phrases, min_len=params.min_len,
                           max_len=params.max_len,
                           packed=_pack_stream(phrases))


# ---------------------------------------------------------------------------
# paper-literal reference (Queue / Process) — oracle for tests
# ---------------------------------------------------------------------------

def reference_stop_phrase_postings(tf: TokenForms, params: IndexParams):
    """The ALGORITHM FOR INDEX CREATION section, implemented literally.

    A queue of the last <= MaxLength stop tokens is maintained; whenever the
    head is about to leave (overflow or drain on a non-stop token / document
    boundary), every prefix phrase starting at the head is emitted, cycling
    through each item's form list (`Process`'s Index recursion).  This emits
    each (start, L) window exactly once — matching the paper's "nine phrases
    with 2 words, eight with 3" count for a run of ten stop words.

    Returns a list of (key, doc, pos) tuples (unsorted).
    """
    out = []

    def emit_head(queue):
        head_doc, head_pos = queue[0][0], queue[0][1]
        for L in range(params.min_len, min(len(queue), params.max_len) + 1):
            for combo in itertools.product(*[item[2] for item in queue[:L]]):
                key = int(pack_stop_phrase_key(np.sort(np.array(combo, np.int64))[None, :])[0])
                out.append((key, head_doc, head_pos))

    queue: list[tuple[int, int, list[int]]] = []
    prev_doc = -1
    T = len(tf.doc_of)
    for t in range(T):
        doc = int(tf.doc_of[t])
        if doc != prev_doc:
            while queue:
                emit_head(queue)
                queue.pop(0)
            prev_doc = doc
        forms = []
        if tf.s1_local[t] >= 0:
            forms.append(int(tf.s1_local[t]))
        if tf.s2_local[t] >= 0:
            forms.append(int(tf.s2_local[t]))
        if forms:
            queue.append((doc, int(tf.pos_of[t]), forms))
            if len(queue) > params.max_len:
                emit_head(queue)
                queue.pop(0)
        else:
            while queue:
                emit_head(queue)
                queue.pop(0)
    while queue:
        emit_head(queue)
        queue.pop(0)
    return out


# ---------------------------------------------------------------------------
# ordinary single inverted index (Sphinx-style baseline)
# ---------------------------------------------------------------------------

def build_ordinary_index(tf: TokenForms, lexicon: Lexicon) -> DenseCSR:
    """Every basic form (stop words included) -> (doc, pos). The paper's
    comparison baseline: phrase queries must read full posting lists."""
    T = len(tf.doc_of)
    g_idx = np.arange(T, dtype=np.int64)
    n_stop = lexicon.config.n_stop

    bases_parts, g_parts = [], []
    # non-stop forms
    for col in (tf.n1, tf.n2):
        m = col >= 0
        bases_parts.append(col[m].astype(np.int64))
        g_parts.append(g_idx[m])
    # stop forms (local id -> base id is the identity on [0, n_stop))
    for col in (tf.s1_local, tf.s2_local):
        m = col >= 0
        bases_parts.append(col[m].astype(np.int64))
        g_parts.append(g_idx[m])
    bases = np.concatenate(bases_parts)
    g = np.concatenate(g_parts)
    order = np.lexsort((tf.pos_of[g], tf.doc_of[g], bases))
    bases, g = bases[order], g[order]
    return DenseCSR.from_ids(bases, lexicon.config.n_base,
                             {"doc": tf.doc_of[g], "pos": tf.pos_of[g]}, presorted=True)


# ---------------------------------------------------------------------------
# top-level build
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class IndexSet:
    lexicon: Lexicon
    analyzer: Analyzer
    params: IndexParams
    basic: BasicIndex
    expanded: ExpandedIndex
    stop_phrase: StopPhraseIndex
    multi_key: MultiKeyIndex
    ordinary: DenseCSR
    n_docs: int
    # device representation of the ordinary stream (the other streams carry
    # their packed twin on their own container)
    ordinary_packed: PackedPostings | None = None

    def base_occ_counts(self) -> np.ndarray:
        """Total occurrences per basic form (ordinary-index view, incl. stop)."""
        return self.ordinary.counts()

    def max_posting_run(self) -> int:
        """Longest single posting list across every stream — the stat the
        doc-shard auto-pick keys off (the longest list bounds the per-row
        sort slab of the segmented gather)."""
        stores = (self.basic.occurrences, self.basic.first_occ,
                  self.expanded.pairs, self.stop_phrase.phrases,
                  self.multi_key.pairs, self.multi_key.triples, self.ordinary)
        return max((int(np.diff(s.offsets).max(initial=0)) for s in stores),
                   default=0)

    def size_report(self) -> dict[str, int]:
        rep = {
            "stop_phrase_index_bytes": self.stop_phrase.nbytes(),
            "expanded_index_bytes": self.expanded.nbytes(),
            "multi_key_index_bytes": self.multi_key.nbytes(),
            "basic_index_bytes": self.basic.nbytes(),
            "ordinary_index_bytes": self.ordinary.nbytes(),
            "stop_phrase_postings": self.stop_phrase.phrases.n_postings,
            "expanded_postings": self.expanded.pairs.n_postings,
            "multi_key_pair_postings": self.multi_key.n_pair_postings,
            "multi_key_triple_postings": self.multi_key.n_triple_postings,
            "basic_postings": self.basic.occurrences.n_postings,
            "ordinary_postings": self.ordinary.n_postings,
        }
        rep.update(self.packed_size_report())
        return rep

    def packed_size_report(self) -> dict[str, int]:
        """Device bytes of each bit-packed stream (vs the raw int32/int8
        columns the pre-packed arena shipped, `*_col_bytes`)."""
        mk = self.multi_key

        def cols(store):
            return sum(c.nbytes for n, c in store.columns.items()
                       if n in ("doc", "pos", "dist"))

        rep = {
            "basic_packed_bytes": self.basic.packed_nbytes(),
            "stop_phrase_packed_bytes": self.stop_phrase.packed_nbytes(),
            "expanded_packed_bytes": self.expanded.packed_nbytes(),
            "multi_key_pair_packed_bytes":
                mk.packed_pairs.nbytes() if mk.packed_pairs else 0,
            "multi_key_triple_packed_bytes":
                mk.packed_triples.nbytes() if mk.packed_triples else 0,
            "multi_key_packed_bytes": mk.packed_nbytes(),
            "ordinary_packed_bytes":
                self.ordinary_packed.nbytes() if self.ordinary_packed else 0,
            "basic_col_bytes": (cols(self.basic.occurrences)
                                + cols(self.basic.first_occ)),
            "stop_phrase_col_bytes": cols(self.stop_phrase.phrases),
            "expanded_col_bytes": cols(self.expanded.pairs),
            "multi_key_pair_col_bytes": cols(mk.pairs),
            "multi_key_triple_col_bytes": cols(mk.triples),
            "ordinary_col_bytes": cols(self.ordinary),
        }
        return rep


def auto_docs_per_shard(n_docs: int, max_list_len: int,
                        seg_target: int = 4096) -> int:
    """Doc-shard granularity for the segmented gather, from posting-list
    stats (ROADMAP "easy future win"): enough shards that the longest
    posting list splits into ~seg_target-posting segments, rounded up to a
    power of two and clamped to the packed-key shard cap.  At the canonical
    bench scale (1200 docs, longest list ~9e4) this picks 64 docs/shard
    (19 shards) — ~1.4x faster than 1 shard on the pre-windowed workload
    and parity on the current one (QTYPE_MULTI plans carry many short
    multi-key fetches, so over-sharding multiplies rows: 75 shards cost
    ~1.3-2x; see BENCH_search.json shard_scaling) — while bounding the largest
    per-row sort slab, which is what matters as corpora grow."""
    from repro_torch.core.fetch_tables import DOCS_PER_SHARD
    if n_docs <= 0 or max_list_len <= 0:
        return DOCS_PER_SHARD
    n_shards = max(1, -(-max_list_len // seg_target))
    dps = max(1, -(-n_docs // n_shards))
    p = 1
    while p < dps:
        p <<= 1
    return min(p, DOCS_PER_SHARD)


def build_all(corpus: Corpus, lexicon: Lexicon, analyzer: Analyzer,
              params: IndexParams = IndexParams()) -> IndexSet:
    tf = expand_token_forms(corpus, lexicon, analyzer)
    ordinary = build_ordinary_index(tf, lexicon)
    return IndexSet(
        lexicon=lexicon,
        analyzer=analyzer,
        params=params,
        basic=build_basic_index(tf, lexicon, params),
        expanded=build_expanded_index(tf, lexicon, params),
        stop_phrase=build_stop_phrase_index(tf, params),
        multi_key=build_multi_key_index(tf, lexicon, params),
        ordinary=ordinary,
        n_docs=corpus.n_docs,
        ordinary_packed=_pack_stream(ordinary),
    )
