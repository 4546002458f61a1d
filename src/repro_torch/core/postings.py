"""Posting-list containers, packed-key codecs, and the packed block store.

A *posting* is the paper's (ID, P) record: document id + in-document word
position.  Host-side, every index is a CSR structure-of-arrays:

    offsets : [K + 1] int64     -- slice bounds per key
    columns : dict[str, array]  -- parallel int columns (doc, pos, dist, ...)

The paper's on-disk indexes are compressed posting streams (VByte-style
codings; the follow-up arXiv:1812.07640 leans on compact encodings to make
multi-component keys affordable).  The device-resident twin of that economy
is `PackedPostings`: posting columns grouped into fixed-size blocks of
``BLOCK`` = 128, each block storing a per-field *anchor* (the block minimum)
plus bit-packed deltas in one of a small set of build-time *width classes*
(``PACK_WIDTHS`` = 0/1/2/4/8/16/32 bits — every class divides the 32-bit
lane, so a value never straddles lane words and decode is one gather + one
shift + one mask).  Random access is preserved: posting ordinal ``i`` lives
in block ``i >> 7`` at offset ``i & 127``, so executor fetch slices stay
plain ``(start, length)`` ranges and the un-pack runs vectorized on device
(kernels/ops.unpack_postings; CUDA kernel in kernels/csrc/unpack.cu).  The CSR
``columns`` stay the host-side build product and oracle surface; only the
packed lanes ship to the device.

Key codecs
----------
* doc_pos_key:   doc << 32 | pos                      (total order on postings)
* shifted_key:   doc << 26 | (pos - offset + BIAS)    (phrase intersection)
* stop_phrase_key: L << 60 | sorted 10-bit stop ids   (B-tree key adaptation)
"""
from __future__ import annotations

import dataclasses

import numpy as np

PHRASE_BIAS = 64          # headroom so (pos - offset) never underflows
POS_BITS = 26             # in-doc positions < 2**26 - 2*BIAS
STOP_ID_BITS = 10         # stop vocabulary <= 1024
MAX_STOP_PHRASE_LEN = 5   # 5 * 10 bits + 3-bit length tag < 64 bits


# --------------------------------------------------------------------------
# key codecs (numpy; mirrored in torch by the executor where needed)
# --------------------------------------------------------------------------

def doc_pos_key(doc: np.ndarray, pos: np.ndarray) -> np.ndarray:
    return (doc.astype(np.int64) << 32) | pos.astype(np.int64)


def shifted_key(doc: np.ndarray, pos: np.ndarray, offset) -> np.ndarray:
    """Key such that words at phrase offsets o_i over the same anchor collide.

    Word i of a phrase occurring at position p has anchor p - o_i; a precise
    phrase match is a k-way intersection of these keys (DESIGN.md §2).
    """
    shifted = pos.astype(np.int64) - np.asarray(offset, dtype=np.int64) + PHRASE_BIAS
    return (doc.astype(np.int64) << POS_BITS) | shifted


def unpack_shifted_key(key: np.ndarray, offset=0):
    doc = key >> POS_BITS
    pos = (key & ((1 << POS_BITS) - 1)) - PHRASE_BIAS + offset
    return doc.astype(np.int32), pos.astype(np.int32)


def pack_stop_phrase_key(sorted_local_ids: np.ndarray) -> np.ndarray:
    """[N, L] sorted stop local ids -> [N] int64 keys (duplicates preserved)."""
    ids = np.asarray(sorted_local_ids, dtype=np.int64)
    if ids.ndim == 1:
        ids = ids[None, :]
    n, L = ids.shape
    if L > MAX_STOP_PHRASE_LEN:
        raise ValueError(f"stop-phrase length {L} > {MAX_STOP_PHRASE_LEN}")
    key = np.full(n, np.int64(L) << 60, dtype=np.int64)
    for i in range(L):
        key |= ids[:, i] << (STOP_ID_BITS * i)
    return key


def pack_multi_pair_key(stop_id, v, n_base) -> np.ndarray:
    """Two-component multi-key: (s, v) with s a stop basic form and v any
    non-stop basic form.  s is always the first component (canonical
    stop-first orientation), so every stop-adjacent word pair in the corpus
    is reachable via exactly one key."""
    return np.asarray(stop_id, dtype=np.int64) * np.int64(n_base) \
        + np.asarray(v, dtype=np.int64)


def unpack_multi_pair_key(key, n_base):
    key = np.asarray(key, dtype=np.int64)
    return key // n_base, key % n_base


def pack_multi_triple_key(s1, s2, v, n_stop) -> np.ndarray:
    """Three-component multi-key (arXiv:2006.07954): two distinct stop basic
    forms s1 < s2 (canonical sorted order) around a non-stop form v.  Stop
    ids < 1024 and base ids < 2**40, so the key fits int64 with room."""
    s1 = np.asarray(s1, dtype=np.int64)
    s2 = np.asarray(s2, dtype=np.int64)
    v = np.asarray(v, dtype=np.int64)
    return (v * n_stop + s2) * n_stop + s1


def unpack_multi_triple_key(key, n_stop):
    key = np.asarray(key, dtype=np.int64)
    s1 = key % n_stop
    rest = key // n_stop
    return s1, rest % n_stop, rest // n_stop


MULTI_DIST_BITS = 4    # nearest-stop distances <= MaxDistance (7) fit 4 bits


def pack_dist_pair(d1, d2) -> np.ndarray:
    """Triple-posting payload: the pair of nearest |distances| (d1 of s1,
    d2 of s2) packed into one int8 — one nibble each (NeighborDistance
    <= 15), stored bit-exact in the int8 container (unpack masks the sign
    away) — compatible with the arena's int8 dist column and the 17-bit
    packed-key position layout (positions themselves stay in the pos
    column)."""
    return ((np.asarray(d1, np.int32) << MULTI_DIST_BITS)
            | np.asarray(d2, np.int32)).astype(np.int8)


def unpack_dist_pair(packed):
    p = np.asarray(packed).astype(np.int32) & 0xFF
    return p >> MULTI_DIST_BITS, p & ((1 << MULTI_DIST_BITS) - 1)


NS_SHIFT = 10     # stop local id < 1024 -> 10 bits; (delta+MaxD) <= 14 -> 4 bits


def pack_near_stop_slot(delta: np.ndarray, stop_local: np.ndarray, max_distance: int) -> np.ndarray:
    """Stream-3 slot: (delta + MaxDistance) << 10 | stop_local, in int16
    (14 bits used; empty = -1).  Half the stream-3 footprint of int32."""
    packed = ((delta.astype(np.int32) + max_distance) << NS_SHIFT) \
        | stop_local.astype(np.int32)
    return packed.astype(np.int16)


def unpack_near_stop_slot(slot: np.ndarray, max_distance: int):
    slot = np.asarray(slot).astype(np.int32)
    delta = (slot >> NS_SHIFT) - max_distance
    stop_local = slot & ((1 << NS_SHIFT) - 1)
    return delta, stop_local


# --------------------------------------------------------------------------
# CSR container
# --------------------------------------------------------------------------

@dataclasses.dataclass
class CSR:
    """Sorted-key CSR posting store.

    keys[k] owns columns[*][offsets[k]:offsets[k+1]].  `keys` is sorted so
    lookup is a binary search — the TPU-native replacement for the paper's
    B-tree (DESIGN.md §2).
    """

    keys: np.ndarray          # [K] int64, sorted ascending
    offsets: np.ndarray       # [K + 1] int64
    columns: dict[str, np.ndarray]

    def __post_init__(self):
        assert self.offsets.shape == (len(self.keys) + 1,)
        for c in self.columns.values():
            assert len(c) == self.offsets[-1], (len(c), self.offsets[-1])

    @property
    def n_keys(self) -> int:
        return len(self.keys)

    @property
    def n_postings(self) -> int:
        return int(self.offsets[-1])

    def nbytes(self) -> int:
        n = self.keys.nbytes + self.offsets.nbytes
        return n + sum(c.nbytes for c in self.columns.values())

    def find(self, key: int) -> tuple[int, int]:
        """(start, end) slice for `key`; (0, 0) when absent."""
        i = int(np.searchsorted(self.keys, key))
        if i == len(self.keys) or self.keys[i] != key:
            return (0, 0)
        return (int(self.offsets[i]), int(self.offsets[i + 1]))

    def count(self, key: int) -> int:
        s, e = self.find(key)
        return e - s

    def slice(self, key: int) -> dict[str, np.ndarray]:
        s, e = self.find(key)
        return {name: col[s:e] for name, col in self.columns.items()}

    @staticmethod
    def from_unsorted(keys: np.ndarray, columns: dict[str, np.ndarray],
                      presorted: bool = False) -> "CSR":
        """Group unsorted per-posting keys into a CSR (stable within key)."""
        if len(keys) == 0:
            return CSR(keys=np.empty(0, np.int64), offsets=np.zeros(1, np.int64),
                       columns={k: v[:0] for k, v in columns.items()})
        if not presorted:
            order = np.argsort(keys, kind="stable")
            keys = keys[order]
            columns = {k: v[order] for k, v in columns.items()}
        uniq, counts = np.unique(keys, return_counts=True)
        offsets = np.zeros(len(uniq) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return CSR(keys=uniq.astype(np.int64), offsets=offsets, columns=columns)


@dataclasses.dataclass
class DenseCSR:
    """CSR over a dense id space [0, K): offsets only, no key search.

    Used for the basic index (key = basic-form id) where the id space is
    dense and small.
    """

    offsets: np.ndarray       # [K + 1] int64
    columns: dict[str, np.ndarray]

    @property
    def n_keys(self) -> int:
        return len(self.offsets) - 1

    @property
    def n_postings(self) -> int:
        return int(self.offsets[-1])

    def nbytes(self) -> int:
        return self.offsets.nbytes + sum(c.nbytes for c in self.columns.values())

    def find(self, key: int) -> tuple[int, int]:
        return (int(self.offsets[key]), int(self.offsets[key + 1]))

    def count(self, key: int) -> int:
        s, e = self.find(key)
        return e - s

    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)

    def slice(self, key: int) -> dict[str, np.ndarray]:
        s, e = self.find(key)
        return {name: col[s:e] for name, col in self.columns.items()}

    @staticmethod
    def from_ids(ids: np.ndarray, n_keys: int, columns: dict[str, np.ndarray],
                 presorted: bool = False) -> "DenseCSR":
        if not presorted:
            order = np.argsort(ids, kind="stable")
            ids = ids[order]
            columns = {k: v[order] for k, v in columns.items()}
        counts = np.bincount(ids, minlength=n_keys).astype(np.int64)
        offsets = np.zeros(n_keys + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return DenseCSR(offsets=offsets, columns=columns)


# --------------------------------------------------------------------------
# packed block store (the device postings codec)
# --------------------------------------------------------------------------

BLOCK = 128                    # postings per packed block
BLOCK_LOG2 = 7
PACK_WIDTHS = (0, 1, 2, 4, 8, 16, 32)   # bits/value; all divide the 32b lane
PACK_WIDTH_BITS = 6            # field width slot in blk_widths (holds 0..32)

# mask per width, indexable by width value (0..32); int64 so numpy keeps the
# 32-bit all-ones mask positive host-side (device mirrors use int32 -1)
PACK_MASKS = np.zeros(33, np.int64)
for _w in PACK_WIDTHS:
    PACK_MASKS[_w] = (1 << _w) - 1


def _pack_width_classes(span: np.ndarray) -> np.ndarray:
    """Per-block value span (uint64) -> smallest admissible width class."""
    width = np.full(span.shape, 32, np.int32)
    for w in reversed(PACK_WIDTHS[:-1]):
        width[span <= np.uint64(PACK_MASKS[w])] = w
    return width


def pad_block_multiple(col: np.ndarray, n_padded: int) -> np.ndarray:
    """THE block-pad rule: edge-replicate `col` to `n_padded` entries.

    Shared by PackedPostings.from_columns, the executors' raw arena columns,
    and the multi stream's internal pair pad — raw and packed ordinals must
    line up one-for-one, so there is exactly one copy of this rule."""
    pad = n_padded - len(col)
    if pad <= 0:
        return col
    edge = col[-1:] if len(col) else np.zeros(1, col.dtype)
    return np.concatenate([col, np.repeat(edge, pad)])


@dataclasses.dataclass
class PackedPostings:
    """Bit-packed block store over parallel int columns.

    Postings are grouped into blocks of BLOCK = 128 (the tail block is
    padded by edge-replication, so pads never widen a class).  Per block and
    per field the store keeps the *anchor* (block minimum, int32) and a
    width class w ∈ PACK_WIDTHS; the 128 deltas ``value - anchor`` are
    bit-packed little-endian into ``128 * w / 32`` consecutive int32 lane
    words.  A block's fields are laid out back to back starting at
    ``blk_base[blk]``; widths ride ``blk_widths`` (PACK_WIDTH_BITS bits per
    field).  Values are recovered exactly modulo 2**32 — i.e. bit-exactly
    for every int32/int8 posting column — by

        word  = base_f + ((off * w) >> 5)        off = ordinal & 127
        shift = (off * w) & 31
        value = anchor + ((lanes[word] >> shift) & mask(w))

    which is one gather + shift + mask per field: random access, no block
    scan, no branch — the same math numpy-decoded here and torch/CUDA-
    decoded on device (kernels/ops.unpack_postings).
    """

    n: int                        # real postings (pads excluded)
    fields: tuple                 # field order, e.g. ("doc", "pos", "dist")
    lanes: np.ndarray             # [W] int32 packed delta words
    blk_base: np.ndarray          # [NB] int32 first lane word of each block
    blk_widths: np.ndarray        # [NB] int32 packed per-field width classes
    anchors: dict                 # field -> [NB] int32 block minimum

    @property
    def n_blocks(self) -> int:
        return len(self.blk_base)

    @property
    def n_padded(self) -> int:
        """Postings including the tail pad — always a BLOCK multiple."""
        return self.n_blocks * BLOCK

    def nbytes(self) -> int:
        return (self.lanes.nbytes + self.blk_base.nbytes
                + self.blk_widths.nbytes
                + sum(a.nbytes for a in self.anchors.values()))

    def field_width(self, field: str) -> np.ndarray:
        i = self.fields.index(field)
        return (self.blk_widths >> (PACK_WIDTH_BITS * i)) \
            & ((1 << PACK_WIDTH_BITS) - 1)

    def meta_matrix(self) -> np.ndarray:
        """[NB, 2 + n_fields] int32 per-block metadata in the device layout
        ops.unpack_postings consumes — column 0 = blk_base, 1 = blk_widths,
        2.. = per-field anchors (field order) — so the bucket step pays ONE
        metadata gather per posting instead of five."""
        return np.stack([self.blk_base, self.blk_widths]
                        + [self.anchors[f] for f in self.fields],
                        axis=1).astype(np.int32)

    def _field_base(self, field: str) -> np.ndarray:
        """Per-block first lane word of `field` (fields laid out in order;
        each occupies width * BLOCK / 32 = width << 2 words)."""
        base = self.blk_base.astype(np.int64).copy()
        for f in self.fields:
            if f == field:
                return base
            base += self.field_width(f).astype(np.int64) << 2
        raise KeyError(field)

    def decode(self, field: str, start: int = 0,
               end: int | None = None) -> np.ndarray:
        """Exact int32 values of `field` for posting ordinals [start, end)
        (pads beyond `n` decode to the edge-replicated tail value)."""
        if end is None:
            end = self.n
        idx = np.arange(start, end, dtype=np.int64)
        blk = idx >> BLOCK_LOG2
        off = idx & (BLOCK - 1)
        w = self.field_width(field)[blk].astype(np.int64)
        bit = off * w
        word = self._field_base(field)[blk] + (bit >> 5)
        word = np.minimum(word, len(self.lanes) - 1)   # w == 0 at the end
        sh = (bit & 31).astype(np.uint32)
        raw = self.lanes[word].astype(np.uint32)
        delta = (raw >> sh) & PACK_MASKS[w].astype(np.uint64).astype(np.uint32)
        return (self.anchors[field][blk].astype(np.uint32)
                + delta).astype(np.int32)

    def decode_all(self) -> dict:
        return {f: self.decode(f) for f in self.fields}

    @staticmethod
    def from_columns(columns: dict, fields: tuple | None = None
                     ) -> "PackedPostings":
        """Pack parallel posting columns (any int dtype ≤ 32 bits)."""
        fields = tuple(fields if fields is not None else columns.keys())
        n = len(columns[fields[0]]) if fields else 0
        nb = max(1, -(-n // BLOCK))
        views, widths, anchors = {}, {}, {}
        for f in fields:
            col = np.asarray(columns[f])
            assert len(col) == n, (f, len(col), n)
            col = pad_block_multiple(col, nb * BLOCK)
            v = col.astype(np.int64).reshape(nb, BLOCK)
            mn = v.min(axis=1)
            span = (v.max(axis=1) - mn).astype(np.uint64)
            views[f] = v
            widths[f] = _pack_width_classes(span)
            anchors[f] = mn.astype(np.int32)
        words_per_block = sum(widths[f].astype(np.int64) << 2 for f in fields) \
            if fields else np.zeros(nb, np.int64)
        blk_base = np.zeros(nb, np.int64)
        np.cumsum(words_per_block[:-1], out=blk_base[1:])
        total = int(blk_base[-1] + words_per_block[-1]) if nb else 0
        lanes = np.zeros(max(total, 1), np.uint32)
        field_base = blk_base.copy()
        for f in fields:
            w_f = widths[f]
            for w in PACK_WIDTHS[1:]:
                sel = np.nonzero(w_f == w)[0]
                if not len(sel):
                    continue
                delta = (views[f][sel]
                         - anchors[f][sel].astype(np.int64)[:, None])
                vpw = 32 // w
                d3 = delta.astype(np.uint64).astype(np.uint32) \
                    .reshape(len(sel), BLOCK // vpw, vpw)
                shifts = (np.arange(vpw, dtype=np.uint32) * np.uint32(w))
                packed = np.bitwise_or.reduce(d3 << shifts[None, None, :],
                                              axis=2)
                tgt = field_base[sel][:, None] \
                    + np.arange(BLOCK // vpw, dtype=np.int64)[None, :]
                lanes[tgt.ravel()] = packed.ravel()
            field_base += w_f.astype(np.int64) << 2
        blk_widths = np.zeros(nb, np.int32)
        for i, f in enumerate(fields):
            blk_widths |= widths[f] << (PACK_WIDTH_BITS * i)
        return PackedPostings(
            n=n, fields=fields, lanes=lanes.astype(np.int32),
            blk_base=blk_base.astype(np.int32), blk_widths=blk_widths,
            anchors=anchors)


def concat_packed(stores: list) -> "PackedPostings":
    """Concatenate packed stores into one (posting ordinals shift by each
    predecessor's *padded* count — callers must use BLOCK-aligned stream
    bases, which ``n_padded`` is by construction)."""
    assert stores
    fields = stores[0].fields
    assert all(s.fields == fields for s in stores)
    lane_off, base_parts = 0, []
    for s in stores:
        base_parts.append(s.blk_base.astype(np.int64) + lane_off)
        lane_off += len(s.lanes)
    return PackedPostings(
        n=sum(s.n_padded for s in stores),   # pads are addressable ordinals
        fields=fields,
        lanes=np.concatenate([s.lanes for s in stores]),
        blk_base=np.concatenate(base_parts).astype(np.int32),
        blk_widths=np.concatenate([s.blk_widths for s in stores]),
        anchors={f: np.concatenate([s.anchors[f] for s in stores])
                 for f in fields})
