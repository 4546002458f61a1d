"""Multi-component key index: additional indexes built around stop forms
(arXiv:1812.07640 multi-component keys; arXiv:2006.07954 three-component
construction).

The paper's Type-4 rule confines near-mode queries that contain stop forms
to sequential matching, because the basic index holds no stop-word posting
lists to window against.  Veretennikov's follow-up closes that gap with
additional indexes whose keys have several word components:

* **pairs** — two-component keys ``(s, v)``: every co-occurrence of a stop
  basic form *s* with a non-stop basic form *v* within NeighborDistance
  (= ``IndexParams.near_window``, the default near-mode window), including
  distance 0 (a single token
  carrying both forms).  Postings store ``(doc, pos of s, dist = pos_v -
  pos_s)``, exactly the expanded-index layout, so a near-mode lookup keyed
  at the *pivot* position is ``pos + dist`` — the same ``pivot_from_dist``
  math the executor already runs for expanded fetches.

* **triples** — three-component keys ``(s1, s2, v)`` with ``s1 < s2`` two
  distinct stop forms near a non-stop *v*.  One posting per *v* occurrence
  that has both stops within NeighborDistance, anchored at ``pos of v``
  with ``dist = max(nearest |d1|, nearest |d2|)`` — so the executor's
  ``|dist| <= window`` mask answers "both stops within the window of this
  pivot occurrence" in one fetch instead of two.  The individual nearest
  distances ride along as a packed position-pair payload (``dpair``,
  4 bits each — see postings.pack_dist_pair) for introspection and the
  construction property tests.

Both CSRs are (doc, pos)-sorted per key, so the batch executor's
shard-segmented gather splits multi-key fetches at doc-shard boundaries
with the same single ``searchsorted`` it uses for every other stream; the
two tables are exposed as ONE concatenated arena stream ("multi").  Device-
side the stream ships as bit-packed blocks (``packed_pairs`` /
``packed_triples``, postings.PackedPostings): the pair segment is padded to
a BLOCK multiple so the triple segment starts block-aligned, and
``find_triple`` offsets its slices by that padded base.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.postings import (BLOCK, CSR, PackedPostings,
                                 pack_multi_pair_key, pack_multi_triple_key,
                                 pad_block_multiple)


@dataclasses.dataclass
class MultiKeyIndex:
    pairs: CSR      # key = s * n_base + v; columns: doc, pos (of s), dist
    triples: CSR    # key = (v * n_stop + s2) * n_stop + s1;
                    # columns: doc, pos (of v), dist (= max nearest), dpair
    n_base: int
    n_stop: int
    neighbor_distance: int   # = IndexParams.near_window at build time
    # size dial (IndexParams.triple_pair_min_count): when triples are gated
    # to the common (s1, s2) stop pairs, this holds the ADMITTED pairs as a
    # sorted array of packed s1 * n_stop + s2 codes (s1 < s2).  None = every
    # pair admitted (no gating).  The planner falls back to two two-component
    # lookups for non-admitted pairs — semantics identical, postings differ.
    triple_stop_pairs: np.ndarray | None = None
    # device representation: bit-packed block stores of the (doc, pos, dist)
    # columns (postings.PackedPostings), built once at index-build time
    packed_pairs: PackedPostings | None = None
    packed_triples: PackedPostings | None = None

    @property
    def n_pair_postings(self) -> int:
        return self.pairs.n_postings

    @property
    def n_triple_postings(self) -> int:
        return self.triples.n_postings

    @property
    def n_postings(self) -> int:
        return self.n_pair_postings + self.n_triple_postings

    def nbytes(self) -> int:
        return self.pairs.nbytes() + self.triples.nbytes()

    def packed_nbytes(self) -> int:
        """Device bytes of the packed pair + triple stream."""
        if self.packed_pairs is None:
            return 0
        return self.packed_pairs.nbytes() + self.packed_triples.nbytes()

    @property
    def pair_pad(self) -> int:
        """BLOCK-aligned length of the pair segment in the "multi" stream
        (triples start here, in both the raw and the packed arena)."""
        return -(-max(self.pairs.n_postings, 1) // BLOCK) * BLOCK

    def arena_columns(self) -> dict[str, np.ndarray]:
        """doc/pos/dist concatenated pairs-then-triples — the single "multi"
        stream of the executor arenas, with the pair segment edge-padded to
        `pair_pad` so the raw columns line up ordinal-for-ordinal with the
        packed block store.  find_pair/find_triple return slices into this
        concatenation (pads are never inside a slice)."""
        out = {}
        for name in ("doc", "pos", "dist"):
            out[name] = np.concatenate(
                [pad_block_multiple(self.pairs.columns[name], self.pair_pad),
                 self.triples.columns[name]])
        return out

    def find_pair(self, stop_id: int, v: int) -> tuple[int, int]:
        """(start, end) slice of the (s, v) postings in the multi stream."""
        return self.pairs.find(int(pack_multi_pair_key(stop_id, v, self.n_base)))

    def has_triple_pair(self, s1: int, s2: int) -> bool:
        """True when (s1, s2) triples were admitted at build time (always
        true without gating) — the planner's triple-vs-two-pairs dispatch."""
        if self.triple_stop_pairs is None:
            return True
        a, b = (s1, s2) if s1 < s2 else (s2, s1)
        code = a * self.n_stop + b
        i = int(np.searchsorted(self.triple_stop_pairs, code))
        return i < len(self.triple_stop_pairs) and \
            int(self.triple_stop_pairs[i]) == code

    def find_triple(self, s1: int, s2: int, v: int) -> tuple[int, int]:
        """(start, end) slice of the (s1, s2, v) postings in the multi
        stream (canonicalizes the stop-component order)."""
        a, b = (s1, s2) if s1 < s2 else (s2, s1)
        s, e = self.triples.find(int(pack_multi_triple_key(a, b, v, self.n_stop)))
        off = self.pair_pad
        return s + off, e + off
