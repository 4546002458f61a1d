"""Expanded index (w, v): pre-joined co-occurrences of a frequently-used word
w with any non-stop word v within ProcessingDistance(w) (paper: OPTIMIZATION
OF SEARCH-QUERY PROCESSING USING EXPANDED INDEXES).

Postings store the position of w and the *signed* distance to v, so when both
(w, v) and (v, w) would exist (w, v both frequently used) only the canonical
pair min(w,v) < max(w,v) is stored -- the paper's size optimization.  A lookup
of the mirrored pair recovers v's positions as pos + dist.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.postings import CSR, PackedPostings


def pair_key(w: int, v: int, n_base: int) -> int:
    return int(w) * n_base + int(v)


@dataclasses.dataclass
class ExpandedIndex:
    pairs: CSR            # key = w * n_base + v; columns: doc, pos (of w), dist (int8)
    n_base: int
    # device representation: bit-packed (doc, pos, dist) block store
    packed: PackedPostings | None = None

    def nbytes(self) -> int:
        return self.pairs.nbytes()

    def packed_nbytes(self) -> int:
        return self.packed.nbytes() if self.packed is not None else 0

    def has_pair(self, w: int, v: int) -> bool:
        s, e = self.pairs.find(pair_key(w, v, self.n_base))
        return e > s

    def find(self, w: int, v: int, mirrored: bool) -> tuple[int, int]:
        """Slice of the stored (w, v) postings.

        mirrored=True means the caller asked for (v, w) but both words are
        frequent and only the canonical orientation is stored; positions of
        the *second* word are then pos + dist.
        """
        if mirrored:
            w, v = v, w
        return self.pairs.find(pair_key(w, v, self.n_base))

    def lookup(self, w: int, v: int):
        """Occurrences of w with v within ProcessingDistance.

        Returns dict(doc, pos, dist) with pos = positions of w; resolves the
        canonical-orientation mirror transparently.
        """
        s, e = self.pairs.find(pair_key(w, v, self.n_base))
        if e > s:
            return {k: c[s:e] for k, c in self.pairs.columns.items()}
        # mirrored orientation: stored under (v, w); w's positions = pos + dist
        s, e = self.pairs.find(pair_key(v, w, self.n_base))
        if e == s:
            return None
        cols = {k: c[s:e] for k, c in self.pairs.columns.items()}
        return {"doc": cols["doc"],
                "pos": (cols["pos"] + cols["dist"]).astype(np.int32),
                "dist": (-cols["dist"]).astype(np.int8)}
