"""Three-stream basic index (paper: EXPANSION OF INFORMATION STORAGE...).

Stream 1: per (word, doc) -- doc id, first occurrence, occurrence count.
          Distance-insensitive search reads ONLY this stream (an order of
          magnitude fewer postings).
Stream 2: all occurrences (doc, pos).  (Storage-wise we keep streams 1+2 as a
          single occurrence CSR; the *metric* distinction -- how many postings
          a query reads -- is preserved because stream 1 is its own CSR.)
Stream 3: near-stop info, one fixed-width slot row per occurrence, read only
          when the query actually contains stop words (Type 4).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.postings import DenseCSR, PackedPostings, unpack_near_stop_slot


@dataclasses.dataclass
class BasicIndex:
    occurrences: DenseCSR      # key = basic-form id; columns: doc, pos
    first_occ: DenseCSR        # key = basic-form id; columns: doc, pos, count
    near_stop: np.ndarray      # [n_postings, K] int32 slots, -1 = empty (stream 3)
    max_distance: int
    # device representation: bit-packed (doc, pos) block stores
    packed_occ: PackedPostings | None = None
    packed_first: PackedPostings | None = None

    def nbytes(self) -> int:
        return self.occurrences.nbytes() + self.first_occ.nbytes() + self.near_stop.nbytes

    def packed_nbytes(self) -> int:
        if self.packed_occ is None:
            return 0
        return self.packed_occ.nbytes() + self.packed_first.nbytes()

    def occ_count(self, base_id: int) -> int:
        return self.occurrences.count(base_id)

    def doc_count(self, base_id: int) -> int:
        return self.first_occ.count(base_id)

    def near_stop_of(self, base_id: int):
        """Stream-3 rows aligned with `occurrences.slice(base_id)`."""
        s, e = self.occurrences.find(base_id)
        return self.near_stop[s:e]

    def decode_near_stop(self, slots: np.ndarray):
        """[N, K] slots -> (delta [N,K], stop_local [N,K], valid [N,K])."""
        valid = slots >= 0
        delta, stop_local = unpack_near_stop_slot(np.maximum(slots, 0), self.max_distance)
        return delta, stop_local, valid
