"""Stop-phrase index: all phrases of MinLength..MaxLength consecutive stop
words, keyed by the *sorted* list of stop basic-form ids (paper: SEARCH
INDEXES FOR PHRASES CONSISTING OF STOP WORDS).

The paper keys a B-tree with a Huffman-coded sorted id list; our TPU-native
adaptation packs the sorted list into a fixed-width int64 (10 bits per stop
id, 3-bit length tag) and binary-searches a sorted key array — branch-free
and batchable (DESIGN.md §2).  One logical index per length L is stored; all
lengths share one CSR since the length tag is part of the key.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.postings import CSR, PackedPostings, pack_stop_phrase_key


@dataclasses.dataclass
class StopPhraseIndex:
    phrases: CSR          # key = packed sorted stop ids; columns: doc, pos (phrase start)
    min_len: int
    max_len: int
    # device representation: bit-packed (doc, pos) block store
    packed: PackedPostings | None = None

    def nbytes(self) -> int:
        return self.phrases.nbytes()

    def packed_nbytes(self) -> int:
        return self.packed.nbytes() if self.packed is not None else 0

    def find(self, stop_local_ids) -> tuple[int, int]:
        """Slice for a phrase given its stop *local* ids (any order)."""
        ids = np.sort(np.asarray(stop_local_ids, dtype=np.int64))
        if not (self.min_len <= len(ids) <= self.max_len):
            return (0, 0)
        key = int(pack_stop_phrase_key(ids[None, :])[0])
        return self.phrases.find(key)

    def lookup(self, stop_local_ids):
        s, e = self.find(stop_local_ids)
        return {k: c[s:e] for k, c in self.phrases.columns.items()}
