"""Synthetic click-log generator for the recsys zoo.

A copy of src/repro/data/recsys_data.py (plain numpy): the same seed gives
the same arrays as the reference.  Labels come from a hidden
factorization-machine teacher so training curves move; behavior sequences
are Markovian over the item vocabulary so MIND's interest capsules have
structure to find.
"""
from __future__ import annotations

import numpy as np


# Criteo-flavored vocabulary ladder: a mix of tiny and huge fields.
def criteo_vocabs(n_fields: int = 39, max_vocab: int = 1_000_000,
                  seed: int = 0) -> tuple:
    ladder = [4, 16, 64, 256, 1024, 8192, 65536, 262144, max_vocab]
    return tuple(int(ladder[i % len(ladder)]) for i in range(n_fields))


class ClickLog:
    def __init__(self, field_vocabs: tuple, embed_dim: int = 8,
                 item_vocab: int = 100_000, seq_len: int = 20, seed: int = 0):
        self.field_vocabs = field_vocabs
        self.item_vocab = item_vocab
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)
        # hidden teacher
        self.teacher = {
            f: self.rng.normal(scale=0.3, size=(v, embed_dim)).astype(np.float32)
            for f, v in enumerate(field_vocabs)
        }
        self.item_teacher = self.rng.normal(
            scale=0.3, size=(item_vocab, embed_dim)).astype(np.float32)

    def _field_ids(self, batch: int) -> np.ndarray:
        ids = np.empty((batch, len(self.field_vocabs)), np.int32)
        for f, v in enumerate(self.field_vocabs):
            # Zipf-ish within each field
            ids[:, f] = (self.rng.zipf(1.3, batch) - 1) % v
        return ids

    def ctr_batch(self, batch: int) -> dict:
        ids = self._field_ids(batch)
        z = np.zeros((batch, next(iter(self.teacher.values())).shape[1]), np.float32)
        for f in range(ids.shape[1]):
            z += self.teacher[f][ids[:, f]]
        logit = (z * z).sum(-1) - np.median((z * z).sum(-1))
        label = (self.rng.random(batch) < 1 / (1 + np.exp(-logit))).astype(np.int32)
        return {"ids": ids, "label": label}

    def seq_batch(self, batch: int) -> dict:
        """Behavior sequences + target item (+ profile fields + label)."""
        ids = self._field_ids(batch)
        # two "interest" anchors per user; items near anchors
        anchors = self.rng.integers(0, self.item_vocab, (batch, 2))
        which = self.rng.integers(0, 2, (batch, self.seq_len))
        noise = self.rng.integers(-50, 51, (batch, self.seq_len))
        hist = (np.take_along_axis(anchors, which, axis=1) + noise) % self.item_vocab
        pad = self.rng.random((batch, self.seq_len)) < 0.1
        hist = np.where(pad, -1, hist).astype(np.int32)
        pos = (anchors[:, 0] + self.rng.integers(-50, 51, batch)) % self.item_vocab
        neg = self.rng.integers(0, self.item_vocab, batch)
        take_pos = self.rng.random(batch) < 0.5
        target = np.where(take_pos, pos, neg).astype(np.int32)
        label = take_pos.astype(np.int32)
        return {"ids": ids, "hist": hist, "target": target, "label": label}

    def retrieval_batch(self, batch: int, n_candidates: int) -> dict:
        b = self.seq_batch(batch)
        b["cand"] = self.rng.integers(0, self.item_vocab, n_candidates).astype(np.int32)
        return b
