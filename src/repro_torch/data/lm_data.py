"""LM token pipeline: packs the framework's synthetic Zipf corpus (the same
generator the search engine indexes) into fixed-length training batches.

The port of src/repro/data/lm_data.py over the port's own
`core.corpus.generate_corpus`: the same arguments yield the same numpy
arrays."""
from __future__ import annotations

import numpy as np

from repro_torch.core.corpus import CorpusConfig, generate_corpus
from repro_torch.core.lexicon import LexiconConfig


def lm_batches(vocab: int, batch: int, seq_len: int, seed: int = 0,
               n_tokens: int | None = None):
    """Yields dict(tokens [B, S] int32, labels [B, S] int32) forever."""
    lex_cfg = LexiconConfig(n_surface=vocab, n_base=max(vocab // 2, 16),
                            n_stop=min(64, vocab // 8),
                            n_frequent=min(256, vocab // 4), seed=seed)
    need = n_tokens or (batch * (seq_len + 1) * 64)
    n_docs = max(need // 800, 8)
    corpus = generate_corpus(lex_cfg, CorpusConfig(n_docs=n_docs, mean_doc_len=800,
                                                   seed=seed))
    stream = corpus.tokens % vocab
    rng = np.random.default_rng(seed + 1)
    T = len(stream)
    while True:
        starts = rng.integers(0, T - seq_len - 1, size=batch)
        idx = starts[:, None] + np.arange(seq_len + 1)[None, :]
        window = stream[idx]
        yield {"tokens": window[:, :-1].astype(np.int32),
               "labels": window[:, 1:].astype(np.int32)}
