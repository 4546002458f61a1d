"""Serving steps of the LM: the prefill that fills the KV cache.

The port of `forward_with_cache` from src/repro/launch/steps.py.  The
reference module also holds the dry-run cells (sharded lowering of every
architecture and shape), which are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.models.transformer import Transformer


@torch.no_grad()
def forward_with_cache(model: Transformer, tokens: torch.Tensor):
    """Prefill: tokens [B, S] -> (last-position logits [B, Vp] float32,
    {"k", "v"}: per-layer cache [L, B, S, Hkv, hd] in the model's dtype).
    Attention is the reference's `causal_attention`, chunked above
    `cfg.attn_chunk.threshold`."""
    cfg = model.cfg
    B, S = tokens.shape
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
    ks = torch.empty(shape, dtype=cfg.dtype, device=tokens.device)
    vs = torch.empty_like(ks)
    x = model.embed[tokens]
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None]
    for layer, ck, cv in zip(model.layers, ks, vs):
        x, k, v = layer(x, positions)
        ck.copy_(k)
        cv.copy_(v)
        del k, v
    return model.logits(x[:, -1]), {"k": ks, "v": vs}
