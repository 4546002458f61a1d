"""Serving steps: the LM prefill that fills the KV cache, and the recsys
serve and retrieval steps.

The port of `forward_with_cache` and of the recsys cells' step bodies from
src/repro/launch/steps.py, without the mesh.  The reference module also
holds the dry-run cells (sharded lowering of every architecture and
shape) and the training steps, which are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.models import recsys as rec
from repro_torch.models.transformer import Transformer

RETRIEVAL_TOP_K = 128          # the reference retrieval cell's lax.top_k


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


@torch.no_grad()
def recsys_serve_step(model: rec.RecSysModel, batch: dict) -> torch.Tensor:
    """The recsys serve cell's step: float32 scores [B] of `batch` (torch
    tensors on the model's device: `ids`, and `hist`, `target` for bst and
    mind)."""
    return rec.serve_scores(model, batch)


@torch.no_grad()
def recsys_retrieval_step(model: rec.RecSysModel, batch: dict):
    """The recsys retrieval cell's step: `retrieval_scores` of `batch`
    (`cand` [C] besides the serve inputs), then its top RETRIEVAL_TOP_K per
    row as (values, indices), ties to the lower index as `jax.lax.top_k`
    (a stable descending sort: `torch.topk` promises no order on ties)."""
    scores = rec.retrieval_scores(model, batch)
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[:, :RETRIEVAL_TOP_K], idx[:, :RETRIEVAL_TOP_K]
