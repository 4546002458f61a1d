"""Decoder-only LM (dense GQA) — granite / qwen / llama, inference only.

The port of src/repro/models/transformer.py without MoE and without the
training path (`loss_fn`, remat, sharding pins).  One `DecoderLayer`
module per layer instead of weight-stacked scans; parameter names and
layouts follow the reference's dict (`wq` [D, Hq * hd], `wo` [Hq * hd, D],
`embed` [Vp, D], `lm_head` [D, Vp], ...), so carrying weights across is a
per-layer slice (`repro_torch.carry.lm_params_from_reference`).

Weights are stored in `cfg.dtype`.  The reference keeps them in float32
and casts each one to `dtype` at use, which gives the same numbers; stored
in bf16, llama3-8b's weights take 16 GB instead of 32.  Matmuls run in
`dtype`; the logits are float32 products, as the reference's
`preferred_element_type=float32`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from repro_torch.core.executor import resolve_device
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    qkv_bias: bool = False                  # qwen2.5
    rope_theta: float = 500_000.0
    moe: Any = None                         # MoE is not ported: must be None
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    attn_chunk: L.AttnChunking = L.AttnChunking()

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError(
                f"{self.name}: MoE layers are not ported yet (ROADMAP.md "
                f"queue 1, item 10: models/moe.py)")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to 256, as the reference's."""
        return ((self.vocab + 255) // 256) * 256

    def param_count(self) -> int:
        """Parameters, counting the vocabulary unpadded (the reference's
        count, for 6ND bookkeeping)."""
        D, Hq, Hkv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.hd
        attn = D * (Hq + 2 * Hkv) * hd + Hq * hd * D
        if self.qkv_bias:
            attn += (Hq + 2 * Hkv) * hd
        per_layer = attn + 3 * D * self.d_ff + 2 * D
        emb = self.vocab * D * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + D


def _weight(shape, cfg: TransformerConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device),
                        requires_grad=False)


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: GQA attention with RoPE, SwiGLU MLP."""

    def __init__(self, cfg: TransformerConfig, device):
        super().__init__()
        self.cfg = cfg
        D, Hq, Hkv, hd, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.hd, cfg.d_ff)
        self.ln1 = _weight((D,), cfg, device)
        self.ln2 = _weight((D,), cfg, device)
        self.wq = _weight((D, Hq * hd), cfg, device)
        self.wk = _weight((D, Hkv * hd), cfg, device)
        self.wv = _weight((D, Hkv * hd), cfg, device)
        self.wo = _weight((Hq * hd, D), cfg, device)
        if cfg.qkv_bias:
            self.bq = _weight((Hq * hd,), cfg, device)
            self.bk = _weight((Hkv * hd,), cfg, device)
            self.bv = _weight((Hkv * hd,), cfg, device)
        self.wg = _weight((D, F), cfg, device)
        self.wu = _weight((D, F), cfg, device)
        self.wd = _weight((F, D), cfg, device)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x [B, S, D] -> q [B, S, Hq, hd], k, v [B, S, Hkv, hd], RoPE on
        q and k at `positions` (broadcastable to [B, S])."""
        cfg = self.cfg
        B, S, _ = x.shape
        h = L.rms_norm(x, self.ln1)
        q, k, v = h @ self.wq, h @ self.wk, h @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = L.apply_rope(q.reshape(B, S, cfg.n_heads, cfg.hd), positions,
                         cfg.rope_theta)
        k = L.apply_rope(k.reshape(B, S, cfg.n_kv_heads, cfg.hd), positions,
                         cfg.rope_theta)
        return q, k, v.reshape(B, S, cfg.n_kv_heads, cfg.hd)

    def attn_out(self, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        """Residual after attention and the MLP: o is [..., Hq, hd]."""
        x = x + o.reshape(*o.shape[:-2], -1) @ self.wo
        h = L.rms_norm(x, self.ln2)
        return x + L.swiglu(h, self.wg, self.wu, self.wd, self.cfg.dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """x [B, S, D] -> (x', k, v): the whole prompt at once, through the
        reference's `causal_attention` (full or chunked by
        `cfg.attn_chunk`)."""
        q, k, v = self.qkv(x, positions)
        cq, ckv = self.cfg.attn_chunk.for_seq(x.shape[1])
        o = L.causal_attention(q, k, v, chunk_q=cq, chunk_kv=ckv)
        return self.attn_out(x, o), k, v


class Transformer(nn.Module):
    """The model: `embed`, `layers`, `final_norm`, `lm_head` (unless tied).
    Parameters are created uninitialised on `device` (the card unless the
    caller asks for the CPU); `init_params` or `lm_params_from_reference`
    fill them, and the module functions `forward` and `decode_step` (the
    reference's API) run it."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        D = cfg.d_model
        self.embed = _weight((cfg.vocab_padded, D), cfg, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = _weight((D,), cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = _weight((D, cfg.vocab_padded), cfg, device)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final norm and the float32 product with the head: x [..., D]."""
        x = L.rms_norm(x, self.final_norm)
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        with L.exact_f32_products(x):
            return x.float() @ head.float()


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """A model with the reference's initial scales (`init_params`), drawn
    tensor by tensor from `generator` (a generator on `device`) on `device`.
    Norm scales 1, biases 0."""
    model = Transformer(cfg, device)
    dev = model.device
    D, Hq, hd, F, Lx = (cfg.d_model, cfg.n_heads, cfg.hd, cfg.d_ff,
                        cfg.n_layers)

    def init(shape, scale=None):
        return L.dense_init(generator, shape, cfg.dtype, scale=scale,
                            device=dev)

    for layer in model.layers:
        layer.ln1.fill_(1)
        layer.ln2.fill_(1)
        for name in ("wq", "wk", "wv", "wg", "wu"):
            w = getattr(layer, name)
            w.copy_(init(w.shape))
        layer.wo.copy_(init(layer.wo.shape,
                            (Hq * hd) ** -0.5 / (2 * Lx) ** 0.5))
        layer.wd.copy_(init(layer.wd.shape, F ** -0.5 / (2 * Lx) ** 0.5))
        if cfg.qkv_bias:
            for b in (layer.bq, layer.bk, layer.bv):
                b.zero_()
    model.embed.copy_(init(model.embed.shape, 1.0))
    model.final_norm.fill_(1)
    if not cfg.tie_embeddings:
        model.lm_head.copy_(init(model.lm_head.shape))
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward(model: Transformer, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, Vp] float32 (the reference's forward
    at inference: dense, so no aux loss)."""
    S = tokens.shape[1]
    x = model.embed[tokens]
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None, :]
    for layer in model.layers:
        x, _, _ = layer(x, positions)
    return model.logits(x)


# ---------------------------------------------------------------------------
# decode (serve_step)
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    dt = dtype or cfg.dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    device = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


@torch.no_grad()
def decode_step(model: Transformer, cache: dict, tokens: torch.Tensor,
                cur_len: int, attn_impl: str = "xla"):
    """One-token decode.  tokens [B]; cur_len: tokens already in the cache.
    Returns (logits [B, Vp] float32, cache).  The cache is updated in place
    (the reference returns a new one): layer l's k, v of the new token go
    to slot cur_len, clamped to Smax - 1 as `dynamic_update_slice` clamps
    its start, and attention reads kv_len = cur_len + 1 rows (at most
    Smax).  attn_impl: 'flash' (the flash-decode kernel on the card) |
    'xla' (its plain version)."""
    cur_len = int(cur_len)
    B = tokens.shape[0]
    dev = tokens.device
    x = model.embed[tokens][:, None]                          # [B, 1, D]
    pos = torch.full((B, 1), cur_len, dtype=torch.int32, device=dev)
    kv_len = torch.full((B,), cur_len + 1, dtype=torch.int32, device=dev)
    slot = min(max(cur_len, 0), cache["k"].shape[2] - 1)
    for layer, ck, cv in zip(model.layers, cache["k"], cache["v"]):
        q, k, v = layer.qkv(x, pos)
        ck[:, slot] = k[:, 0].to(ck.dtype)
        cv[:, slot] = v[:, 0].to(cv.dtype)
        o = L.decode_attention(q[:, 0], ck, cv, kv_len, impl=attn_impl)
        x = layer.attn_out(x, o[:, None])
    return model.logits(x[:, 0]), cache
