"""Decoder-only LM (dense GQA or MoE) — granite / qwen / llama / moonshot:
serving and training.

The port of src/repro/models/transformer.py without the sharding pins.
One `DecoderLayer` module per layer instead of weight-stacked scans;
parameter names and layouts follow the reference's dict (`wq` [D, Hq *
hd], `wo` [Hq * hd, D], `embed` [Vp, D], `lm_head` [D, Vp], ...), so
carrying weights across is a per-layer slice
(`repro_torch.carry.lm_params_from_reference`).  An MoE layer holds
`router` [D, E] and `wg`, `wu` [E, D, Fe], `wd` [E, Fe, D] in place of the
dense MLP.

Weights are stored in `cfg.param_dtype` (float32, as the reference's
default) and cast to `cfg.dtype` at use, as the reference does; the MoE
router is stored in float32 always.  Serving builds its models with
`param_dtype = cfg.dtype` (`serving_config`): that gives the same numbers
(the cast at use is then a no-op), and llama3-8b's weights take 16 GB in
bf16 instead of 32.  Matmuls run in `dtype`; the logits are float32
products, as the reference's `preferred_element_type=float32`.

`forward(..., train=True)` and `loss_fn` are the training path: MoE
layers run the capacity dispatch (`dropless=False`) and their aux losses
are summed, and with `cfg.remat` each layer is recomputed in the backward
(`torch.utils.checkpoint`, the reference's per-layer `jax.checkpoint`).
The serving functions (`forward` without `train`, `decode_step`) run
under `torch.no_grad()` and the MoE layers dropless.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.executor import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.moe import MoEConfig, moe_ffn


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
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = False
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    remat: bool = True
    attn_chunk: L.AttnChunking = L.AttnChunking()

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
        if self.moe:
            ff = (D * self.moe.n_experts
                  + 3 * self.moe.n_experts * D * self.moe.d_expert)
        else:
            ff = 3 * D * self.d_ff
        per_layer = attn + ff + 2 * D
        emb = self.vocab * D * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + D

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        D = self.d_model
        ff_all = 3 * self.moe.n_experts * D * self.moe.d_expert
        ff_act = 3 * self.moe.top_k * D * self.moe.d_expert
        return self.param_count() - self.n_layers * (ff_all - ff_act)


def serving_config(cfg: TransformerConfig) -> TransformerConfig:
    """`cfg` with its weights stored in the compute dtype, for serving."""
    return dataclasses.replace(cfg, param_dtype=cfg.dtype)


def _weight(shape, cfg: TransformerConfig, device,
            dtype=None) -> nn.Parameter:
    """An uninitialised parameter in `cfg.param_dtype` (or `dtype`), made
    without `requires_grad`: the training step turns it on."""
    return nn.Parameter(torch.empty(shape, dtype=dtype or cfg.param_dtype,
                                    device=device), requires_grad=False)


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: GQA attention with RoPE, then a SwiGLU
    MLP or, where `cfg.moe` is set, an MoE of SwiGLU experts (dropless
    when serving, the capacity dispatch when training)."""

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
        if cfg.moe:
            E, Fe = cfg.moe.n_experts, cfg.moe.d_expert
            self.router = _weight((D, E), cfg, device, torch.float32)
            self.wg = _weight((E, D, Fe), cfg, device)
            self.wu = _weight((E, D, Fe), cfg, device)
            self.wd = _weight((E, Fe, D), cfg, device)
        else:
            self.wg = _weight((D, F), cfg, device)
            self.wu = _weight((D, F), cfg, device)
            self.wd = _weight((F, D), cfg, device)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """x [B, S, D] -> q [B, S, Hq, hd], k, v [B, S, Hkv, hd], RoPE on
        q and k at `positions` (broadcastable to [B, S])."""
        cfg = self.cfg
        dt = cfg.dtype
        B, S, _ = x.shape
        h = L.rms_norm(x, self.ln1)
        q, k, v = h @ self.wq.to(dt), h @ self.wk.to(dt), h @ self.wv.to(dt)
        if cfg.qkv_bias:
            q, k, v = q + self.bq.to(dt), k + self.bk.to(dt), v + self.bv.to(dt)
        q = L.apply_rope(q.reshape(B, S, cfg.n_heads, cfg.hd), positions,
                         cfg.rope_theta)
        k = L.apply_rope(k.reshape(B, S, cfg.n_kv_heads, cfg.hd), positions,
                         cfg.rope_theta)
        return q, k, v.reshape(B, S, cfg.n_kv_heads, cfg.hd)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """The attention output o [..., Hq, hd] through wo: [..., D]."""
        return o.reshape(*o.shape[:-2], -1) @ self.wo.to(self.cfg.dtype)

    def mlp(self, h: torch.Tensor, dropless: bool = True, aux_reduce=None):
        """(the MLP or MoE output of h, the residual normed by ln2, the
        layer's aux loss: float32, 0 for a dense layer); `aux_reduce` is
        `moe_ffn`'s."""
        cfg = self.cfg
        if cfg.moe:
            return moe_ffn(h, self.router, self.wg, self.wu, self.wd,
                           cfg.moe, cfg.dtype, dropless=dropless,
                           aux_reduce=aux_reduce)
        y = L.swiglu(h, self.wg, self.wu, self.wd, cfg.dtype)
        return y, torch.zeros((), dtype=torch.float32, device=h.device)

    def mlp_out(self, x: torch.Tensor, o: torch.Tensor,
                dropless: bool = True, aux_reduce=None):
        """(residual after attention and the MLP or MoE, the layer's aux
        loss: float32, 0 for a dense layer): o is [..., Hq, hd]."""
        x = x + self.out(o)
        y, aux = self.mlp(L.rms_norm(x, self.ln2), dropless, aux_reduce)
        return x + y, aux

    def attn_out(self, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        """Residual after attention and the MLP (or the MoE, dropless)."""
        return self.mlp_out(x, o)[0]

    def attention(self, x: torch.Tensor, positions: torch.Tensor):
        """(q, k, v, o) of the whole sequence x [B, S, D] at once, through
        the reference's `causal_attention` (full or chunked by
        `cfg.attn_chunk`)."""
        q, k, v = self.qkv(x, positions)
        cq, ckv = self.cfg.attn_chunk.for_seq(x.shape[1])
        return q, k, v, L.causal_attention(q, k, v, chunk_q=cq, chunk_kv=ckv)

    def forward(self, x: torch.Tensor, positions: torch.Tensor):
        """x [B, S, D] -> (x', k, v): the whole prompt at once (serving)."""
        _, k, v, o = self.attention(x, positions)
        return self.attn_out(x, o), k, v

    def block(self, x: torch.Tensor, positions: torch.Tensor,
              dropless: bool = True, aux_reduce=None):
        """x [B, S, D] -> (x', aux): the layer as `forward` of the whole
        model runs it (training: `dropless=False`, the MoE's capacity
        dispatch)."""
        o = self.attention(x, positions)[3]
        return self.mlp_out(x, o, dropless, aux_reduce)


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
            return x.float() @ head.to(self.cfg.dtype).float()

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of `embed` at tokens, in the compute dtype.  `F.embedding`
        rather than indexing: its backward adds a repeated token's rows in
        a fixed order (indexing's accumulates in parallel on the CPU, in
        an order that varies from run to run)."""
        return F.embedding(tokens, self.embed).to(self.cfg.dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """A model with the reference's initial scales (`init_params`), drawn
    tensor by tensor from `generator` (a generator on `device`) on `device`
    and stored in `cfg.param_dtype`.  Norm scales 1, biases 0; an MoE
    layer's router in float32."""
    model = Transformer(cfg, device)
    dev = model.device
    D, Hq, hd, Lx = cfg.d_model, cfg.n_heads, cfg.hd, cfg.n_layers
    F = cfg.moe.d_expert if cfg.moe else cfg.d_ff

    def init(shape, scale=None, dtype=None):
        return L.dense_init(generator, shape, dtype or cfg.param_dtype,
                            scale=scale, device=dev)

    for layer in model.layers:
        layer.ln1.fill_(1)
        layer.ln2.fill_(1)
        for name in ("wq", "wk", "wv", "wg", "wu"):
            w = getattr(layer, name)
            w.copy_(init(w.shape))
        layer.wo.copy_(init(layer.wo.shape,
                            (Hq * hd) ** -0.5 / (2 * Lx) ** 0.5))
        layer.wd.copy_(init(layer.wd.shape, F ** -0.5 / (2 * Lx) ** 0.5))
        if cfg.moe:
            layer.router.copy_(init(layer.router.shape, dtype=torch.float32))
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

def forward(model: Transformer, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, train: bool = False):
    """tokens [B, S] -> logits [B, S, Vp] float32: the reference's forward
    at inference, under `torch.no_grad()` (MoE layers dropless; the aux
    loss is not returned).  `train=True`: (logits, aux) with autograd on,
    the MoE layers on the capacity dispatch and their aux losses summed
    (float32 scalar), each layer recomputed in the backward when
    `cfg.remat`."""
    if not train:
        with torch.no_grad():
            return _forward(model, tokens, positions, train=False)[0]
    return _forward(model, tokens, positions, train=True)


def _forward(model: Transformer, tokens: torch.Tensor,
             positions: Optional[torch.Tensor], train: bool):
    S = tokens.shape[1]
    x = model.embed_tokens(tokens)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for layer in model.layers:
        if train and model.cfg.remat:
            x, a = checkpoint(layer.block, x, positions, False,
                              use_reentrant=False)
        else:
            x, a = layer.block(x, positions, dropless=not train)
        aux = aux + a
    return model.logits(x), aux


def loss_fn(model: Transformer, batch: dict):
    """batch: tokens [B, S], labels [B, S] (< 0 = ignore) -> (loss + aux,
    {"nll", "aux"}): the reference's `loss_fn`, the softmax in float32,
    the vocabulary's padding rows masked to -1e30."""
    cfg = model.cfg
    logits, aux = forward(model, batch["tokens"].long(), train=True)
    logits = logits.float()
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, L.NEG_INF)
    labels = batch["labels"].long()
    valid = labels >= 0
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    nll = (logz - gold) * valid.float()
    loss = nll.sum() / valid.sum().clamp(min=1)
    return loss + aux, {"nll": loss, "aux": aux}


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
    x = model.embed_tokens(tokens)[:, None]                   # [B, 1, D]
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
