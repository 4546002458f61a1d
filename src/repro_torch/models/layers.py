"""Shared transformer layers: RMSNorm, RoPE, GQA attention (full and chunked
online softmax for long context), SwiGLU MLP, decode-step attention.

The port of src/repro/models/layers.py.  Dtype policy as there: matmuls
run in the model's `dtype` (bf16 on the card), softmax statistics and
attention scores in float32.  The two attention products of
`causal_attention` (scores and probabilities times V) take float32
operands and give float32 results, as JAX's `preferred_element_type`
does; for bf16 operands the card may run them in TF32, which holds a bf16
value exactly, so the results stay those of a float32 product.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Cast back to x's dtype before the scale multiply, as the reference."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """[head_dim // 2] inverse frequencies (float32)."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S] (int).
    Half-split rotation (not interleaved), in float32."""
    D = x.shape[-1]
    inv = rope_freqs(D, theta, device=x.device)                # [D/2]
    ang = positions.float()[..., None] * inv                   # [..., S, D/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., : D // 2].float(), x[..., D // 2:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def exact_f32_products(x: torch.Tensor):
    """Let float32 products on the card run in TF32 while their operands
    hold bf16 (or fp16) values, which TF32 represents exactly; restores the
    setting on exit.  A no-op for float32 inputs and on the CPU."""
    if not x.is_cuda or x.dtype not in (torch.bfloat16, torch.float16):
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _grouped(x: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q rows [B, S, Hkv * G, D] -> float32 [B, Hkv, G * S, D], rows (g, s):
    query head h * G + g reads kv head h (the reference's `_repeat_kv`
    order), and one batched product per kv head serves its whole group
    without repeating k and v."""
    B, S, Hq, D = x.shape
    G = Hq // n_kv
    return (x.reshape(B, S, n_kv, G, D).permute(0, 2, 3, 1, 4)
            .reshape(B, n_kv, G * S, D).float())


def _ungrouped(o: torch.Tensor, S: int) -> torch.Tensor:
    """[B, Hkv, G * S, D] -> [B, S, Hkv * G, D]."""
    B, Hkv, GS, D = o.shape
    G = GS // S
    return o.reshape(B, Hkv, G, S, D).permute(0, 3, 1, 2, 4).reshape(
        B, S, Hkv * G, D)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     chunk_q: int = 0, chunk_kv: int = 1024) -> torch.Tensor:
    """Causal GQA attention.  q: [B, S, Hq, D]; k, v: [B, S, Hkv, D].

    chunk_q == 0 (or S <= chunk_q): the full S x S softmax.  chunk_q > 0:
    online softmax over kv chunks per q chunk; q chunk i visits kv chunks
    up to its causal horizon only, as the reference's chunked path does;
    its score chunks are scaled, masked and exponentiated in place unless
    grad is enabled (autograd keeps the values they replace), with the
    same numbers either way.  Scores are float32; probabilities are cast
    to q's dtype before the product with V, as in the reference."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = 1.0 / (D ** 0.5)
    kt = k.float().permute(0, 2, 3, 1)                 # [B, Hkv, D, S]
    vf = v.float().permute(0, 2, 1, 3)                 # [B, Hkv, S, D]

    with exact_f32_products(q):
        if chunk_q == 0 or S <= chunk_q:
            logits = torch.matmul(_grouped(q, Hkv), kt) * scale
            logits = logits.view(B, Hkv, G, S, S)
            mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
            logits = logits.masked_fill(~mask, NEG_INF)
            probs = torch.softmax(logits, dim=-1).to(q.dtype).float()
            o = torch.matmul(probs.view(B, Hkv, G * S, S), vf)
            return _ungrouped(o, S).to(q.dtype)

        if S % chunk_q or S % chunk_kv:
            raise ValueError(f"chunked attention needs S ({S}) divisible by "
                             f"chunk_q ({chunk_q}) and chunk_kv ({chunk_kv})")
        out_chunks = []
        # the score chunks are updated in place unless autograd needs them
        in_place = not torch.is_grad_enabled()
        # row (g, i) of a grouped q chunk sits at query position i
        row_q = torch.arange(chunk_q, device=q.device).repeat(G)
        for i in range(S // chunk_q):
            qi = _grouped(q[:, i * chunk_q:(i + 1) * chunk_q], Hkv)
            q_pos = i * chunk_q + row_q
            kv_hi = (i + 1) * chunk_q                          # causal horizon
            kv_hi = ((kv_hi + chunk_kv - 1) // chunk_kv) * chunk_kv
            m = torch.full((B, Hkv, G * chunk_q, 1), NEG_INF,
                           dtype=torch.float32, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((B, Hkv, G * chunk_q, D), dtype=torch.float32,
                              device=q.device)
            for idx in range(kv_hi // chunk_kv):
                lo = idx * chunk_kv
                s = torch.matmul(qi, kt[..., lo:lo + chunk_kv])
                s = s.mul_(scale) if in_place else s * scale
                if lo + chunk_kv - 1 > i * chunk_q:     # crosses the diagonal
                    k_pos = lo + torch.arange(chunk_kv, device=q.device)
                    masked = q_pos[:, None] < k_pos[None, :]
                    s = (s.masked_fill_(masked, NEG_INF) if in_place
                         else s.masked_fill(masked, NEG_INF))
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = s.sub_(m_new).exp_() if in_place else torch.exp(s - m_new)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + torch.matmul(
                    p.to(q.dtype).float(), vf[:, :, lo:lo + chunk_kv])
                m = m_new
            oi = (acc / l.clamp_min(1e-30)).to(q.dtype)
            out_chunks.append(_ungrouped(oi, chunk_q))
        return torch.cat(out_chunks, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor,
                     impl: str = "xla") -> torch.Tensor:
    """One-token decode.  q: [B, Hq, D]; caches: [B, Smax, Hkv, D];
    kv_len: [B] valid lengths.  impl: 'flash' (the flash-decode kernel on
    the card) | 'xla' (its plain version, the reference's
    `ref.flash_decode_ref`)."""
    if impl == "flash":
        return ops.flash_decode(q, k_cache, v_cache, kv_len)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    return ops.flash_decode_plain(q, k_cache, v_cache, kv_len)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, dtype) -> torch.Tensor:
    h = torch.matmul(x, w_gate.to(dtype))
    u = torch.matmul(x, w_up.to(dtype))
    return torch.matmul(F.silu(h) * u, w_down.to(dtype))


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, dtype,
               scale: Optional[float] = None, device=None) -> torch.Tensor:
    """Normal(0, scale) weights (default fan_in ** -0.5), drawn in float32
    on `device` and stored in `dtype`."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else fan_in ** -0.5
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=device)
    return w.mul_(s).to(dtype)


@dataclasses.dataclass(frozen=True)
class AttnChunking:
    """Chunking policy: full attention below the threshold, chunked above."""
    threshold: int = 8192
    chunk_q: int = 1024
    chunk_kv: int = 1024

    def for_seq(self, s: int) -> tuple[int, int]:
        if s <= self.threshold:
            return (0, 0)
        return (self.chunk_q, self.chunk_kv)
