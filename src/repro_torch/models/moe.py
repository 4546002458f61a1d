"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

The port of src/repro/models/moe.py.  Dispatch is the argsort permutation
form (tokens sorted by expert, padded to a per-expert capacity, overflow
dropped into a trash row), applied per group: the token batch is reshaped
to [G, T/G] on its leading dim, so routing sorts are group-local.  There
is no mesh, so `MoEConfig` has no sharding fields (the reference's
`group_pspec` / `expert_pspec`); `n_groups` keeps its meaning.

Numerics follow the reference: the router is a float32 product of the
compute-dtype tokens and the router weights cast to that dtype
(`preferred_element_type=float32`); top-k breaks ties to the lower expert
index, as `jax.lax.top_k`; the expert products run in the compute dtype;
the combine adds each token's contributions in the order the reference's
scatter-add visits them (expert-sorted), rounding in the compute dtype
after each add, so a run repeats bit for bit (no float atomics).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import exact_f32_products


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden size
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    normalize_gates: bool = True
    n_groups: int = 1             # routing groups (dp shards in the reference)


def router_aux_loss(probs: torch.Tensor, expert_idx: torch.Tensor,
                    n_experts: int, reduce=None) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum_e f_e * P_e (float32).
    `reduce(counts, prob_sums) -> (counts, prob_sums, ranks)` sums the
    per-expert assignment counts and probability sums over the ranks
    that route the other groups (the dry-run's per-rank program), so the
    loss is the whole batch's."""
    counts = torch.zeros((n_experts,), dtype=torch.float32,
                         device=probs.device)
    counts.index_add_(0, expert_idx.reshape(-1),
                      torch.ones((expert_idx.numel(),), dtype=torch.float32,
                                 device=probs.device))
    if reduce is not None:
        flat = probs.reshape(-1, n_experts).float()
        counts, psum, n = reduce(counts, flat.sum(dim=0))
        frac = counts / max(expert_idx.numel() * n, 1)
        return n_experts * torch.sum(frac * psum / (flat.shape[0] * n))
    frac = counts / max(expert_idx.numel(), 1)
    mean_prob = probs.reshape(-1, n_experts).float().mean(dim=0)
    return n_experts * torch.sum(frac * mean_prob)


def route(xg: torch.Tensor, router_w: torch.Tensor, cfg: MoEConfig):
    """xg [G, Tg, D] in the compute dtype -> (probs [G, Tg, E] float32,
    gate_vals [G, Tg, K] float32, gate_idx [G, Tg, K] int64): the softmax
    of the float32 router logits, its top K (descending, ties to the lower
    index: a stable descending sort) and the gates, normalised to sum 1
    (floor 1e-9) when `cfg.normalize_gates`."""
    w = router_w.to(xg.dtype)
    with exact_f32_products(xg):
        logits = torch.matmul(xg.float(), w.float())
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :cfg.top_k], idx[..., :cfg.top_k]
    if cfg.normalize_gates:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, gate_idx


def dispatch(gate_idx: torch.Tensor, C: int, E: int):
    """gate_idx [G, Tg, K] -> (slot, keep, token, order), each [G, Tg * K]:
    the reference's `_dispatch_group` on every group.  `order` sorts the
    flat assignments by expert (stable), `rank` counts an assignment within
    its expert's run, `keep = rank < C`, `slot` is expert * C + rank or the
    trash row E * C, `token` the assignment's token; all in sorted order."""
    G, Tg, K = gate_idx.shape
    flat_e = gate_idx.reshape(G, Tg * K)
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    experts = torch.arange(E, device=gate_idx.device, dtype=sorted_e.dtype)
    run_starts = torch.searchsorted(
        sorted_e, experts.expand(G, E).contiguous(), side="left")
    pos = torch.arange(Tg * K, device=gate_idx.device)
    rank = pos - torch.gather(run_starts, 1, sorted_e)
    keep = rank < C
    slot = torch.where(keep, sorted_e * C + rank,
                       torch.full_like(rank, E * C))
    return slot, keep, order // K, order


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, cfg: MoEConfig, dtype,
            dropless: bool = False, experts=None, exchange=None,
            aux_reduce=None):
    """x: [..., D] tokens (groups split the LEADING dim); router_w [D, E];
    w_gate, w_up [E, D, Fe]; w_down [E, Fe, D].

    `dropless=True` sizes the expert buffers to the worst case (C = Tg: an
    expert receives at most Tg assignments, top_k experts being distinct
    per token), so no assignment is dropped; inference runs dropless so
    incremental decode equals the forward.  Otherwise C = int(Tg * K / E *
    capacity_factor) + 1 and assignments past an expert's capacity go to
    the trash row (training's dispatch).

    `experts` = (lo, hi): one rank's share of a layer whose experts are
    split over ranks (the dry-run's per-rank program).  w_down holds
    experts [lo, hi); so do w_gate and w_up, unless `exchange` is given:
    then they hold this rank's d_expert columns of every expert [E, D,
    Fe'], and the SwiGLU activations of every expert on those columns [E,
    G * C, Fe'] go through `exchange`, which returns those of experts
    [lo, hi) on every column [hi - lo, G * C, Fe] (an all-to-all over the
    ranks).  Every token is routed as usual; only the assignments to
    those experts are computed or combined, and y is their share of the
    output (the ranks' shares sum to it).
    `aux_reduce` is `router_aux_loss`'s `reduce`.

    Returns (y with x's shape in `dtype`, aux_loss float32 scalar)."""
    lead = x.shape[:-1]
    D = x.shape[-1]
    T = 1
    for d in lead:
        T *= d
    E, K = cfg.n_experts, cfg.top_k
    G = cfg.n_groups
    if G > 1 and (lead[0] % G != 0):
        G = 1                        # groups must split the leading dim
    Tg = T // G
    C = Tg if dropless else int((Tg * K / E) * cfg.capacity_factor) + 1

    xg = x.reshape(G, Tg, D)
    probs, gate_vals, gate_idx = route(xg, router_w, cfg)
    aux = router_aux_loss(probs, gate_idx, E, aux_reduce) * cfg.aux_loss_weight
    slot, keep, token, order = dispatch(gate_idx, C, E)

    def own(keep, slot):
        """experts [lo, hi) only: other assignments go to the trash row"""
        lo, hi = experts
        keep = keep & (slot >= lo * C) & (slot < hi * C)
        n = hi - lo
        return keep, torch.where(keep, slot - lo * C,
                                 torch.full_like(slot, n * C)), n

    if experts is not None and exchange is None:
        keep, slot, E = own(keep, slot)

    # scatter the tokens into [G, E * C + 1, D]; the trash row is dropped
    buf = torch.zeros((G, E * C + 1, D), dtype=dtype, device=x.device)
    g_idx = torch.arange(G, device=x.device)[:, None]
    buf[g_idx, slot] = torch.gather(
        xg, 1, token[..., None].expand(G, Tg * K, D)).to(dtype)
    # expert-major [E, G * C, D] for one batched product per weight
    xe = buf[:, :E * C].reshape(G, E, C, D).transpose(0, 1).reshape(
        E, G * C, D)
    del buf

    # ---- expert computation (SwiGLU) ---------------------------------------
    h = torch.bmm(xe, w_gate.to(dtype))
    u = torch.bmm(xe, w_up.to(dtype))
    del xe
    act = F.silu(h) * u
    del h, u
    if exchange is not None:                 # experts [lo, hi), every column
        act = exchange(act)
        keep, slot, E = own(keep, slot)
    ye = torch.bmm(act, w_down.to(dtype))                     # [E, G * C, D]
    del act
    flat = ye.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)

    # ---- combine -----------------------------------------------------------
    # a dropped assignment reads the clamped last row, times 0, as the
    # reference does (it is not masked)
    rows = slot.clamp_max(E * C - 1)
    gathered = torch.gather(flat, 1, rows[..., None].expand(G, Tg * K, D))
    gathered = gathered * keep[..., None].to(dtype)
    gs = torch.gather(gate_vals.reshape(G, Tg * K), 1, order).to(dtype)
    contrib = gathered * gs[..., None]                        # sorted order
    # the reference adds contributions into a zero row per token in sorted
    # (expert-major) order: token t's K positions in that order, ascending
    where = torch.empty_like(order)
    where.scatter_(1, order, torch.arange(Tg * K, device=x.device)
                   .expand(G, Tg * K).contiguous())
    visit = torch.sort(where.reshape(G, Tg, K), dim=-1).values
    y = torch.gather(contrib, 1, visit[..., 0, None].expand(G, Tg, D))
    for k in range(1, K):
        y = y + torch.gather(contrib, 1, visit[..., k, None].expand(G, Tg, D))
    return y.reshape(x.shape), aux


def routing_differences(probs_a: torch.Tensor, idx_a: torch.Tensor,
                        probs_b: torch.Tensor, idx_b: torch.Tensor):
    """How two runs of one router differ: probs [..., E] and gate_idx
    [..., K] of each.  Returns (differs, gap, near_tie), each [...]:
    `differs` where the two expert sets differ (the output depends on the
    set, not on its order: the combine adds in expert order), `gap` run
    a's probability gap between its K-th and (K+1)-th expert, and
    `near_tie` where that gap is at most the two runs' measured difference
    in those two experts' probabilities, |dp_K| + |dp_K+1|: a set that
    differs there can come from rounding upstream; one that differs
    elsewhere cannot."""
    K = idx_a.shape[-1]
    pa, pb = probs_a.float(), probs_b.to(probs_a.device).float()
    differs = (torch.sort(idx_a, dim=-1).values
               != torch.sort(idx_b.to(idx_a.device), dim=-1).values).any(-1)
    vals, order = torch.sort(pa, dim=-1, descending=True, stable=True)
    gap = vals[..., K - 1] - vals[..., K]
    dp = (pb - pa).abs()
    tol = (torch.gather(dp, -1, order[..., K - 1:K])[..., 0]
           + torch.gather(dp, -1, order[..., K:K + 1])[..., 0])
    return differs, gap, gap <= tol
