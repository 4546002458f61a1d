"""Optimizers from scratch, over dicts of tensors.

The port of the reference's train/optimizer.py.  AdamW (the default),
SGDM and Adafactor (factored second moments).  `params` and `grads` are
dicts name -> tensor (`dict(model.named_parameters())` for a model); the
state holds `step`, a 0-d int32 tensor on the CPU, and float32 tensors
shaped as the parameters (Adafactor: the row and column factors of every
parameter of rank >= 2).

The arithmetic is the reference's, operation by operation, in float32:
the gradients are clipped first, the step is advanced before the
schedule is read, AdamW's update is `(m / c1) / (sqrt(v / c2) + eps) + wd
* p`, and each parameter is updated in float32 and cast back to its
dtype.  `torch.optim` is not used: its decoupled decay and fused
multiply-adds round in another order.  Unlike the reference's pure
functions, `apply_updates` writes the new values into the parameter and
state tensors (each computed out of place, then copied in), so that a
model's parameters are updated where they are and a full-size step holds
one tensor's temporaries at a time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"          # adamw | sgdm | adafactor
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * lr (float32 0-d
    tensor on the step's device)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32; tensors in
    sorted name order, as the reference's tree leaves."""
    total = 0
    for name in sorted(tree):
        total = total + torch.sum(torch.square(tree[name].float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(tree: dict, max_norm: float):
    """(float32 tensors scaled to a global norm of at most max_norm, the
    norm before scaling)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g.float() * scale for k, g in tree.items()}, norm


# ---------------------------------------------------------------------------


def init_state(cfg: OptimizerConfig, params: dict) -> dict[str, Any]:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step = torch.zeros((), dtype=torch.int32)
    if cfg.name == "adamw":
        return {"step": step, "mu": {k: zeros(p) for k, p in params.items()},
                "nu": {k: zeros(p) for k, p in params.items()}}
    if cfg.name == "sgdm":
        return {"step": step, "mu": {k: zeros(p) for k, p in params.items()}}
    if cfg.name == "adafactor":
        def factored(p):
            if p.dim() >= 2:
                f32 = dict(dtype=torch.float32, device=p.device)
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": zeros(p)}
        return {"step": step, "v": {k: factored(p) for k, p in params.items()}}
    raise ValueError(cfg.name)


def _store(dst: torch.Tensor, value: torch.Tensor) -> None:
    dst.copy_(value.to(dst.dtype))


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params: dict, grads: dict,
                  state: dict):
    """One step: writes the new parameters into `params` and the new state
    into `state` (see the module docstring) and returns (params, state,
    metrics {"lr", "grad_norm"})."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    state["step"] = step
    stepf = step.float()

    if cfg.name == "adamw":
        b1, b2 = cfg.b1, cfg.b2
        c1 = 1 - b1 ** stepf
        c2 = 1 - b2 ** stepf
        for k, p in params.items():
            g, m, v = grads.pop(k), state["mu"][k], state["nu"][k]
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            del g
            pf = p.float()
            u = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            u = u + cfg.weight_decay * pf
            _store(p, pf - lr * u)
        return params, state, {"lr": lr, "grad_norm": gnorm}

    if cfg.name == "sgdm":
        for k, p in params.items():
            m = state["mu"][k]
            m.copy_(cfg.b1 * m + grads.pop(k))
            pf = p.float()
            _store(p, pf - lr * (m + cfg.weight_decay * pf))
        return params, state, {"lr": lr, "grad_norm": gnorm}

    if cfg.name == "adafactor":
        d = 1 - cfg.b2 ** stepf
        for k, p in params.items():
            g, v = grads.pop(k), state["v"][k]
            g2 = g * g + 1e-30
            if p.dim() >= 2:
                vr = cfg.b2 * v["vr"] + (1 - cfg.b2) * g2.mean(dim=-1)
                vc = cfg.b2 * v["vc"] + (1 - cfg.b2) * g2.mean(dim=-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                                       min=1e-30))
                u = g / (torch.sqrt(denom / d) + cfg.eps)
                v["vr"].copy_(vr)
                v["vc"].copy_(vc)
            else:
                v["v"].copy_(cfg.b2 * v["v"] + (1 - cfg.b2) * g2)
                u = g / (torch.sqrt(v["v"] / d) + cfg.eps)
            pf = p.float()
            _store(p, pf - lr * (u + cfg.weight_decay * pf))
        return params, state, {"lr": lr, "grad_norm": gnorm}

    raise ValueError(cfg.name)
