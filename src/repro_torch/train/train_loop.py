"""Training loop substrate.

The port of src/repro/train/train_loop.py for one device:

make_train_step — a (params, opt_state, batch) step with gradient
                  accumulation over microbatches on a leading axis;
fit             — the loop: data iterator, checkpoint manager, metrics.

`params` is a model (`nn.Module`: its `named_parameters()` are trained)
or a dict name -> tensor; `loss_fn(params, batch) -> (loss, metrics)`
receives it as it is.  The step turns `requires_grad` on for the
parameters (models are built without it, for serving), takes the
gradients with `torch.autograd.grad` and updates the parameters in place
(`optimizer.apply_updates`).  The data-parallel step of the reference
(`make_sharded_train_step`, with its int8 compressed all-reduce) is not
ported yet (ROADMAP.md, item 10b).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.train import optimizer as opt


def param_dict(params) -> dict:
    """The trained tensors of `params`: a model's named parameters, or the
    dict itself."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return params


def value_and_grad(loss_fn: Callable, params, batch: dict):
    """(loss, metrics, grads): `loss_fn(params, batch)` and the gradient of
    the loss with respect to every tensor of `param_dict(params)` (zeros
    for a tensor the loss does not reach, as `jax.grad`)."""
    leaves = param_dict(params)
    for p in leaves.values():
        if not p.requires_grad:
            p.requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = loss_fn(params, batch)
        got = torch.autograd.grad(loss, list(leaves.values()),
                                  allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), got)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(loss_fn: Callable, opt_cfg: opt.OptimizerConfig,
                    accum_steps: int = 1):
    """step(params, opt_state, batch) -> (params, opt_state, metrics).

    With accum_steps > 1, batch tensors have a leading microbatch axis
    [accum, ...]; the microbatches' gradients are summed in float32 in
    order and divided by accum_steps, their losses and metrics averaged."""

    def step(params, opt_state, batch):
        if accum_steps == 1:
            loss, metrics, grads = value_and_grad(loss_fn, params, batch)
        else:
            gsum, losses, ms = None, [], []
            for i in range(accum_steps):
                mb = {k: v[i] for k, v in batch.items()}
                l, m, g = value_and_grad(loss_fn, params, mb)
                if gsum is None:
                    gsum = {k: torch.zeros(t.shape, dtype=torch.float32,
                                           device=t.device)
                            for k, t in g.items()}
                gsum = {k: gsum[k] + g[k].float() for k in gsum}
                losses.append(l)
                ms.append(m)
                del g
            grads = {k: g / accum_steps for k, g in gsum.items()}
            del gsum
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        _, opt_state, om = opt.apply_updates(opt_cfg, param_dict(params),
                                             grads, opt_state)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return step


@torch.no_grad()
def load_params(params, tree: dict) -> None:
    """Copy the tensors of `tree` (name -> tensor) into `param_dict(params)`
    in place, so that a model keeps its parameter objects."""
    for k, p in param_dict(params).items():
        p.copy_(tree[k])


def _device_of(params) -> torch.device:
    return next(iter(param_dict(params).values())).device


def fit(params, loss_fn, opt_cfg: opt.OptimizerConfig, data_iter,
        n_steps: int, ckpt: Optional[CheckpointManager] = None,
        log_every: int = 10, accum_steps: int = 1, log_fn=print):
    """Train `params` (updated in place) for n_steps batches of `data_iter`
    (dicts of numpy arrays or tensors, moved to the parameters' device).
    Resumes from `ckpt`'s latest checkpoint, logs every `log_every` steps
    and at the last, saves every `log_every * 5` steps and at the end.
    Returns (params, opt_state, history)."""
    opt_state = opt.init_state(opt_cfg, param_dict(params))
    step_fn = make_train_step(loss_fn, opt_cfg, accum_steps=accum_steps)
    dev = _device_of(params)
    start = 0
    if ckpt is not None:
        got = ckpt.restore_latest({"params": param_dict(params),
                                   "opt": opt_state})
        if got[1] is not None:
            start, state = got
            load_params(params, state["params"])
            opt_state = state["opt"]
            log_fn(f"[fit] resumed from step {start}")
    history = []
    t0 = time.perf_counter()
    for step in range(start, n_steps):
        batch = next(data_iter)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % log_every == 0 or step == n_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            dt = (time.perf_counter() - t0) / (step - start + 1)
            history.append({"step": step + 1, **m})
            log_fn(f"[fit] step {step+1}/{n_steps} loss={m['loss']:.4f} "
                   f"({dt*1e3:.0f} ms/step)")
        if ckpt is not None and (step + 1) % (log_every * 5) == 0:
            ckpt.save(step + 1, {"params": param_dict(params),
                                 "opt": opt_state})
    if ckpt is not None:
        ckpt.save(n_steps, {"params": param_dict(params), "opt": opt_state})
    return params, opt_state, history
