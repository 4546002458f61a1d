"""Training loop substrate: the port of src/repro/train/train_loop.py.

make_train_step         — a (params, opt_state, batch) step with gradient
                          accumulation over microbatches on a leading axis;
make_sharded_train_step — the data-parallel step over a mesh's dp group:
                          parameters replicated, the batch split into
                          contiguous row blocks, the gradient all-reduce
                          explicit (float32, or int8 with error feedback:
                          dist/collectives.py); `init_residual` starts
                          its error feedback;
fit                     — the loop: data iterator, checkpoint manager,
                          metrics.

`params` is a model (`nn.Module`: its `named_parameters()` are trained)
or a dict name -> tensor; `loss_fn(params, batch) -> (loss, metrics)`
receives it as it is.  The step turns `requires_grad` on for the
parameters (models are built without it, for serving), takes the
gradients with `torch.autograd.grad` and updates the parameters in place
(`optimizer.apply_updates`).  Each rank of the data-parallel step is one
process with one device (`launch/mesh.py`): NCCL on the cards, gloo on
the CPU; every rank updates its replica with the same reduced gradients.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.dist import sharding
from repro_torch.dist.collectives import (all_reduce_sum, all_reduce_sum_,
                                          compressed_psum_with_feedback)
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


def _reduce_mean_(grads: dict, group, n: int) -> dict:
    """Each gradient summed over `group` in float32 and divided by n, in
    place: autograd's gradients are fresh tensors.  A gradient that is not
    a contiguous float32 tensor of its own (another dtype, a strided view,
    storage shared with another leaf's gradient) is copied first."""
    owners = {}
    for g in grads.values():
        ptr = g.untyped_storage().data_ptr()
        owners[ptr] = owners.get(ptr, 0) + 1
    out = {}
    for k, g in grads.items():
        if (g.dtype != torch.float32 or not g.is_contiguous()
                or owners[g.untyped_storage().data_ptr()] > 1):
            g = g.float().clone(memory_format=torch.contiguous_format)
        out[k] = all_reduce_sum_(g, group).div_(n)
    return out


def make_sharded_train_step(loss_fn: Callable, opt_cfg: opt.OptimizerConfig,
                            mesh, compression: Optional[str] = None):
    """step(params, opt_state, residual, batch) -> (params, opt_state,
    residual, metrics): the reference's explicit data-parallel step.

    Every rank of `mesh`'s dp group (a `launch.mesh.HostMesh`) calls the
    step with the same parameters and the same global batch; each takes
    its block of contiguous rows (`dist.sharding.split_rows`: the batch
    must divide by the dp size) and its gradients.  They are summed over
    the group in float32, in place, or with `compression="int8"` through
    `compressed_psum_with_feedback` (the residual, from `init_residual`,
    carries the quantization error), then divided by the group's size n;
    the loss is summed and divided by n too, and every rank applies the
    same update in place.  The other metrics are the rank's own.  On the
    one-rank mesh without a process group the sums are the identity: the
    one-device step."""
    if compression not in (None, "int8"):
        raise ValueError(f"compression {compression!r}: None or 'int8'")
    group, rank, n = sharding.dp_axis(mesh), mesh.dp_rank, mesh.dp_size

    def step(params, opt_state, residual, batch):
        local = sharding.split_rows(batch, rank, n)
        loss, metrics, grads = value_and_grad(loss_fn, params, local)
        if compression == "int8":
            grads, residual = compressed_psum_with_feedback(grads, residual,
                                                            group)
            grads = {k: g.div_(n) for k, g in grads.items()}
        else:
            grads = _reduce_mean_(grads, group, n)
        loss = all_reduce_sum(loss, group) / n
        _, opt_state, om = opt.apply_updates(opt_cfg, param_dict(params),
                                             grads, opt_state)
        return params, opt_state, residual, dict(metrics, loss=loss, **om)

    return step


def init_residual(params) -> dict:
    """Zero float32 error-feedback residuals shaped as `param_dict(params)`."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in param_dict(params).items()}


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
