"""Explicit collectives of the port.

`make_ring_all_reduce(group)` — the reference's naive ring all-reduce
(src/repro/dist/collectives.py, `lax.ppermute` inside shard_map) over a
`torch.distributed` process group: n - 1 hops, in each of which every rank
sends the block it last received to its right neighbour and receives its
left neighbour's, adding it to its sum.  Spelled out hop by hop so its
traffic can be accounted and compared with the fused `all_reduce`.

`quantize_int8` / `dequantize_int8` + `compressed_psum_with_feedback` —
int8 gradient all-reduce with error feedback (the residual carries this
step's quantization error into the next step, so compression noise is
unbiased over time and data-parallel training still converges).  The sum
is `dist.all_reduce(SUM)` of every rank's dequantized float32 values, as
the reference's `psum` of them.

`psum` and `all_gather` — the two collectives of the halo-exchange GIN
(`models/gnn.py`), each a `torch.autograd.Function` with the adjoint the
math asks for: `all_gather`'s backward sends each block's gradient back to
its owner, summed over the ranks that read it (a reduce-scatter, spelled as
an all-reduce and the owner's block, which gloo supports too); `psum`'s
backward is the identity, because every rank differentiates its own share
of the summed value (each rank's loss is the total, and its parameter
gradient is its share: the ranks' gradients sum to the total's).

`gather_dim`, `scatter_sum_dim` and `sum_over` — the collectives of the
dry-run's per-rank programs (launch/steps.py), under autograd with the
adjoints of a sum of per-rank objectives: `gather_dim` concatenates every
rank's block along a dimension (its backward a reduce-scatter),
`scatter_sum_dim` sums every rank's tensor and keeps this rank's block
along a dimension (its backward the all-gather), `sum_over` is the
all-reduce whose backward is the all-reduce of the gradients,
`all_to_all_dim` sends block i along one dimension to rank i and
concatenates what it receives along another (its backward the all-to-all
the other way).  Gloo has no reduce-scatter, so there it is an all-reduce
and this rank's block.

`group` is a `torch.distributed` process group (the default group when
None, as `torch.distributed`'s own collectives take it).  Without an
initialised process group every sum and gather is over one rank, the
identity; once a group is initialised the collective always runs, even
on one rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def make_ring_all_reduce(group=None):
    """Returns fn(x) -> the sum of every rank's x, on every rank (x's shape
    and dtype; each rank adds its neighbours' blocks in ring order, so
    float sums may differ from `dist.all_reduce` in the last bits).  Every
    rank of `group` (the default group when None) must call fn with a
    tensor of the same shape and dtype.  Without an initialised process
    group, or on a one-rank group, fn returns its input."""
    if not dist.is_initialized():
        return lambda x: x
    n = dist.get_world_size(group)
    if n == 1:
        return lambda x: x
    me = dist.get_rank(group)

    def peer(r):          # a rank of `group` -> its global rank
        r %= n
        return r if group is None else dist.get_global_rank(group, r)
    right, left = peer(me + 1), peer(me - 1)

    def ring(x: torch.Tensor) -> torch.Tensor:
        acc, cur = x.clone(), x.contiguous()
        for _ in range(n - 1):
            nxt = torch.empty_like(cur)
            ops = [dist.P2POp(dist.isend, cur, right, group),
                   dist.P2POp(dist.irecv, nxt, left, group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            acc += nxt
            cur = nxt
        return acc

    return ring


def all_reduce_sum_(x: torch.Tensor, group=None) -> torch.Tensor:
    """x, replaced in place by the sum of every rank's x (x must be
    contiguous).  Returns x."""
    if dist.is_initialized():
        flat = x.view(-1)              # a 0-d tensor travels as one element
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's x (a new tensor of x's shape and dtype; no
    gradient).  x itself is left as it is."""
    return all_reduce_sum_(
        x.detach().clone(memory_format=torch.contiguous_format), group)


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: q = round(x / scale), scale = max|x|/127
    (round half to even, as `jnp.round`; an all-zero x has scale 0 and
    divides by 1).  Returns (q int8, scale float32 0-d).  Error is bounded
    by scale/2."""
    xf = x.float()
    scale = xf.abs().max() / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_with_feedback(grads: dict, residual: dict, group=None):
    """int8-compressed sum over `group` with error feedback.

    Per leaf: x = g + residual is quantized to int8; the reconstruction is
    all-reduced; the quantization error (x - dequant) becomes the new
    residual.  `grads` and `residual` are dicts name -> tensor.  Returns
    (summed float32 dict, new residual dict).  Callers divide by the
    group's size for the mean (`train_loop.make_sharded_train_step`
    does)."""
    summed, new_res = {}, {}
    for k, g in grads.items():
        x = g.float() + residual[k]
        q, scale = quantize_int8(x)
        deq = dequantize_int8(q, scale)
        new_res[k] = x - deq
        summed[k] = all_reduce_sum_(deq.contiguous(), group)
    return summed, new_res


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        if not dist.is_initialized():
            return x[None].clone()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        if not dist.is_initialized():
            return grad[0], None
        total = all_reduce_sum(grad, ctx.group)
        return total[dist.get_rank(ctx.group)], None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """`jax.lax.psum(x, axis)`: the sum of every rank's x, on every rank,
    under autograd (the backward is the identity: see the module
    docstring)."""
    return _PSum.apply(x, group)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """`jax.lax.all_gather(x, axis)`: [n_ranks, *x.shape], rank r's x at r,
    on every rank, under autograd (the backward sums each block's gradient
    over the ranks and gives it to the block's owner)."""
    return _AllGather.apply(x, group)


# ---------------------------------------------------------------------------
# the per-rank programs' collectives (the dry-run's cells)
# ---------------------------------------------------------------------------

# the single-tensor collectives (renamed in newer PyTorch releases)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _ALL_GATHER(out, x, group=group)
    return out.movedim(0, dim)


def _scatter_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    x = x.movedim(dim, 0).contiguous()
    k = x.shape[0] // n
    if dist.get_backend(group) == "gloo":       # no reduce-scatter in gloo
        x = x.clone()
        dist.all_reduce(x, group=group)
        out = x.narrow(0, dist.get_rank(group) * k, k)
    else:
        out = torch.empty((k,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        _REDUCE_SCATTER(out, x, group=group)
    return out.movedim(0, dim)


def _all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int,
                group) -> torch.Tensor:
    n = _size(group)
    if n == 1:
        return x
    xs = x.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    # [source rank, this rank's block along split_dim, the rest]
    out = out.reshape(n, xs.shape[0] // n, *xs.shape[1:])
    out = out.movedim(1, split_dim + 1).movedim(0, cat_dim)
    shape = list(out.shape)
    shape[cat_dim:cat_dim + 2] = [shape[cat_dim] * shape[cat_dim + 1]]
    return out.reshape(shape)


class _AllToAllDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group):
        ctx.dims, ctx.group = (split_dim, cat_dim), group
        return _all_to_all(x, split_dim, cat_dim, group)

    @staticmethod
    def backward(ctx, grad):
        split_dim, cat_dim = ctx.dims
        return (_all_to_all(grad, cat_dim, split_dim, ctx.group), None, None,
                None)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_sum(grad, ctx.dim, ctx.group), None, None


class _ScatterSumDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_sum(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.group), None, None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous(), ctx.group), None


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's block of `group` concatenated along `dim` in rank order
    (an all-gather), under autograd (the backward: a reduce-scatter)."""
    if _size(group) == 1:
        return x
    return _GatherDim.apply(x, dim, group)


def scatter_sum_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of every rank's x, of which this rank keeps its block along
    `dim` (a reduce-scatter), under autograd (the backward: the
    all-gather)."""
    if _size(group) == 1:
        return x
    return _ScatterSumDim.apply(x, dim, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's x, on every rank, under autograd as part of
    a sum of per-rank objectives (the backward all-reduces the gradients;
    `psum` above is the other convention)."""
    if _size(group) == 1:
        return x
    return _SumOver.apply(x, group)


def all_to_all_dim(x: torch.Tensor, split_dim: int, cat_dim: int,
                   group) -> torch.Tensor:
    """x split into one block per rank of `group` along `split_dim`, block
    i sent to rank i; the blocks this rank receives concatenated along
    `cat_dim` in rank order (an all-to-all), under autograd (the backward:
    the all-to-all from `cat_dim` back to `split_dim`)."""
    if _size(group) == 1:
        return x
    return _AllToAllDim.apply(x, split_dim, cat_dim, group)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over `group`, without a gradient."""
    x = x.detach().clone()
    if _size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x
