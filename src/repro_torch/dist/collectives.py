"""Explicit collectives of the port.

`make_ring_all_reduce(group)` — the reference's naive ring all-reduce
(src/repro/dist/collectives.py, `lax.ppermute` inside shard_map) over a
`torch.distributed` process group: n - 1 hops, in each of which every rank
sends the block it last received to its right neighbour and receives its
left neighbour's, adding it to its sum.  Spelled out hop by hop so its
traffic can be accounted and compared with the fused `all_reduce`.

The int8 `compressed_psum_with_feedback` of the reference belongs to
training and is not ported yet (ROADMAP.md queue 1, item 10).
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
