"""Straggler-mitigating dispatch over replicated document shards.

`ShardDispatcher` — every index shard may have a replica; a shard call that
fails or exceeds `timeout` is re-dispatched to its replica, and per-shard
top-k results are merged (`merge_topk`).  This is the paper-system analogue
of search-cluster fan-out with stragglers; `serve.front.FrontDoor` fans its
micro-batches out through it.  Each shard callable runs in a pool thread,
so on the card several shard engines launch their kernels at once (on the
device's default stream, which orders them).
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutTimeout
from typing import Callable, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class DispatchStats:
    total: int = 0           # dispatch() calls
    redispatched: int = 0    # shard calls that fell over to a replica
    failed: int = 0          # shard calls with no healthy replica either


class ShardDispatcher:
    """Fan a query batch out to every shard; failed/straggling shards are
    re-dispatched to their replicas.  shard_fns[i] and replica_fns[i] must
    answer for the same document range."""

    def __init__(self, shard_fns: Sequence[Callable],
                 replica_fns: Optional[Sequence[Callable]] = None,
                 timeout: float = 30.0):
        self.shard_fns = list(shard_fns)
        self.replica_fns = list(replica_fns) if replica_fns is not None else None
        self.timeout = timeout
        self.stats = DispatchStats()
        # 2x: a hung primary keeps occupying its worker thread past the
        # timeout, and its replica must still find a free one
        self._pool = ThreadPoolExecutor(max_workers=max(2 * len(self.shard_fns), 1))

    def dispatch(self, batch, shards: Optional[Sequence[int]] = None,
                 on_late: Optional[Callable] = None) -> list:
        """Returns one result per shard (replica result where the primary
        failed; None when both did).  The list is always len(shard_fns);
        `shards` restricts the fan-out to a subset of shard indices (the
        front door's bounded retry re-dispatches only the shards still
        missing), leaving every other slot None.

        All primaries are submitted up front and waited against a single
        shared deadline per phase (primaries, then replicas), so a dispatch
        costs at most 2*timeout wall clock no matter how many shards hang —
        max(latency), not sum(latency).  Caveat: Python threads can't be
        killed, so a shard fn that NEVER returns leaks its worker thread;
        the 2N-sized pool absorbs one such generation, persistent zombies
        need process-level supervision.

        `on_late(shard_i, result)` — when given, a shard call that merely
        EXCEEDED the deadline (as opposed to raising) gets a done-callback
        that delivers its eventual result after the dispatch returned: the
        straggler's work is not thrown away, the caller can backfill
        (serve.front re-merges it into the response cache).  Called from the
        straggler's worker thread; exceptions in the callback are swallowed
        (late delivery is best-effort by construction)."""
        self.stats.total += 1
        idxs = range(len(self.shard_fns)) if shards is None else shards
        futures = {i: self._pool.submit(self.shard_fns[i], batch)
                   for i in idxs}
        out: list = [None] * len(self.shard_fns)

        def collect(pending: dict) -> dict:
            """pending: {shard_i: future}; returns the shards that failed."""
            deadline = time.monotonic() + self.timeout
            failed = {}
            for i, fut in pending.items():
                try:
                    out[i] = fut.result(
                        timeout=max(0.0, deadline - time.monotonic()))
                except FutTimeout:
                    failed[i] = fut
                    if on_late is not None:
                        def _deliver(f, i=i):
                            try:
                                if f.cancelled() or f.exception() is not None:
                                    return
                                on_late(i, f.result())
                            except Exception:
                                pass
                        fut.add_done_callback(_deliver)
                except Exception:
                    failed[i] = fut
            return failed

        down = collect(futures)
        self.stats.redispatched += len(down)
        if self.replica_fns is None:
            self.stats.failed += len(down)
            return out
        retries = {i: self._pool.submit(self.replica_fns[i], batch)
                   for i in down}
        self.stats.failed += len(collect(retries))
        return out

    def close(self):
        """Release the worker pool without waiting on hung shard calls."""
        self._pool.shutdown(wait=False)


def merge_topk(results: Sequence, k: int) -> np.ndarray:
    """Merge per-shard [n_i, 2] (score, id) arrays into the global top-k by
    score (descending, stable)."""
    rows = [np.asarray(r, np.float64).reshape(-1, 2)
            for r in results if r is not None]
    if not rows:
        return np.empty((0, 2), np.float64)
    allrows = np.concatenate(rows, axis=0)
    order = np.argsort(-allrows[:, 0], kind="stable")
    return allrows[order][:k]
