"""Fault injection for the serving stack (drives tests/test_torch_front.py
and phase 4c of chip_smoke.py).

Production failure modes are reproduced deterministically, in-process:

  * shard stalls      — `ChaosShard(stall_s=...)` sleeps before answering,
                        longer than the dispatcher timeout when the caller
                        wants a straggler dropped;
  * shard failures    — `ChaosShard(fail=True)` raises `ChaosError`;
  * queue floods      — callers submit `flood()` batches far above
                        `FrontDoorConfig.max_queue` while a stalled shard
                        pins the dispatcher, forcing admission control to
                        shed;
  * clock skew        — `SkewedClock` stands in for `time.monotonic` inside
                        the front door; jumping `skew_s` mid-run makes
                        previously-admitted deadlines unmeetable, the way a
                        stepped NTP clock or a GC/preemption pause does.

Everything is mutable mid-run (`set(...)`): a caller can fail a primary for
one dispatch and heal it for the retry.  All state changes are plain
attribute writes guarded by the GIL — the dispatcher's worker threads only
ever read.
"""
from __future__ import annotations

import threading
import time


class ChaosError(RuntimeError):
    """The injected shard failure (distinguishable from real bugs)."""


class SkewedClock:
    """Monotonic clock with an injectable offset.  Callable — drop-in for
    `time.monotonic` wherever a component accepts a `clock=` parameter."""

    def __init__(self, skew_s: float = 0.0):
        self.skew_s = float(skew_s)

    def __call__(self) -> float:
        return time.monotonic() + self.skew_s


class ChaosShard:
    """Wrap a shard callable with injectable stall / failure behavior.

    >>> shard = ChaosShard(backend)        # healthy passthrough
    >>> shard.set(stall_s=1.0)             # straggler: sleeps, then answers
    >>> shard.set(fail=True, stall_s=0.0)  # raises ChaosError instead
    >>> shard.set()                        # heal

    `calls` counts every invocation (including failed ones) so callers can
    assert a replica actually absorbed the re-dispatch.
    """

    def __init__(self, fn, stall_s: float = 0.0, fail: bool = False):
        self.fn = fn
        self.stall_s = float(stall_s)
        self.fail = bool(fail)
        self.calls = 0
        self._lock = threading.Lock()

    def set(self, stall_s: float = 0.0, fail: bool = False):
        self.stall_s = float(stall_s)
        self.fail = bool(fail)

    def __call__(self, batch):
        with self._lock:
            self.calls += 1
        if self.stall_s > 0:
            time.sleep(self.stall_s)
        if self.fail:
            raise ChaosError(f"injected failure after {self.calls} calls")
        return self.fn(batch)


def flood(front, requests, client: str = "flood", wait: bool = True):
    """Submit every request as fast as possible (no pacing — the 4x-capacity
    queue-flood scenario) and return the tickets; `wait=True` blocks until
    every ticket resolves, which is exactly the no-silent-drop property: a
    dropped request would hang here forever (callers run under timeouts)."""
    tickets = [front.submit(r, client=client) for r in requests]
    if wait:
        for t in tickets:
            t.result()
    return tickets
