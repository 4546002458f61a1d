"""Host spans and counters of the batched search path.

`Trace.seconds` sums the host's `perf_counter` seconds per span name and
`Trace.counts` sums integer counters; `BatchExecutor.timings` and
`BatchExecutor.counts` are these two dicts.  Spans nest:

    batch        one `search_batch` (the engine's or the serve tier's)
      plan       the planner, every request of the batch
      rows       tasks segmented into doc-shard rows
      bucket     rows grouped into shape buckets (each round)
      tensorize  a bucket chunk's tables built, and copied to the device
        h2d      the copies
      device     a bucket chunk's step until its results are on the host
        launch   the step's eager launches (the host's enqueue, and any
                 wait hidden in it)
        d2h      the wait for the stream, then the results' copies
      scatter    each row's keys (and scores) taken from the results
      collect    the main rows' keys collected between the two rounds
      merge      a plan's responses merged on the host
      flex       a plan run through the flexible executor

While `torch.profiler` records, and only then, each span also opens a
range `repro.<name>` on the profiler's timeline, the clock its CUDA
activity is stamped on.  The ranges are function-scope record functions:
a `torch.profiler.record_function` range (user scope) also puts a
`gpu_user_annotation` row on the device's timeline, spanning the kernels
it launched, which a reader of the device's busy time would take for work.
The `batch` range carries the batch's ordinal and request count as its
keyword arguments (kept where the profiler records inputs).
"""
from __future__ import annotations

import time

import torch

SPANS = ("batch", "plan", "rows", "bucket", "tensorize", "h2d", "device",
         "launch", "d2h", "scatter", "collect", "merge", "flex")
COUNTS = ("batches", "rows", "fallback_rows", "buckets", "steps",
          "h2d_copies", "h2d_bytes", "d2h_copies", "d2h_bytes", "flex_plans")

_recording = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


class _Span:
    __slots__ = ("seconds", "name", "args", "range", "t0")

    def __init__(self, seconds: dict, name: str, args: dict):
        self.seconds = seconds
        self.name = name
        self.args = args

    # the seconds include the range's own cost, so that a parent's self
    # time holds none of its children's tracing
    def __enter__(self):
        self.t0 = time.perf_counter()
        self.range = None
        if _recording():
            self.range = _Range("repro." + self.name, (), self.args)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        self.seconds[self.name] += time.perf_counter() - self.t0
        return False


class Trace:
    """Seconds per span and counts per counter, zero at the start; callers
    reset them as they like (every key of SPANS and COUNTS stays)."""

    def __init__(self):
        self.seconds = dict.fromkeys(SPANS, 0.0)
        self.counts = dict.fromkeys(COUNTS, 0)

    def span(self, name: str, **args) -> _Span:
        """A context that adds its host seconds to `seconds[name]`."""
        return _Span(self.seconds, name, args)
