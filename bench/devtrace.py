"""The traced run's instruments, all from outside the program:

* `KernelCalls` wraps the CUDA entry points of the four search kernels
  (`repro_torch.kernels.ops.<name>_cuda`, which the kernels' operators
  look up at each call) and keeps the inputs of each call that launched,
  so that the bytes of each call can be counted after the window;
* `Spans` wraps the calls into each layer of the batched executor in
  `torch.profiler.record_function` spans named `bench.<layer>`, which
  name what the host was doing in the device's idle gaps;
* `reduce_trace` reduces the profiler's events to the device's busy
  time, its kernels by name, and its idle gaps by host span.
"""
from __future__ import annotations

import contextlib

# kernel -> (entry point in repro_torch.kernels.ops, CUDA function name)
KERNELS = {
    "unpack": ("unpack_postings_cuda", "unpack_postings_kernel"),
    "intersect": ("banded_intersect_rows_cuda",
                  "banded_intersect_rows_kernel"),
    "min_delta": ("banded_min_delta_rows_cuda",
                  "banded_min_delta_rows_kernel"),
    "delta_mask": ("banded_delta_mask_rows_cuda",
                   "banded_delta_mask_rows_kernel"),
}
RECORD_BYTES_CAP = 6 << 30     # inputs kept alive at most; later calls
                               # are timed but not counted


class KernelCalls:
    """Records the inputs of each launching call of the search kernels,
    in launch order, until their bytes reach RECORD_BYTES_CAP."""

    def __init__(self, ops):
        self.ops = ops
        self.calls = {k: [] for k in KERNELS}
        self.launched = dict.fromkeys(KERNELS, 0)
        self.kept_bytes = 0
        self._kept = set()             # storages already counted
        self._orig = {}

    def _wrap(self, kernel: str, fn):
        def rec(*args):
            before = fn.launches
            out = fn(*args)
            if fn.launches > before:
                self.launched[kernel] += 1
                # the arena is one storage shared by every call: count each
                # storage once
                new = {x.untyped_storage().data_ptr(): x.untyped_storage().nbytes()
                       for x in args}
                size = sum(v for k, v in new.items() if k not in self._kept)
                # every call up to the cap, in order, so the recorded calls
                # are the first launches of the trace
                if (self.kept_bytes + size <= RECORD_BYTES_CAP
                        and len(self.calls[kernel]) == self.launched[kernel] - 1):
                    self.calls[kernel].append(args)
                    self.kept_bytes += size
                    self._kept.update(new)
            return out
        return rec

    def __enter__(self):
        for k, (entry, _) in KERNELS.items():
            fn = getattr(self.ops, entry)
            self._orig[entry] = fn
            setattr(self.ops, entry, self._wrap(k, fn))
        return self

    def __exit__(self, *exc):
        for entry, fn in self._orig.items():
            setattr(self.ops, entry, fn)
        return False


@contextlib.contextmanager
def spans(torch):
    """`bench.<layer>` spans around the batched executor's layers."""
    import repro_torch.core.batch_executor as bx
    import repro_torch.core.engine as eng
    import repro_torch.core.executor as ex
    rf = torch.profiler.record_function
    patched = [(eng._BatchSearchMixin, "_plan", "bench.plan"),
               (bx.BatchExecutor, "_build_tasks", "bench.rows"),
               (bx.BatchExecutor, "_tensorize_bucket", "bench.tensorize"),
               (bx.BatchExecutor, "_merge_plan", "bench.merge"),
               (ex.Executor, "execute", "bench.flex"),
               (bx, "bucket_step_math", "bench.device_step")]
    saved = []

    def wrap(fn, name):
        def inner(*a, **kw):
            with rf(name):
                return fn(*a, **kw)
        return inner

    try:
        for owner, attr, name in patched:
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, wrap(fn, name))
        yield
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(events, window_name: str = "bench.window") -> dict:
    """From the profiler's events (objects with name(), device_type(),
    start_ns(), duration_ns()): the traced window's length, the device's
    busy seconds (the union of its kernel, copy and set intervals inside
    the window), the kernels' durations by name in start order, the
    count of kernels, the device ops that took most time and the idle
    gaps summed by the innermost `bench.` span the host was in."""
    cpu, dev = [], []
    win = None
    for e in events:
        kind = str(e.device_type()).rsplit(".", 1)[-1]
        item = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if kind == "CPU":
            if item[2] == window_name:
                win = item
            elif item[2].startswith("bench."):
                cpu.append(item)
        elif kind == "CUDA" and not item[2].startswith("bench."):
            # (the device rows of the bench spans are annotations, not work)
            dev.append(item)
    if win is None:
        raise RuntimeError(f"no {window_name} span in the trace")
    w0, w1 = win[0], win[1]
    dev = sorted(x for x in dev if w0 <= x[0] < w1)
    busy = _merge([(s, min(e, w1)) for s, e, _ in dev])
    busy_ns = sum(e - s for s, e in busy)
    by_name: dict = {}
    kernels: dict = {}
    n_kernels = 0
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0) + (e - s)
        if not (n.startswith("Memcpy") or n.startswith("Memset")):
            n_kernels += 1
            kernels.setdefault(n, []).append((s, e - s))
    # idle gaps, each charged to the innermost bench span at its middle
    # (spans of one thread nest: a sweep with a stack finds it)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps: dict = {}
    cpu.sort(key=lambda x: (x[0], -x[1]))      # outer spans first
    stack, i = [], 0
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) // 2
        while i < len(cpu) and cpu[i][0] <= mid:
            while stack and stack[-1][1] < cpu[i][0]:
                stack.pop()
            stack.append(cpu[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "host outside the executor"
        gaps[label] = gaps.get(label, 0) + (e - s)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9,
            "kernels": kernels, "n_kernels": n_kernels,
            "device_ops": [[n, t / 1e9] for n, t in top],
            "idle_gaps": [[n, t / 1e9] for n, t in idle]}


def kernel_seconds(reduced: dict, cuda_name: str) -> list:
    """Durations (s) of the kernels whose name holds `cuda_name`, in
    start order."""
    out = []
    for name, ds in reduced["kernels"].items():
        if cuda_name in name:
            out.extend(ds)
    return [d / 1e9 for _, d in sorted(out)]
