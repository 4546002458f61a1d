#!/usr/bin/env python3
"""One run of a cell, made as bench/run.py makes it, that also prints the
program's spans and counters on standard error:

    python3 bench/spans.py --workload <cell> --seed N --seconds S
                           --trace 0|1

    [spans] batches=<n> <span>_ms=<host ms a batch, each key of
            BatchExecutor.timings> <counter>=<each of BatchExecutor.counts
            a batch over the window>
    [spans] idle_gaps=<[[span, s], ...]> idle_s=<s> named_share=<share>
            ranges=<{span: count}>      (traced runs: the device's idle
            gaps charged to the innermost `repro.` span, bench/progspans.py)

The run itself, its result line and its metrics are bench/run.py's: the
lines are read from outside, through the run's log, its engine and its
trace reduction (bench/cell.py keeps neither the counters nor these lines).
Against a program without the spans, the line gives the timings it has.
"""
from __future__ import annotations

# first: bench/run.py starts the run's clock and sets its threads
import run

import contextlib
import json
import re
import sys

import cell
import devtrace
import progspans


def spans_line(timings: dict, counts: dict, counts0: dict,
               batches: int) -> str:
    """The `[spans]` line: ms a batch of each span, and each counter's
    growth since `counts0` a batch (`batches` is the denominator)."""
    n = max(batches, 1)
    parts = [f"batches={batches}"]
    parts += [f"{k}_ms={1e3 * v / n:.4f}" for k, v in timings.items()]
    parts += [f"{k}={(v - counts0.get(k, 0)) / n:.4f}"
              for k, v in counts.items() if k != "batches"]
    return "[spans] " + " ".join(parts)


def idle_line(events) -> str:
    """The `[spans] idle_gaps=` line of a traced window's events."""
    p = progspans.program_spans(events)
    gaps = [[n, round(s, 6)] for n, s in p["idle_gaps"]]
    return (f"[spans] idle_gaps={json.dumps(gaps)} idle_s={p['idle_s']:.6f} "
            f"named_share={p['named_share']} "
            f"ranges={json.dumps(p['ranges'], sort_keys=True)}")


@contextlib.contextmanager
def hooks():
    """While open, `cell.run_cell` logs the two `[spans]` lines."""
    seen: dict = {}
    make_engine, run_cell = cell.make_engine, cell.run_cell
    reduce_trace = devtrace.reduce_trace

    def making(*a, **kw):
        engine = make_engine(*a, **kw)
        seen["ex"] = engine.batch_executor
        return engine

    def running(cfg, mix, seed, seconds, trace, device, metrics, t_start,
                log=print, index_cache=None):
        def hooked(line):
            log(line)
            ex = seen.get("ex")
            counts = getattr(ex, "counts", {})
            if line.startswith("[setup]"):
                seen["counts0"] = dict(counts)
            elif line.startswith("[window]"):
                batches = int(re.search(r" batches=(\d+)", line).group(1))
                log(spans_line(ex.timings, counts, seen["counts0"], batches))
        seen["log"] = hooked
        return run_cell(cfg, mix, seed, seconds, trace, device, metrics,
                        t_start, hooked, index_cache)

    def reducing(events, *a, **kw):
        events = list(events)
        seen["log"](idle_line(events))
        return reduce_trace(events, *a, **kw)

    cell.make_engine, cell.run_cell = making, running
    devtrace.reduce_trace = reducing
    try:
        yield
    finally:
        cell.make_engine, cell.run_cell = make_engine, run_cell
        devtrace.reduce_trace = reduce_trace


if __name__ == "__main__":
    with hooks():
        code = run.main()
    sys.exit(code)
