"""The traced window's idle gaps charged to the program's own spans: the
`repro.<span>` ranges that `repro_torch.core.trace` opens while the
profiler records.  The rule is `devtrace.reduce_trace`'s (each gap of the
device goes to the innermost span the host was in at its middle), applied
to the `repro.` ranges in place of the harness's `bench.` spans."""
from __future__ import annotations

# bound at import: bench/spans.py wraps devtrace.reduce_trace in a run
from devtrace import reduce_trace

PREFIX = "repro."
OUTSIDE = "host outside the executor"      # reduce_trace's label


class _Renamed:
    """A profiler event under another name."""
    __slots__ = ("event", "label")

    def __init__(self, event, label: str):
        self.event = event
        self.label = label

    def name(self):
        return self.label

    def device_type(self):
        return self.event.device_type()

    def start_ns(self):
        return self.event.start_ns()

    def duration_ns(self):
        return self.event.duration_ns()


def program_spans(events, window_name: str = "bench.window") -> dict:
    """From the profiler's events: the idle gaps by innermost `repro.` span
    (the ten largest, seconds), the window's idle seconds, the share of
    them charged to a span other than `repro.batch`'s self time, and the
    count of each `repro.` range that began in the window."""
    kept, ranges, win = [], [], None
    for e in events:
        name = e.name()
        if str(e.device_type()).rsplit(".", 1)[-1] == "CPU":
            if name == window_name:
                win = (e.start_ns(), e.start_ns() + e.duration_ns())
            elif name.startswith(PREFIX):
                ranges.append((e.start_ns(), name))
                e = _Renamed(e, "bench." + name)
            elif name.startswith("bench."):
                continue                     # the harness's own spans
        kept.append(e)
    r = reduce_trace(kept, window_name)
    gaps = [[n[len("bench."):] if n != OUTSIDE else n, s]
            for n, s in r["idle_gaps"]]
    idle_s = r["window_s"] - r["busy_s"]
    named = sum(s for n, s in gaps
                if n.startswith(PREFIX) and n != PREFIX + "batch")
    counts: dict = {}
    for start, name in ranges:
        if win[0] <= start < win[1]:
            counts[name] = counts.get(name, 0) + 1
    return {"idle_gaps": gaps, "idle_s": idle_s,
            "named_share": named / idle_s if idle_s > 0 else None,
            "ranges": counts}
