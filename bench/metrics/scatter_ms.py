"""Host ms a batch in the program's `BatchExecutor.timings["scatter"]`."""


def read(rec):
    t = rec["timings"].get("scatter", 0.0)
    return 1e3 * t / rec["batches"] if t > 0 else None
