"""Host ms a batch in the program's `BatchExecutor.timings["h2d"]`."""


def read(rec):
    t = rec["timings"].get("h2d", 0.0)
    return 1e3 * t / rec["batches"] if t > 0 else None
