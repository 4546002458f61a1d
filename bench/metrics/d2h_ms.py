"""Host ms a batch in the program's `BatchExecutor.timings["d2h"]`."""


def read(rec):
    t = rec["timings"].get("d2h", 0.0)
    return 1e3 * t / rec["batches"] if t > 0 else None
