"""Host ms a batch in the program's `BatchExecutor.timings["plan"]`."""


def read(rec):
    t = rec["timings"]["plan"]
    return 1e3 * t / rec["batches"] if t > 0 else None
