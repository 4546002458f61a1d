"""Host ms a batch in the program's `BatchExecutor.timings["flex"]`."""


def read(rec):
    t = rec["timings"]["flex"]
    return 1e3 * t / rec["batches"] if t > 0 else None
