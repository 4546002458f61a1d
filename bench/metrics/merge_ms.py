"""Host ms a batch in the program's `BatchExecutor.timings["merge"]`."""


def read(rec):
    t = rec["timings"]["merge"]
    return 1e3 * t / rec["batches"] if t > 0 else None
