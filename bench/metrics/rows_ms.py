"""Host ms a batch in the program's `BatchExecutor.timings["rows"]`."""


def read(rec):
    t = rec["timings"]["rows"]
    return 1e3 * t / rec["batches"] if t > 0 else None
