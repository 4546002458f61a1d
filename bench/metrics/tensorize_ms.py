"""Host ms a batch in the program's `BatchExecutor.timings["tensorize"]`."""


def read(rec):
    t = rec["timings"]["tensorize"]
    return 1e3 * t / rec["batches"] if t > 0 else None
