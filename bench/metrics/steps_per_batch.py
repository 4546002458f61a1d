"""Device steps a batch, `BatchExecutor.counts["steps"]` over its
`counts["batches"]`: bucket chunks, each ending in one wait for the
device.  Reads the record's `counts`, which bench/cell.py does not keep
yet: None until it does."""


def read(rec):
    c = rec.get("counts") or {}
    if not c.get("steps") or not c.get("batches"):
        return None
    return c["steps"] / c["batches"]
