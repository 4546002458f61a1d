"""Host ms a batch in the program's `batch` span that none of its direct
children covers (`BatchExecutor.timings`): `batch` less plan, rows,
bucket, tensorize, device, scatter, collect, merge and flex."""

CHILDREN = ("plan", "rows", "bucket", "tensorize", "device", "scatter",
            "collect", "merge", "flex")


def read(rec):
    t = rec["timings"]
    if t.get("batch", 0.0) <= 0:
        return None
    self_s = t["batch"] - sum(t.get(k, 0.0) for k in CHILDREN)
    return 1e3 * self_s / rec["batches"] if self_s > 0 else None
