"""Tensors copied between host and device a batch,
`BatchExecutor.counts["h2d_copies"] + counts["d2h_copies"]` over
`counts["batches"]`.  Reads the record's `counts`, which bench/cell.py
does not keep yet: None until it does."""


def read(rec):
    c = rec.get("counts") or {}
    copies = c.get("h2d_copies", 0) + c.get("d2h_copies", 0)
    if not copies or not c.get("batches"):
        return None
    return copies / c["batches"]
