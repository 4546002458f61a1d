"""CUDA kernels per batch in the traced window."""


def read(rec):
    t = rec["trace"]
    if not t or t["n_kernels"] == 0:
        return None
    return t["n_kernels"] / rec["batches"]
