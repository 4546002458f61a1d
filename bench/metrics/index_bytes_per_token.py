"""Device bytes the engine holds after set-up (torch.cuda.memory_allocated
after the arena and warm-up, less before the engine), per corpus token:
the additional indexes' space cost."""


def read(rec):
    b = rec["index_bytes"]
    return b / rec["tokens"] if b else None
