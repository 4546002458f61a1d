"""Seconds from the process's start to the window: inputs, the host build of
the index, the arena on the card, kernels built or loaded, warm-up."""


def read(rec):
    return rec["setup_s"]
