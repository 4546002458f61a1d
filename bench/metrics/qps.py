"""Requests answered in the window over the window's seconds (host clock)."""


def read(rec):
    return rec["requests"] / rec["window_s"]
