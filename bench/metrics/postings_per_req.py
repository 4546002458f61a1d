"""Postings the plans read, per request (`SearchResponse.postings_read`)."""


def read(rec):
    return rec["postings"] / rec["requests"] if rec["requests"] else None
