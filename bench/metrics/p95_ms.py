"""95th percentile over every request of the window of the time from its
batch's issue to its answer (host clock), in ms."""
import numpy as np


def read(rec):
    lat = rec["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
