"""95th percentile of the requests' issue-to-answer time in the traced
window (host clock, under the profiler), in ms: the tail of a cell whose
runs spread too widely for `p95_ms` to hold a bound."""
import numpy as np


def read(rec):
    lat = rec["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
