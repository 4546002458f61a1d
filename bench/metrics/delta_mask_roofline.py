"""The delta_mask kernel's share of its roofline, in percent: the least seconds
its recorded calls of the traced window could take (bench/roofline.py) over
the seconds the trace gives those launches."""


def read(rec):
    k = rec["kernels"].get("delta_mask")
    if not k or k["trace_s"] <= 0:
        return None
    return 100.0 * k["least_s"] / k["trace_s"]
