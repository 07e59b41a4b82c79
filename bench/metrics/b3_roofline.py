"""B3's share of its roofline: the least time of its calls in the profiled
window (`bench/counts/kernels.py`, from each call's shapes) over the
device time of the ops launched inside its entry point's span."""


def read(trace: dict):
    bound = trace.get("kernel_bound_s", {}).get("b3")
    spent = trace.get("kernel_s", {}).get("b3")
    if not bound or not spent:
        return None
    return 100.0 * bound / spent
