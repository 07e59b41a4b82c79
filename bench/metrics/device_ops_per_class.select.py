"""Device ops (kernels, copies, fills) per class in the profiled window."""


def read(trace: dict):
    n = trace.get("classes_profiled")
    return trace["device_ops"] / n if n else None
