"""Host time of the WRE importance pass per class (``core.milo``'s call of
``greedy_importance``, synchronised), mean over the classes outside the
profiler."""


def read(trace: dict):
    ts = trace.get("span_ms", {}).get("wre")
    return sum(ts) / len(ts) if ts else None
