"""Host time of the dense route's Gram per class (``core.milo``'s call of
``gram_matrix_blocked``, synchronised), mean over the classes outside the
profiler.  Nothing to read on the gram-free route."""


def read(trace: dict):
    ts = trace.get("span_ms", {}).get("gram")
    return sum(ts) / len(ts) if ts else None
