"""Host time of the SGE bank per class (``core.milo``'s call of ``run_sge``,
synchronised), mean over the classes outside the profiler."""


def read(trace: dict):
    ts = trace.get("span_ms", {}).get("sge")
    return sum(ts) / len(ts) if ts else None
