"""Share of the profiled training steps' window in which no device op ran."""


def read(trace: dict):
    if not trace.get("steps_profiled") or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
