"""Device time per step of the ops launched inside the optimizer's update
(a span around the update of the optimizer object handed to the step)."""


def read(trace: dict):
    n = trace.get("steps_profiled")
    if not n or not trace.get("optim_s"):
        return None
    return 1e3 * trace["optim_s"] / n
