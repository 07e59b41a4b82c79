"""The program's own spans and counters (``repro_torch.obs``) over the
profiled steps of a traced run, for the per-layer metrics that read them.

The registry records the steps that run while the profiler records, so it
holds one ``train.step`` record per profiled step.  A program without the
registry, or a registry that holds another number of steps, gives nothing
to read."""
from __future__ import annotations


def snapshot(trace: dict) -> dict | None:
    """The registry's snapshot, or ``None``."""
    n = trace.get("steps_profiled")
    if not n:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    snap = obs.snapshot()
    if len(snap["steps"]) != n:
        return None
    return snap


def layer_ms(trace: dict, name: str) -> float | None:
    """Elapsed device ms per profiled step (between the spans' timing
    events, so idle waits inside count) of span ``name`` (its forward and
    its recomputes) and of ``<name>.bwd``'s self time (its backward, without
    the recomputes that run inside it); ``None`` off the card."""
    snap = snapshot(trace)
    if snap is None:
        return None
    fwd = snap["spans"].get(name, {}).get("device_ms")
    bwd = snap["spans"].get(name + ".bwd", {}).get("self_device_ms")
    if fwd is None or bwd is None:
        return None
    return (fwd + bwd) / len(snap["steps"])
