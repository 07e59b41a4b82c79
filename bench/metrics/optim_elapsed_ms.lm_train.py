"""Elapsed device time per step across the program's ``optim.update`` span,
idle included: from the event recorded at its start to the one at its
end, the optimizer's kernels and the idle gaps between them."""

from bench.program_spans import snapshot


def read(trace: dict):
    snap = snapshot(trace)
    if snap is None:
        return None
    ms = snap["spans"].get("optim.update", {}).get("device_ms")
    return None if ms is None else ms / len(snap["steps"])
