"""Host time per step spent waiting for the pipeline's next batch, mean over
the window's steps."""


def read(trace: dict):
    ws = trace.get("batch_wait_ms")
    return sum(ws) / len(ws) if ws else None
