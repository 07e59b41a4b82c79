"""How many times each KV block step of the chunked attention runs per
training step: the program's ``attn.block_steps`` over those counted in the
forward pass (layers × KV blocks × steps), so the forward, the layer's
recompute and the block's recompute each add one."""

from bench.program_spans import snapshot


def read(trace: dict):
    snap = snapshot(trace)
    if snap is None:
        return None
    span = snap["spans"].get("lm.attention")
    if span is None:
        return None
    forward = (span["counters"].get("attn.block_steps", 0)
               - span["recompute"]["counters"].get("attn.block_steps", 0))
    if not forward:
        return None
    return snap["counters"]["attn.block_steps"] / forward
