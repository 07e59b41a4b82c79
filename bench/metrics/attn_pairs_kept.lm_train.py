"""Share of the (query, key) pairs the chunked attention scored that the
causal mask and the valid length keep (the program's counters
``attn.pairs_kept`` over ``attn.pairs_computed``)."""

from bench.program_spans import snapshot


def read(trace: dict):
    snap = snapshot(trace)
    if snap is None:
        return None
    c = snap["counters"]
    if not c.get("attn.pairs_computed"):
        return None
    return 100.0 * c["attn.pairs_kept"] / c["attn.pairs_computed"]
