"""The held experts' share of the card's bf16 peak: 18·d·f_e FLOP for each
held expert row of the forward passes (``moe.rows_held`` less what the
layer recomputes counted again; three products, once forward and twice
backward, no credit for the recompute) over the elapsed time of the
``lm.moe.experts`` spans and their backward, times 989 TFLOP/s.  A program
without the span or the counter gives nothing."""

from bench.counts.peaks import BF16_FLOPS
from bench.program_spans import layer_ms, snapshot


def read(trace: dict):
    ms = layer_ms(trace, "lm.moe.experts")
    snap = snapshot(trace)
    if not ms or snap is None or "moe_flops_per_row" not in trace:
        return None
    span = snap["spans"].get("lm.moe.route")
    if span is None or "moe.rows_held" not in span["counters"]:
        return None
    rows = (span["counters"]["moe.rows_held"]
            - span["recompute"]["counters"].get("moe.rows_held", 0)) / len(snap["steps"])
    return 100.0 * rows * trace["moe_flops_per_row"] / (ms * 1e-3 * BF16_FLOPS)
