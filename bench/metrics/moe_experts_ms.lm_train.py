"""Elapsed device time per step of the held experts' SwiGLU products, idle
included: the program's ``lm.moe.experts`` spans (forward and layer
recompute) and the self time of ``lm.moe.experts.bwd``.  A program without
the span gives nothing."""

from bench.program_spans import layer_ms


def read(trace: dict):
    return layer_ms(trace, "lm.moe.experts")
