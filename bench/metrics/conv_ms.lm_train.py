"""Elapsed device time per step of the short-convolution operators, idle
included: the time between the timing events of the program's ``lm.conv``
spans (in_proj, the gated 3-tap convolution, out_proj; forward and layer
recompute) and the self time of ``lm.conv.bwd``.  A program without the
span gives nothing."""

from bench.program_spans import layer_ms


def read(trace: dict):
    return layer_ms(trace, "lm.conv")
