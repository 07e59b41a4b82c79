"""Elapsed device time per step of the attention layers, idle included: the
time between the timing events of the program's ``lm.attention`` spans
(norm, projections, chunked attention, residual; forward and layer
recompute) and the self time of ``lm.attention.bwd`` (their backward, the
per-block recompute included).  The card's waits for the host inside the
spans count, so two runs compare only at a similar ``device_idle``."""

from bench.program_spans import layer_ms


def read(trace: dict):
    return layer_ms(trace, "lm.attention")
