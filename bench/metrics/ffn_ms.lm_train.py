"""Elapsed device time per step of the feed-forward layers, idle included:
the time between the timing events of the program's ``lm.ffn`` spans (norm,
SwiGLU MLP, residual; forward and layer recompute) and the self time of
``lm.ffn.bwd``.  The card's waits for the host inside the spans count, so
two runs compare only at a similar ``device_idle``."""

from bench.program_spans import layer_ms


def read(trace: dict):
    return layer_ms(trace, "lm.ffn")
