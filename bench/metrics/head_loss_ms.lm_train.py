"""Elapsed device time per step of the head and the loss, idle included: the
time between the timing events of the program's ``lm.head`` span (final
norm, tied unembedding, cross entropy) and the self time of
``lm.head.bwd``.  The card's waits for the host inside the spans count, so
two runs compare only at a similar ``device_idle``."""

from bench.program_spans import layer_ms


def read(trace: dict):
    return layer_ms(trace, "lm.head")
