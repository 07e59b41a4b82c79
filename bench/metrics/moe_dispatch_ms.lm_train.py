"""Elapsed device time per step of the expert layer's dispatch, idle
included: the program's ``lm.moe.route`` spans (router, top-k, the sort of
the (token, choice) pairs by expert, the gather of their rows) and
``lm.moe.combine`` spans (weighting, the k slots summed per token), each
forward and layer recompute, plus the self time of their ``.bwd`` spans.
A program without the spans gives nothing."""

from bench.program_spans import layer_ms


def read(trace: dict):
    route, combine = layer_ms(trace, "lm.moe.route"), layer_ms(trace, "lm.moe.combine")
    if route is None or combine is None:
        return None
    return route + combine
