"""The training step's share of the card's bf16 peak: model FLOPs (PaLM's
form, ``bench/counts/model.py``) of the traced run's steps outside the
profiler, over their time (the window less the stretch the profiler held,
its own start and stop included, each end fenced by a synchronisation)
times 989 TFLOP/s.  The profiled steps are left out: the profiler's host
work slows them."""

from bench.counts.peaks import BF16_FLOPS


def read(trace: dict):
    if "steps_profiled" not in trace:
        return None
    steps = trace["steps"] - trace["steps_profiled"]
    seconds = trace["window_total_s"] - trace["profiler_held_s"]
    if steps <= 0 or seconds <= 0:
        return None
    return 100.0 * steps * trace["flops_per_step"] / (seconds * BF16_FLOPS)
