"""The caching allocator's peak of the training run, in GiB."""


def read(trace: dict):
    if "steps_profiled" not in trace:
        return None
    return trace["peak_bytes"] / 2**30
