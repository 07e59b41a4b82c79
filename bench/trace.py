"""Spans around the calls into the program's layers, the profiler over a
bounded part of the window, and the reduction of its events to the numbers
the per-layer metrics read.

Spans are the benchmark's own: ``Spans.wrap`` replaces a module attribute
of the program by a wrapper that times the call on the host (synchronising
the card before and after, so a span holds its device work) and marks it
for the profiler with ``record_function("bench.<name>")``.  Kernel entry
points get spans named ``bench.k.<kernel>``; a device op belongs to the
kernel span or layer span inside which the host op that launched it ran.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Any, Callable

import torch

SPAN_PREFIX = "bench."
KERNEL_PREFIX = "bench.k."


def fence(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Host-timed spans around module attributes, removed by ``restore``."""

    def __init__(self, *, sync: bool, device: torch.device):
        self.sync = sync and device.type == "cuda"
        self.device = device
        self.times: dict[str, list[float]] = defaultdict(list)
        self._patched: list[tuple[Any, str, Any]] = []

    def _fence(self) -> None:
        if self.sync:
            torch.cuda.synchronize(self.device)

    def wrap(self, owner: Any, attr: str, name: str, *,
             before: Callable | None = None, after: Callable | None = None) -> None:
        """Span ``name`` around ``owner.attr``; ``before(args, kwargs)`` and
        ``after(result, seconds)`` run outside the timed part."""
        inner = getattr(owner, attr)
        label = SPAN_PREFIX + name

        def wrapper(*args, **kwargs):
            if before is not None:
                before(args, kwargs)
            self._fence()
            t0 = time.perf_counter()
            with torch.profiler.record_function(label):
                out = inner(*args, **kwargs)
            self._fence()
            dt = time.perf_counter() - t0
            self.times[name].append(dt)
            if after is not None:
                after(out, dt)
            return out

        wrapper.__wrapped__ = inner
        setattr(owner, attr, wrapper)
        self._patched.append((owner, attr, inner))

    def restore(self) -> None:
        for owner, attr, inner in reversed(self._patched):
            setattr(owner, attr, inner)
        self._patched.clear()


def patch(owner: Any, attr: str, fn_of_inner: Callable, undo: list) -> None:
    """Replace ``owner.attr`` by ``fn_of_inner(inner)``; ``undo`` collects
    what ``unpatch`` puts back."""
    inner = getattr(owner, attr)
    setattr(owner, attr, fn_of_inner(inner))
    undo.append((owner, attr, inner))


def unpatch(undo: list) -> None:
    for owner, attr, inner in reversed(undo):
        setattr(owner, attr, inner)
    undo.clear()


class Profile:
    """``torch.profiler`` over [start, stop], with the card synchronised at
    both ends so the window holds the device work issued inside it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.window_s = 0.0
        self.held_s = 0.0
        self.active = False

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._fence()
        self._t_held = time.perf_counter()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.active = True
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._fence()
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.active = False
        # the stretch the profiler held, its own start and stop included
        self.held_s = time.perf_counter() - self._t_held

    def events(self) -> tuple[list[tuple], list[tuple], list[tuple], tuple[int, int]]:
        """(host ops, launches, device ops, (first, last) ns) from the raw
        trace.

        Host ops: (id, name, start ns, end ns) of the framework's ops and the
        spans.  Launches: (correlation id, start ns, id of the host op they
        ran in or 0) of each runtime call that put work on the card (a launch
        through ``ctypes``, as the port's kernels make, runs in no host op).
        Device ops: (name, start ns, end ns, correlation id of its launch)."""
        from torch.autograd import DeviceType

        host, launches, dev = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            t, name = e.device_type(), e.name()
            if t == DeviceType.CPU:
                if name.startswith("cu"):
                    launches.append((e.correlation_id(), e.start_ns(), e.linked_correlation_id()))
                elif e.linked_correlation_id() == 0:
                    host.append((e.correlation_id(), name, e.start_ns(), e.end_ns()))
            elif t == DeviceType.CUDA and not name.startswith(SPAN_PREFIX):
                # (a span's own range on the device timeline is no device op)
                dev.append((name, e.start_ns(), e.end_ns(), e.correlation_id()))
        lo = min((h[2] for h in host), default=0)
        hi = max((h[3] for h in host), default=0)
        return host, launches, dev, (lo, hi)


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Ranges:
    """Non-overlapping named host ranges, looked up by a time."""

    def __init__(self, ranges: list[tuple[str, int, int]]):
        self.ranges = sorted(ranges, key=lambda r: r[1])
        self.starts = [r[1] for r in self.ranges]

    def at(self, t: int) -> str | None:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.ranges[i][2] >= t:
            return self.ranges[i][0]
        return None


def reduce_events(host: list[tuple], launches: list[tuple], dev: list[tuple],
                  window: tuple[int, int], *, window_s: float, top: int = 10) -> dict:
    """The numbers the readers use, from one profiled window:

    - ``busy_s``: the union of device ops' intervals;
    - ``window_s``: the window's length;
    - ``device_ops``: how many device ops ran;
    - ``device_s_by_span``: device seconds per span (a kernel span, else the
      layer span, of the host op that launched the device op);
    - ``breakdown``: the device ops that took most time, and the idle gaps
      between device ops by what the host was doing when the op after the
      gap was launched (its layer span and host op)."""
    w0, w1 = window
    ops = {h[0]: h for h in host}
    spans = [(h[1][len(SPAN_PREFIX):], h[2], h[3]) for h in host if h[1].startswith(SPAN_PREFIX)]
    kernel_spans = _Ranges([s for s in spans if ("bench." + s[0]).startswith(KERNEL_PREFIX)])
    layer_spans = _Ranges([s for s in spans if not ("bench." + s[0]).startswith(KERNEL_PREFIX)])
    dev = sorted((d for d in dev if d[2] > w0 and d[1] < w1), key=lambda d: d[1])
    by_name: dict[str, float] = defaultdict(float)
    by_span: dict[str, float] = defaultdict(float)
    launched_at: list[tuple[int, str]] = []
    calls = {c[0]: c for c in launches}
    for name, a, b, corr in dev:
        secs = (b - a) * 1e-9
        by_name[name] += secs
        call = calls.get(corr)
        op = ops.get(call[2]) if call is not None else None
        t_launch = call[1] if call is not None else a
        span = kernel_spans.at(t_launch) or layer_spans.at(t_launch)
        if span is not None:
            by_span[span] += secs
        host_name = (layer_spans.at(t_launch) or "-") + "/" + (op[1] if op is not None else "?")
        launched_at.append((a, host_name))
    busy = _union([(max(a, w0), min(b, w1)) for _, a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-9
    gaps: dict[str, float] = defaultdict(float)
    starts = [a for a, _ in launched_at]
    prev_end = w0
    for a, b in busy:
        if a > prev_end:
            i = bisect.bisect_left(starts, a)
            name = launched_at[i][1] if i < len(launched_at) else "?"
            gaps[name] += (a - prev_end) * 1e-9
        prev_end = b
    if w1 > prev_end:
        gaps["end of window"] += (w1 - prev_end) * 1e-9
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "device_ops": len(dev),
        "device_s_by_span": dict(by_span),
        "breakdown": {
            "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda x: -x[1])[:top]],
        },
    }
