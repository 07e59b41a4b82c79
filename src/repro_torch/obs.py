"""Spans and counters inside the port's training step.

An operator who wants to know where a step's time goes profiles a few
steps and reads the registry::

    from repro_torch import obs

    with torch.profiler.profile(...):          # or obs.enable()
        state, metrics = train_step(state, batch)
    snap = obs.snapshot()                      # per-name totals, the steps
    obs.reset()

``train.step`` (``obs.step``) is the root: at its entry the registry
decides once whether to record this step (while a ``torch.profiler`` is
recording, or after ``enable()``), and the decision holds until it exits,
so a checkpointed forward and its recompute build the same graph.  A step
captured into a CUDA graph (``Trainer(fused=True)`` on a card) is not
recorded: its replays run no Python, so there would be nothing but the
capture to time.  Inside,
``span(name)`` opens a named interval (parent: the innermost open span),
stamped on the host with ``time.time_ns()`` (the Unix clock, on which the
profiler also stamps its host events) and, on a card, with a pair of timing
events on the current stream.  ``count(name, n)`` adds to the innermost
open span.

Device times are resolved only when read: ``snapshot()`` waits for the end
events and takes their elapsed times; nothing on the step's path
synchronises.  A device time is the time elapsed on the stream between a
span's two events, so it holds the card's idle waits for the host inside
the span, not only the kernels' busy time.  A span's backward is its own span, ``<name>.bwd``: the
span's ``output(x)`` and ``input(x)`` put identity autograd nodes on its
output and input, whose backward opens and closes it (they save no tensor,
and the gradients are bit-equal with and without them).  A forward span
opened while a backward span is open is a recompute (activation
checkpointing) and is flagged so.

The open-span stack is one per process, not per thread: backward runs on
autograd's device thread while the caller waits.  The registry keeps the
last ``MAX_STEPS`` steps.  Off, ``span`` and ``count`` cost one flag check,
record nothing and add no autograd node.  The registry never calls
``torch.profiler.record_function``, so no span reaches the profiler's device
timeline.
"""
from __future__ import annotations

import time
from collections import deque

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_STEPS = 64
BACKWARD_SUFFIX = ".bwd"


def device_event(device=None) -> torch.cuda.Event | None:
    """A timing event recorded now on the current stream (of ``device``, else
    of the current device); ``None`` off the card, where there is nothing
    to time."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def elapsed_ms(start: torch.cuda.Event, end: torch.cuda.Event) -> float:
    """Device milliseconds between two recorded events (waits for ``end``)."""
    end.synchronize()
    return start.elapsed_time(end)


class _Record:
    __slots__ = ("name", "parent", "backward", "recompute", "t0", "t1", "ev0", "ev1",
                 "device_ms", "counters")

    def __init__(self, name, parent, backward, recompute, t0, ev0):
        self.name, self.parent, self.backward, self.recompute = name, parent, backward, recompute
        self.t0, self.t1, self.ev0, self.ev1 = t0, None, ev0, None
        self.device_ms = None
        self.counters: dict = {}


class _NullSpan:
    """What ``span`` returns while the registry is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def input(self, x):
        return x

    def output(self, x):
        return x


_NULL = _NullSpan()


class _Span:
    __slots__ = ("reg", "name", "backward", "rec", "marked")

    def __init__(self, reg: Registry, name: str, backward: bool = False):
        self.reg, self.name, self.backward = reg, name, backward
        self.rec, self.marked = None, False

    def __enter__(self):
        self.rec = self.reg._open(self.name, backward=self.backward)
        return self

    def __exit__(self, *exc):
        self.reg._close(self.rec)
        return False

    def input(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` through a node whose backward closes ``<name>.bwd``."""
        if not (torch.is_grad_enabled() and x.requires_grad):
            return x
        self.marked = True
        return _CloseBackward.apply(x, self.reg, self.name + BACKWARD_SUFFIX)

    def output(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` through a node whose backward opens ``<name>.bwd`` (only when
        an input was marked, so every open has its close)."""
        if not (self.marked and torch.is_grad_enabled() and x.requires_grad):
            return x
        return _OpenBackward.apply(x, self.reg, self.name + BACKWARD_SUFFIX)


class _Root(_Span):
    __slots__ = ("cuda",)

    def __init__(self, reg: Registry, name: str, cuda: bool):
        super().__init__(reg, name)
        self.cuda = cuda

    def __enter__(self):
        self.reg._begin_step(self.cuda)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            self.reg._close(self.rec)
        finally:
            self.reg._end_step()
        return False


class _OpenBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, reg, name):
        ctx.reg, ctx.name = reg, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.reg.active:
            ctx.reg._open(ctx.name, backward=True)
        return g, None, None


class _CloseBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, reg, name):
        ctx.reg, ctx.name = reg, name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.reg.active:
            ctx.reg._close_named(ctx.name)
        return g, None, None


def _totals() -> dict:
    return {"count": 0, "host_ms": 0.0, "device_ms": None, "self_device_ms": None,
            "counters": {}}


def _add(tot: dict, rec: _Record, self_dev: float | None) -> None:
    tot["count"] += 1
    tot["host_ms"] += (rec.t1 - rec.t0) * 1e-6
    if rec.device_ms is not None:
        tot["device_ms"] = (tot["device_ms"] or 0.0) + rec.device_ms
        tot["self_device_ms"] = (tot["self_device_ms"] or 0.0) + self_dev
    for k, v in rec.counters.items():
        tot["counters"][k] = tot["counters"].get(k, 0) + _number(v)


def _number(v):
    return v.item() if torch.is_tensor(v) else v


class Registry:
    """Spans and counters of the last ``MAX_STEPS`` steps (see the module's
    docstring).  The port records into one process-wide instance; the
    module's functions are its methods."""

    def __init__(self):
        self.enabled = False
        self.active = False
        self._cuda = False
        self._stack: list[_Record] = []
        self._records: list[_Record] | None = None
        self._steps: deque[list[_Record]] = deque(maxlen=MAX_STEPS)

    # -- switching ---------------------------------------------------------
    def enable(self) -> None:
        """Record every step from now on (not only while profiled)."""
        self.enabled = True

    def reset(self) -> None:
        """Forget every recorded step."""
        self._steps.clear()

    # -- recording ---------------------------------------------------------
    def step(self, name: str, *, device=None):
        """The root span of one step on ``device``: decides whether the step
        is recorded.  Inside an open step it is a plain span."""
        if self.active:
            return self.span(name)
        if not (self.enabled or _autograd_profiler._is_profiler_enabled):
            return _NULL
        cuda = device is not None and torch.device(device).type == "cuda"
        if cuda and torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            return _NULL
        return _Root(self, name, cuda=cuda)

    def span(self, name: str, *, backward: bool = False):
        """A named span inside the open step; ``backward`` marks a span whose
        inner forward spans are recomputes."""
        if not self.active:
            return _NULL
        return _Span(self, name, backward)

    def count(self, name: str, n) -> None:
        """Add ``n`` (a number, or a device tensor read at ``snapshot``) to
        the innermost open span's counter ``name``."""
        if not self.active or not self._stack:
            return
        c = self._stack[-1].counters
        c[name] = c.get(name, 0) + n

    def _begin_step(self, cuda: bool) -> None:
        self.active, self._cuda = True, cuda
        self._stack, self._records = [], []

    def _end_step(self) -> None:
        while self._stack:             # spans left open by an error
            self._close(self._stack[-1])
        if self._records:
            self._steps.append(self._records)
        self.active, self._records = False, None

    def _open(self, name: str, *, backward: bool = False) -> _Record:
        parent = self._stack[-1] if self._stack else None
        recompute = (not backward and parent is not None
                     and (parent.backward or parent.recompute))
        ev0 = device_event() if self._cuda else None
        rec = _Record(name, parent, backward, recompute, time.time_ns(), ev0)
        self._records.append(rec)
        self._stack.append(rec)
        return rec

    def _close(self, rec: _Record) -> None:
        if rec.t1 is not None:
            return
        while self._stack:
            top = self._stack.pop()
            top.ev1 = device_event() if self._cuda else None
            top.t1 = time.time_ns()
            if top is rec:
                return

    def _close_named(self, name: str) -> None:
        for rec in reversed(self._stack):
            if rec.name == name:
                self._close(rec)
                return

    # -- reading -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Per-name totals over the kept steps, and the steps themselves.

        ``spans[name]``: ``count``, ``host_ms``, ``device_ms`` (``None`` off
        the card), ``self_device_ms`` (the span less its child spans), ``counters`` (sums), and ``recompute``, the same over
        the records that were recomputes.  ``counters``: each counter's sum
        over every span.  ``steps``: one dict per root record (``name``,
        ``start_ns``, ``end_ns``, ``host_ms``, ``device_ms``,
        ``self_device_ms``) with its ``records`` (``name``, ``parent`` (an
        index into ``records``, or ``None``), ``start_ns``, ``end_ns``,
        ``device_ms``, ``recompute``), host stamps on the Unix clock."""
        spans: dict[str, dict] = {}
        counters: dict[str, float] = {}
        steps = []
        for recs in self._steps:
            _resolve(recs)
            index = {id(r): i for i, r in enumerate(recs)}
            child_dev = [0.0] * len(recs)
            for r in recs:
                if r.parent is not None:
                    child_dev[index[id(r.parent)]] += r.device_ms or 0.0
            for i, r in enumerate(recs):
                self_dev = None if r.device_ms is None else r.device_ms - child_dev[i]
                tot = spans.setdefault(r.name, _totals())
                _add(tot, r, self_dev)
                if r.recompute:
                    _add(tot.setdefault("recompute", _totals()), r, self_dev)
                for k, v in r.counters.items():
                    counters[k] = counters.get(k, 0) + _number(v)
            root = recs[0]
            steps.append({
                "name": root.name, "start_ns": root.t0, "end_ns": root.t1,
                "host_ms": (root.t1 - root.t0) * 1e-6, "device_ms": root.device_ms,
                "self_device_ms": None if root.device_ms is None
                else root.device_ms - child_dev[0],
                "records": [{"name": r.name,
                             "parent": None if r.parent is None else index[id(r.parent)],
                             "start_ns": r.t0, "end_ns": r.t1, "device_ms": r.device_ms,
                             "recompute": r.recompute} for r in recs]})
        for tot in spans.values():
            tot.setdefault("recompute", _totals())
        return {"spans": spans, "counters": counters, "steps": steps}


def _resolve(recs: list[_Record]) -> None:
    """Each record's device time, once; its events are dropped after."""
    for r in recs:
        if r.ev0 is not None and r.ev1 is not None:
            r.device_ms = elapsed_ms(r.ev0, r.ev1)
        r.ev0 = r.ev1 = None


REGISTRY = Registry()
enable = REGISTRY.enable
reset = REGISTRY.reset
step = REGISTRY.step
span = REGISTRY.span
count = REGISTRY.count
snapshot = REGISTRY.snapshot


def recording() -> bool:
    """Whether the open step is being recorded (guards counting work that
    costs more than a flag check)."""
    return REGISTRY.active
