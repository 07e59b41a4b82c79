"""Device-resident training engine: fused supersteps over resident data
(port of ``repro.train.engine``).

MILO's subsets are small and known before the epoch starts, so the selected
data can stay on the device for the whole run and whole stretches of an
epoch can run as one device program instead of one Python-issued step at a
time.  The reference compiles a ``lax.scan`` with the state donated; here a
segment of ``S`` steps is one **CUDA graph** (``torch.cuda.CUDAGraph``),
captured once per segment shape after a warm-up on a side stream, and
replayed:

  * ``make_superstep(train_step)`` — ``S`` already-assembled batches,
    stacked along a leading axis, in one replay.
  * ``epoch_engine(train_step)`` — the same, but the batches are gathered on
    the device from resident column buffers (``{"x": (n, d), "y": (n,)}``)
    by a ``(S, batch)`` block of the epoch's permuted plan indices, with the
    plan weights injected under ``weight_key`` (see
    ``Pipeline.device_epoch``).

A captured segment holds, per step: the gather, the weight injection, the
step's forward, ``torch.autograd.grad`` and in-place update, and ``step +=
1`` on the device; each step's metrics are written into a static ``(S,)``
buffer.  A graph reads and writes fixed addresses, so it owns a static copy
of the state and of the index/weight block: a call copies the caller's
state in, replays, and copies the result back into the caller's tensors.

**What the caller holds after a call.** The caller's state tensors hold the
updated state in place: this is the port's form of donation, and the state
returned is the caller's own object (on the CPU, whatever the step returns,
which for an in-place step such as the session's is the same tensors).  The
buffers, indices and weights are read, never written.  The stacked metrics
are a fresh tensor per call, so a consumer may read them after the next
call has been issued.  The engine's static copies are scratch.

Graphs are cached per (step function, weight key, S, batch, state shapes):
a Hyperband sweep over ``hidden ∈ {32, 64, 128}`` captures one graph per
(width, segment shape) and replays it in every later trial.  A graph reads
the resident buffers in place, so an engine keeps the graphs of one buffer
set: buffers other than the cached graphs' drop those graphs.

On the CPU (the device of the index block) the same ops run as an eager
loop over the ``S`` steps.  On the card nothing falls back: a failed capture
or replay raises.  The divergence guard is not ported (ROADMAP A9b).
"""
from __future__ import annotations

import functools
import weakref
from typing import Any, Callable

import torch

TrainStep = Callable[[Any, dict], tuple[Any, dict]]

#: CUDA graphs captured and replayed by every engine in this process
captures = 0
replays = 0


def _refuse_guard(guard: Any) -> None:
    if guard is not None:
        raise NotImplementedError(
            "the in-step divergence guard is not ported yet (ROADMAP A9b)")


def _leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in _leaves(v)]
    raise TypeError(f"a captured state holds tensors only, not {type(tree).__name__}")


def _map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    raise TypeError(f"a captured state holds tensors only, not {type(tree).__name__}")


def _signature(tree: Any) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in _leaves(tree))


def _steps(step: TrainStep, state: Any, batches: list[dict]) -> tuple[Any, dict]:
    """Run ``step`` over ``batches``; metrics stacked along a leading axis."""
    stacked: dict[str, list] = {}
    for batch in batches:
        state, metrics = step(state, batch)
        for k, v in metrics.items():
            stacked.setdefault(k, []).append(v)
    return state, {k: torch.stack(v) for k, v in stacked.items()}


def _superstep_body(step: TrainStep, state: Any, inputs: dict, buffers: dict):
    n = next(iter(inputs.values())).shape[0]
    return _steps(step, state, [{k: v[t] for k, v in inputs.items()} for t in range(n)])


def _epoch_body(step: TrainStep, weight_key: str | None, state: Any, inputs: dict,
                buffers: dict):
    idx, w = inputs["idx"], inputs["w"]
    batches = []
    for t in range(idx.shape[0]):
        batch = {k: buf[idx[t]] for k, buf in buffers.items()}
        if weight_key and weight_key not in batch:
            batch[weight_key] = w[t]
        batches.append(batch)
    return _steps(step, state, batches)


def _clear_cublas_workspaces() -> None:
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()


class _Graph:
    """One captured segment over a static copy of the state and inputs."""

    def __init__(self, body: Callable, state: Any, inputs: dict, buffers: dict):
        global captures
        self.state = _map(lambda t: t.detach().clone(), state)
        self.inputs = {k: v.clone() for k, v in inputs.items()}
        self.buffers = buffers  # read in place by every replay: kept alive here
        # warm-up on a side stream (library handles, autograd, the allocator),
        # then the capture; both run on the static copies only
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body(self.state, self.inputs, buffers)
        torch.cuda.current_stream().wait_stream(side)
        # cuBLAS keeps a workspace per stream it ran on for the life of the
        # process.  Dropping them before and after the capture (as torch's
        # own graph trees do) puts the workspace the graph uses in its
        # private pool, freed with the graph, and leaves none behind for the
        # warm-up's and the capture's streams
        _clear_cublas_workspaces()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out, self.metrics = body(self.state, self.inputs, buffers)
        _clear_cublas_workspaces()
        captures += 1

    def __call__(self, state: Any, inputs: dict) -> tuple[Any, dict]:
        global replays
        with torch.no_grad():
            for dst, src in zip(_leaves(self.state), _leaves(state)):
                dst.copy_(src)
            for k, v in inputs.items():
                self.inputs[k].copy_(v)
            self.graph.replay()
            for dst, src in zip(_leaves(state), _leaves(self.out)):
                dst.copy_(src)
        replays += 1
        return state, {k: v.clone() for k, v in self.metrics.items()}


def make_superstep(train_step: TrainStep, *, guard: Any = None):
    """Fuse a stack of pre-assembled batches into one segment.

    Returns ``superstep(state, batches) -> (state, stacked_metrics)`` where
    every tensor of ``batches`` carries a leading step axis ``(S, ...)``; on
    the card one graph per (batch shapes, state shapes), updating the
    caller's state in place (see the module docstring).
    """
    _refuse_guard(guard)
    graphs: dict[tuple, _Graph] = {}
    body = functools.partial(_superstep_body, train_step)

    def superstep(state: Any, batches: dict) -> tuple[Any, dict]:
        if next(iter(batches.values())).device.type != "cuda":
            return body(state, batches, {})
        key = (tuple((k, tuple(v.shape), v.dtype) for k, v in batches.items()),
               _signature(state))
        graph = graphs.get(key)
        if graph is None:
            graph = graphs[key] = _Graph(body, state, batches, {})
        return graph(state, batches)

    return superstep


class _EpochEngine:
    """``engine(state, buffers, idx, w) -> (state, stacked_metrics)``."""

    def __init__(self, train_step: TrainStep, weight_key: str | None):
        # weak: the engine is the cache's value and must not keep its key alive
        self._step = weakref.ref(train_step)
        self.weight_key = weight_key
        self.graphs: dict[tuple, _Graph] = {}
        self._buffers: dict | None = None

    def __call__(self, state: Any, buffers: dict, idx: torch.Tensor,
                 w: torch.Tensor) -> tuple[Any, dict]:
        step = self._step()
        assert step is not None, "train_step was garbage-collected"
        body = functools.partial(_epoch_body, step, self.weight_key)
        inputs = {"idx": idx, "w": w}
        if idx.device.type != "cuda":
            return body(state, inputs, buffers)
        if self._buffers is None or self._buffers.keys() != buffers.keys() or any(
                self._buffers[k] is not buffers[k] for k in buffers):
            self.graphs.clear()
            self._buffers = dict(buffers)
        key = (tuple(idx.shape), _signature(state))
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = _Graph(body, state, inputs, self._buffers)
        return graph(state, inputs)


#: train_step -> {weight_key: engine}; weakly keyed so per-instance steps do
#: not pin their engines (and their graphs) for the life of the process
_ENGINE_CACHE: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def epoch_engine(train_step: TrainStep, *, weight_key: str | None = "weights",
                 guard: Any = None) -> _EpochEngine:
    """Superstep over device-resident data, shared per (step, weight key).

    * ``buffers`` — dict of resident column tensors (``{"x": (n, d), "y":
      (n,)}``), placed once per training run and never written,
    * ``idx`` — ``(S, batch)`` int64 plan indices in visit order,
    * ``w``  — ``(S, batch)`` float32 plan weights aligned with ``idx``.

    Each step gathers its batch from the buffers (``{k: buf[idx[t]]}``),
    injects ``w[t]`` under ``weight_key`` unless a buffer already claims
    that column (the host pipeline's "don't clobber" rule), and applies
    ``train_step``.
    """
    _refuse_guard(guard)
    per_step = _ENGINE_CACHE.setdefault(train_step, {})
    engine = per_step.get(weight_key)
    if engine is None:
        engine = per_step[weight_key] = _EpochEngine(train_step, weight_key)
    return engine


def segment_length(superstep: int, global_step: int, remaining: int,
                   checkpoint_every: int) -> int:
    """Steps the next superstep may fuse without skipping a boundary.

    A segment ends at whichever comes first: the superstep size, the end of
    the epoch, or the next ``checkpoint_every`` multiple (checkpoints need
    the actual state, which only exists between segments; the port's
    trainer passes 0 until checkpoints land, ROADMAP A10).  Logging needs
    no boundary — per-step metrics come back stacked.
    """
    if superstep < 1:
        raise ValueError(f"superstep must be >= 1, got {superstep}")
    seg = min(superstep, remaining)
    if checkpoint_every:
        seg = min(seg, checkpoint_every - global_step % checkpoint_every)
    return seg
