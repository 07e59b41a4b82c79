"""Driver of the ``select`` traffic: MILO's one-time preprocess, as users run
it, one whole ``MiloSession.preprocess(features, labels, force=True)`` a
unit, on features handed over in host memory.

Set-up makes the features from the seed, starts the card and warms the
class geometry through the program's own ``MiloPreprocessor.warmup``.  The
window starts units while less than ``seconds`` have passed and ends when
the last one ends; unit ``u`` preprocesses with the seed ``seed + u``.
After the window one unit, drawn from the seed, is judged against the plain
reference (``bench/reference/selection.py``).

With ``trace``: spans around the Gram, the SGE bank and the WRE pass of
every class (``core.milo``'s calls of ``gram_matrix_blocked``, ``run_sge``
and ``greedy_importance``), spans around the kernel entry points, and the
profiler over the first ``profile_classes`` classes of the first unit.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench import data, trace as tr
from bench.counts import kernels as kc
from bench.reference import selection as ref


def session_knobs(traffic: dict) -> dict:
    return dict(traffic["session"])


def judge_spec(knobs: dict) -> dict:
    """The preprocess parameters the reference needs, with the program's
    defaults where the traffic leaves one out."""
    from repro_torch.selection.session import MiloSessionConfig

    cfg = MiloSessionConfig(**knobs)
    return {k: getattr(cfg, k) for k in ("subset_fraction", "n_sge_subsets", "eps",
                                         "graph_cut_lambda", "easy_fn", "hard_fn")}


def make_inputs(config: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    d = config["data"]
    return data.gaussian_mixture(d["n_train"], d["n_classes"], d["feature_dim"], seed)


class Recorder:
    """What the greedy engines returned for each class of the current unit:
    the SGE bank's picks and gains (``greedy._stochastic_bank``) and the WRE
    pass's order (``greedy.greedy`` / ``greedy.lazy_greedy``).  Holds the
    device tensors; nothing is read back until the unit is judged."""

    def __init__(self):
        self.units: list[list[dict]] = []
        self.active = False
        self._undo: list = []

    def install(self) -> None:
        from repro_torch.core import greedy as g

        def bank(inner):
            def wrapped(*a, **kw):
                res = inner(*a, **kw)
                if self.active:
                    self.units[-1].append({"sge_idx": res.indices, "sge_gain": res.gains})
                return res
            return wrapped

        def full(inner):
            def wrapped(*a, **kw):
                res = inner(*a, **kw)
                if self.active:
                    cls = self.units[-1][-1] if self.units[-1] else None
                    if cls is None or "wre_idx" in cls:
                        cls = {}
                        self.units[-1].append(cls)
                    cls["wre_idx"] = res.indices
                return res
            return wrapped

        tr.patch(g, "_stochastic_bank", bank, self._undo)
        tr.patch(g, "greedy", full, self._undo)
        tr.patch(g, "lazy_greedy", full, self._undo)

    def begin_unit(self) -> None:
        self.units.append([])
        self.active = True

    def end_unit(self) -> None:
        self.active = False

    def host_record(self, u: int) -> list[dict]:
        return [{k: v.cpu().numpy() for k, v in cls.items()} for cls in self.units[u]]

    def remove(self) -> None:
        tr.unpatch(self._undo)


def run_unit(features, labels, knobs: dict, prep_seed: int, device):
    from repro_torch.selection.session import MiloSession, MiloSessionConfig

    cfg = MiloSessionConfig(**knobs, seed=prep_seed, prep_seed=prep_seed)
    md = MiloSession(cfg, device=device).preprocess(features, labels, force=True)
    return {"sge_subsets": md.sge_subsets, "wre_importance": md.wre_importance,
            "wre_probs": md.wre_probs}


def warm(features, labels, knobs: dict, device) -> None:
    """The program's own warm-up of every class geometry the units use."""
    from repro_torch.selection.session import MiloSessionConfig

    parts = ref.partition(labels)
    k = max(1, int(round(judge_spec(knobs)["subset_fraction"] * len(labels))))
    buckets = list(zip([len(p) for p in parts], ref.budgets([len(p) for p in parts], k)))
    MiloSessionConfig(**knobs).preprocessor(device).warmup(buckets, features.shape[1])
    tr.fence(device)


class _KernelCalls:
    """Shapes of each kernel call made while the profiler runs (B2's and
    B3's covers are kept to count their finite rows afterwards)."""

    def __init__(self, profile: tr.Profile):
        self.profile = profile
        self.calls: dict[str, list] = {"b1": [], "b2": [], "b3": []}

    def b1(self, args, kwargs):
        if self.profile.active:
            zq, zk = args[0], args[1]
            self.calls["b1"].append((zq.shape[0], zk.shape[0], zq.shape[1]))

    def b2(self, args, kwargs):
        if self.profile.active:
            z, zc, c = args[0], args[1], args[2]
            batch = c.shape[0] if c.dim() == 2 else 1
            self.calls["b2"].append((c, z.shape[0], zc.shape[-2], z.shape[1], batch))

    def b3(self, args, kwargs):
        if self.profile.active:
            z, zc, c_new = args[0], args[1], args[3]
            self.calls["b3"].append((c_new, z.shape[0], zc.shape[0], z.shape[1]))

    def bounds(self) -> dict[str, float]:
        out = {}
        if self.calls["b1"]:
            out["b1"] = sum(kc.bound_s(*kc.b1(*c)) for c in self.calls["b1"])
        if self.calls["b2"]:
            out["b2"] = sum(kc.bound_s(*kc.b2(int(torch.isfinite(c).sum()) // batch, n, nc, d, batch))
                            for c, n, nc, d, batch in self.calls["b2"])
        if self.calls["b3"]:
            out["b3"] = sum(kc.bound_s(*kc.b3(int(torch.isfinite(c).sum()), b, nc, d))
                            for c, b, nc, d in self.calls["b3"])
        return out


def run(config: dict, traffic: dict, *, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """Set-up, the window and the judged unit; returns the driver's result
    (see ``bench/run.py``)."""
    knobs = session_knobs(traffic)
    features, labels = make_inputs(config, seed)
    rows = len(labels)
    warm(features, labels, knobs, device)
    rec = Recorder()
    rec.install()
    if trace:
        from repro_torch.core import milo
        from repro_torch.kernels.fl_gains import ops as fl_ops
        from repro_torch.kernels.similarity import ops as sim_ops

        spans = tr.Spans(sync=True, device=device)
        prof = tr.Profile(device)
        calls = _KernelCalls(prof)
        n_prof = int(traffic.get("profile_classes", 2))
        span_class: list[bool] = []   # per finished class: was it profiled

        def class_done(_out, _dt):
            span_class.append(prof.active)
            if prof.active and len(span_class) >= n_prof:
                prof.stop()

        spans.wrap(milo, "gram_matrix_blocked", "gram")
        spans.wrap(milo, "run_sge", "sge")
        spans.wrap(milo, "greedy_importance", "wre", after=class_done)
        # kernel spans only mark the launches for the profiler: no fence
        kspans = tr.Spans(sync=False, device=device)
        kspans.wrap(sim_ops, "similarity", "k.b1", before=calls.b1)
        kspans.wrap(fl_ops, "fl_gains_gram_free", "k.b2", before=calls.b2)
        kspans.wrap(fl_ops, "fl_gains_gram_free_delta", "k.b3", before=calls.b3)
    tr.fence(device)
    setup_s = time.perf_counter() - t_start

    artifacts, ends = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        u = len(artifacts)
        rec.begin_unit()
        if trace and u == 0:
            prof.start()
        artifacts.append(run_unit(features, labels, knobs, seed + u, device))
        rec.end_unit()
        ends.append(time.perf_counter() - t0)
    window_s = ends[-1]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec.remove()

    out = {
        "attempted": len(artifacts),
        "end_to_end": {"select_rows_per_s": rows * len(artifacts) / window_s,
                       "setup_s": setup_s},
        "memory_peak_bytes": peak,
        "unit_s": [b - a for a, b in zip([0.0] + ends, ends)],
    }
    if trace:
        spans.restore()
        kspans.restore()
        if prof.active:
            prof.stop()
        red = tr.reduce_events(*prof.events(), window_s=prof.window_s)
        n_prof_classes = sum(span_class)
        free = [not p for p in span_class]

        def unprofiled(name):
            # the spans of classes outside the profiler, in class order
            ts = spans.times.get(name, [])
            return [t for t, f in zip(ts, free) if f] if len(ts) == len(free) else []

        out["trace"] = {
            "span_ms": {n: [1e3 * t for t in unprofiled(n)] for n in ("gram", "sge", "wre")},
            "classes_profiled": n_prof_classes,
            "kernel_bound_s": calls.bounds(),
            "kernel_s": {k[2:]: v for k, v in red["device_s_by_span"].items() if k.startswith("k.")},
            **{k: red[k] for k in ("busy_s", "window_s", "device_ops", "breakdown")},
        }
    # judge one unit drawn from the seed, after the window
    u = int(np.random.default_rng(seed).integers(len(artifacts)))
    numbers = ref.judge(features, labels,
                        {"artifact": artifacts[u], "classes": rec.host_record(u)},
                        judge_spec(knobs), seed + u, device)
    out["numbers"] = numbers
    out["failed"] = int(numbers["faults"] > 0)
    return out


def control(config: dict, traffic: dict, *, seed: int, device) -> dict:
    """The control: the plain preprocess in float32 on TF32-rounded products
    in the program's place, judged as a unit is."""
    knobs = session_knobs(traffic)
    features, labels = make_inputs(config, seed)
    spec = judge_spec(knobs)
    run_ = ref.plain_preprocess(features, labels, spec, seed, device)
    return ref.judge(features, labels, run_, spec, seed, device)


def program_unit(config: dict, traffic: dict, *, seed: int, device) -> dict:
    """One unit of the program at the cell's size, judged (the readings the
    limits are set from)."""
    knobs = session_knobs(traffic)
    features, labels = make_inputs(config, seed)
    rec = Recorder()
    rec.install()
    rec.begin_unit()
    try:
        art = run_unit(features, labels, knobs, seed, device)
    finally:
        rec.end_unit()
        rec.remove()
    return ref.judge(features, labels, {"artifact": art, "classes": rec.host_record(0)},
                     judge_spec(knobs), seed, device)
