"""The port's health layer against ``repro.health`` on the CPU, mirroring
``tests/test_health.py``: the input firewall (every policy on every planted
anomaly, ``repair`` bit for bit, quarantined artifacts remapped to the full
ground set with the reference's SGE and WRE draws injected), the session's
firewall refusal, the circuit breaker under one injected clock, and the
selector fallback chains — whose one departure from the reference is that
an error of the kernel layer propagates instead of degrading.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.health as JH
import repro.selection as jsel
from repro.core.metadata import MetadataMismatchError as JMismatch
from repro.core.milo import MiloPreprocessor as JPre
from repro.core.partition import ByClass, proportional_budgets
from repro.selection.plan import uniform_plan as j_uniform_plan
import repro_torch.health as TH
import repro_torch.selection as tsel
from repro_torch.core.metadata import MetadataMismatchError
from repro_torch.core.milo import MiloPreprocessor as TPre
from repro_torch.health.firewall import MAX_RECORDED_INDICES
from repro_torch.kernels import _build
from repro_torch.kernels.similarity import similarity as sim_kernel
from repro_torch.selection.plan import uniform_plan as t_uniform_plan
from repro_torch.testing.faults import poison_features

torch.set_num_threads(1)


def _dataset(n=60, d=6, c=3, seed=0):
    rng = np.random.default_rng(seed)
    labs = rng.integers(0, c, n).astype(np.int64)
    feats = (rng.normal(size=(n, d)) + 0.5 * labs[:, None]).astype(np.float32)
    return feats, labs


def _next_pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


def reference_sge_noise(labels, *, subset_fraction, n_subsets, seed):
    """The reference's per-class SGE draws for ``preprocess(..., PRNGKey(seed))``
    in its bucketed geometry (as ``tests/test_torch_slice.py``)."""
    parts = ByClass().partition(labels, len(labels))
    budgets = proportional_budgets(parts, max(1, round(subset_fraction * len(labels))))
    key = jax.random.PRNGKey(seed)
    noise = []
    for part, k_c in zip(parts, budgets):
        key, k_sge = jax.random.split(key)
        n_run = _next_pow2(len(part.indices))
        k_run = min(n_run, _next_pow2(k_c))

        def run(kk, k_run=k_run, n_run=n_run):
            return jax.vmap(lambda kt: jax.random.gumbel(kt, (n_run,)))(jax.random.split(kk, k_run))

        noise.append(np.asarray(jax.vmap(run)(jax.random.split(k_sge, n_subsets))))
    return noise


def reference_wre_noise(seed, m):
    return lambda window: np.asarray(
        jax.random.gumbel(jax.random.fold_in(jax.random.PRNGKey(seed), window), (m,)))


# ---------------------------------------------------------------------------
# input firewall: detection, policies, provenance — against the reference
# ---------------------------------------------------------------------------

def _anomalies():
    feats, labs = _dataset()
    dup = feats.copy()
    dup[10] = dup[4]
    const = feats.copy()
    const[:, 2] = 1.5
    gap = np.where(np.arange(60) % 2 == 0, 0, 2).astype(np.int64)
    single = np.zeros(60, np.int64)
    single[-1] = 1
    return {
        "clean": (feats, labs, None),
        "nan_row": (poison_features(feats, nan_rows=[3]), labs, None),
        "inf_row": (poison_features(feats, inf_rows=[7]), labs, None),
        "zero_row": (poison_features(feats, zero_rows=[11]), labs, None),
        "mixed_rows": (poison_features(feats, nan_rows=[3, 40], inf_rows=[7],
                                       zero_rows=[11, 59]), labs, 0.2),
        "many_nan": (poison_features(feats, nan_rows=range(45)), None, None),
        "duplicate_row": (dup, labs, None),
        "constant_feature": (const, labs, None),
        "empty_class": (feats, gap, 0.3),
        "singleton_class": (feats, single, 0.3),
        "overbudget_class": (feats, single, 0.95),
    }


@pytest.mark.parametrize("policy", [None, "raise", "repair", "quarantine"])
@pytest.mark.parametrize("case", sorted(_anomalies()))
def test_firewall_report_matches_reference(policy, case):
    feats, labs, frac = _anomalies()[case]
    kw = dict(policy=policy, subset_fraction=frac)
    try:
        out_j, rep_j = JH.validate_features(feats, labs, **kw)
    except JH.DataHealthError as e:
        with pytest.raises(TH.DataHealthError) as ei:
            TH.validate_features(feats, labs, **kw)
        assert str(ei.value) == str(e)
        return
    out_t, rep_t = TH.validate_features(feats, labs, **kw)
    assert rep_t.to_dict() == rep_j.to_dict()
    assert rep_t.summary() == rep_j.summary()
    assert rep_t.bad_rows == rep_j.bad_rows and rep_t.clean == rep_j.clean
    # repair bit for bit; every other policy hands the input back untouched
    assert out_t.dtype == out_j.dtype
    np.testing.assert_array_equal(out_t, out_j)
    if policy != "repair" or not rep_t.bad_rows:
        assert out_t is feats


def test_firewall_repair_is_deterministic_and_total():
    feats, _ = _dataset()
    bad = poison_features(feats, nan_rows=[2, 9], zero_rows=[5])
    out1, rep1 = TH.validate_features(bad, policy="repair")
    out2, _ = TH.validate_features(bad, policy="repair")
    np.testing.assert_array_equal(out1, out2)
    assert rep1.repaired_rows == [2, 5, 9]
    e2 = np.zeros(feats.shape[1], bad.dtype)
    e2[2 % feats.shape[1]] = 1.0
    np.testing.assert_array_equal(out1[2], e2)
    keep = np.setdiff1d(np.arange(len(bad)), [2, 5, 9])
    np.testing.assert_array_equal(out1[keep], bad[keep])


def test_firewall_to_dict_truncates_examples_but_keeps_full_quarantine():
    feats, _ = _dataset(n=120)
    _, rep = TH.validate_features(poison_features(feats, nan_rows=range(50)),
                                  policy="quarantine")
    d = rep.to_dict()
    assert d["nonfinite_rows"]["count"] == 50
    assert len(d["nonfinite_rows"]["indices"]) == MAX_RECORDED_INDICES
    assert d["quarantined_rows"] == list(range(50))


def test_firewall_input_validation_matches_reference():
    feats, labs = _dataset()
    for args, kw in (((feats,), dict(policy="explode")), ((feats.ravel(),), {}),
                     ((feats, labs[:-1]), {})):
        with pytest.raises(ValueError) as ej:
            JH.validate_features(*args, **kw)
        with pytest.raises(ValueError) as et:
            TH.validate_features(*args, **kw)
        assert str(et.value) == str(ej.value)
    with pytest.raises(TypeError, match="floating"):
        poison_features(labs, nan_rows=[0])


# ---------------------------------------------------------------------------
# the firewall in preprocessing: quarantined artifacts against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gram_free", [False, True])
def test_quarantine_preprocess_matches_reference(gram_free):
    feats, labs = _dataset(n=80)
    bad = poison_features(feats, nan_rows=[5], zero_rows=[17, 40])
    kw = dict(subset_fraction=0.25, n_sge_subsets=2, gram_free=gram_free,
              firewall="quarantine")
    md_j = JPre(**kw).preprocess(bad, labs, jax.random.PRNGKey(0), prep_seed=0)
    keep = np.setdiff1d(np.arange(80), [5, 17, 40])
    noise = reference_sge_noise(labs[keep], subset_fraction=0.25, n_subsets=2, seed=0)
    md_t = TPre(**kw, device="cpu").preprocess(bad, labs, 0, prep_seed=0, sge_noise=noise)
    assert md_t.config == md_j.config
    assert md_t.config_hash() == md_j.config_hash()
    assert md_t.config["data_health"]["quarantined_rows"] == [5, 17, 40]
    np.testing.assert_array_equal(md_t.sge_subsets, md_j.sge_subsets)
    np.testing.assert_array_equal(md_t.class_labels, md_j.class_labels)
    np.testing.assert_array_equal(md_t.class_budgets, md_j.class_budgets)
    np.testing.assert_allclose(md_t.wre_importance, md_j.wre_importance, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(md_t.wre_probs, md_j.wre_probs, rtol=1e-5, atol=1e-9)
    for q in (5, 17, 40):
        assert md_t.wre_probs[q] == 0.0 and md_t.wre_importance[q] == 0.0
        assert not np.any(md_t.sge_subsets == q)
    # the curriculum over the remapped artifact: the reference's plans, WRE
    # draws injected
    js = jsel.MiloSession(total_epochs=6, subset_fraction=0.25, n_sge_subsets=2)
    js.adopt_metadata(md_j)
    ts = tsel.MiloSession(total_epochs=6, subset_fraction=0.25, n_sge_subsets=2, device="cpu")
    ts.adopt_metadata(md_t)
    sel_j = js.selector("milo", n=80)
    sel_t = ts.selector("milo", n=80, wre_noise=reference_wre_noise(0, 80))
    for epoch in range(6):
        pj, pt = sel_j.plan(epoch), sel_t.plan(epoch)
        np.testing.assert_array_equal(pt.indices, pj.indices)
        assert not set(pt.indices.tolist()) & {5, 17, 40}


def test_preprocess_firewall_raise_and_clean_paths():
    feats, labs = _dataset()
    pre = TPre(subset_fraction=0.2, n_sge_subsets=2, firewall="raise", device="cpu")
    with pytest.raises(TH.DataHealthError):
        pre.preprocess(poison_features(feats, nan_rows=[0]), labs, 0)
    md = TPre(subset_fraction=0.2, n_sge_subsets=2, device="cpu").preprocess(feats, labs, 0)
    assert "firewall" not in md.config and "data_health" not in md.config
    md2 = pre.preprocess(feats, labs, 0)
    assert md2.config["firewall"] == "raise" and md2.config["data_health"]["clean"]
    np.testing.assert_array_equal(md.sge_subsets, md2.sge_subsets)


def test_session_refuses_an_artifact_of_another_firewall(tmp_path):
    feats, labs = _dataset(n=80)
    path = str(tmp_path / "milo.npz")
    base = dict(subset_fraction=0.2, n_sge_subsets=2, metadata_path=path)
    tsel.MiloSession(tsel.MiloSessionConfig(firewall="repair", **base),
                     device="cpu").preprocess(feats, labs)
    with pytest.raises(MetadataMismatchError, match="firewall"):
        tsel.MiloSession(tsel.MiloSessionConfig(firewall=None, **base),
                         device="cpu").preprocess(feats, labs)
    md = tsel.MiloSession(tsel.MiloSessionConfig(firewall="repair", **base),
                          device="cpu").preprocess(feats, labs)
    assert md.config["firewall"] == "repair"
    # the reference refuses the port's artifact the same way
    with pytest.raises(JMismatch, match="firewall"):
        jsel.MiloSession(jsel.MiloSessionConfig(firewall="quarantine", **base)).preprocess(
            feats, labs)


# ---------------------------------------------------------------------------
# circuit breaker: one script, one injected clock, both packages
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


_SCRIPT = [("check", "k"), ("fail", "k"), ("check", "k"), ("fail", "k"), ("state", "k"),
           ("check", "k"), ("tick", 5.0), ("check", "k"), ("tick", 5.0), ("state", "k"),
           ("check", "k"), ("check", "k"), ("fail", "k"), ("state", "k"), ("tick", 10.0),
           ("check", "k"), ("ok", "k"), ("state", "k"), ("check", "j"), ("fail", "j"),
           ("snapshot", None), ("fail", "k"), ("ok", "k"), ("fail", "k"), ("state", "k"),
           ("snapshot", None)]


def _drive(mod, threshold, cooldown):
    clk = _Clock()
    br = mod.CircuitBreaker(threshold=threshold, cooldown=cooldown, clock=clk)
    out = []
    for op, arg in _SCRIPT:
        if op == "tick":
            clk.t += arg
        elif op == "check":
            try:
                br.check(arg)
                out.append("pass")
            except mod.CircuitOpenError as e:
                out.append(("open", str(e)))
        elif op == "fail":
            br.record_failure(arg)
        elif op == "ok":
            br.record_success(arg)
        elif op == "state":
            out.append(br.state(arg))
        else:
            out.append(br.snapshot())
    return out


@pytest.mark.parametrize("threshold,cooldown", [(2, 10.0), (1, 3.0), (3, 7.5)])
def test_breaker_state_sequence_matches_reference(threshold, cooldown):
    assert _drive(TH, threshold, cooldown) == _drive(JH, threshold, cooldown)


def test_breaker_validates_threshold():
    with pytest.raises(ValueError, match="threshold"):
        TH.CircuitBreaker(threshold=0)


# ---------------------------------------------------------------------------
# fallback chains
# ---------------------------------------------------------------------------

class _Stub:
    def __init__(self, uniform_plan, weights=None, exc=None):
        self.uniform_plan, self.weights, self.exc = uniform_plan, weights, exc
        self.resets = 0

    def plan(self, epoch):
        if self.exc is not None:
            raise self.exc
        return dataclasses.replace(self.uniform_plan(np.arange(4), "adaptive", epoch),
                                   weights=np.asarray(self.weights, np.float64))

    def reset_cache(self):
        self.resets += 1


def _chains(mod, uniform_plan, mismatch):
    def stub(**kw):
        return lambda: _Stub(uniform_plan, **kw)

    def broken():
        raise ValueError("cannot build")

    ones = [1.0] * 4
    return {
        "degenerate_primary": [("milo", stub(exc=mod.SelectionDegenerateError("empty"))),
                               ("adaptive_random", stub(weights=ones))],
        "build_then_nonfinite": [("milo", broken),
                                 ("el2n", stub(weights=[1.0, np.nan, 1.0, 1.0])),
                                 ("adaptive_random", stub(weights=ones))],
        "zero_division": [("a", stub(exc=ZeroDivisionError("0"))), ("b", stub(weights=ones))],
        "healthy": [("milo", stub(weights=ones)), ("adaptive_random", stub(weights=ones))],
        "exhausted": [("a", stub(exc=ValueError("x")))],
        "mismatch": [("a", stub(exc=mismatch("wrong"))), ("b", stub(weights=ones))],
    }


def _walk(mod, uniform_plan, mismatch, name):
    fb = mod.FallbackSelector(_chains(mod, uniform_plan, mismatch)[name])
    out = []
    for epoch in (0, 1):
        try:
            plan = fb.plan(epoch)
        except Exception as e:  # noqa: BLE001 — compared by type and text
            out.append((type(e).__name__, str(e)))
            break
        out.append((fb.active_name, plan.indices.tolist(), plan.weights.tolist(),
                    dict(plan.provenance)))
    return out, fb.events


@pytest.mark.parametrize("name", sorted(_chains(TH, t_uniform_plan, MetadataMismatchError)))
def test_fallback_events_and_provenance_match_reference(name):
    t = _walk(TH, t_uniform_plan, MetadataMismatchError, name)
    j = _walk(JH, j_uniform_plan, JMismatch, name)
    assert t == j


def test_fallback_reset_and_empty_chain():
    good = _Stub(t_uniform_plan, weights=[1.0] * 4)
    fb = TH.FallbackSelector([("milo", lambda: _Stub(t_uniform_plan, exc=ValueError("x"))),
                              ("adaptive_random", lambda: good)])
    fb.plan(0)
    fb.reset_cache()
    assert good.resets == 1
    with pytest.raises(ValueError, match="at least one"):
        TH.FallbackSelector([])


def _refused_launch():
    """A kernel wrapper's refusal: B1's wrapper handed rows off the card."""
    z = torch.zeros((4, 8))
    sim_kernel.similarity_cuda(z, z)


@pytest.mark.parametrize("stage", ["build", "plan"])
@pytest.mark.parametrize("fault", ["refusal", "launch", "cuda_runtime"])
def test_kernel_errors_propagate_through_the_fallback(stage, fault):
    """A fault of the kernel layer is never degraded around: the chain would
    otherwise hide a kernel that never ran behind a healthy-looking plan."""
    def boom():
        if fault == "refusal":
            _refused_launch()
        elif fault == "launch":
            raise _build.KernelError("similarity kernel launch: CUDA error 700")
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    primary = (boom if stage == "build"
               else lambda: type("S", (), {"plan": lambda self, e: boom()})())
    fb = TH.FallbackSelector([("milo", primary),
                              ("adaptive_random", lambda: _Stub(t_uniform_plan, weights=[1.0] * 4))])
    with pytest.raises(RuntimeError) as ei:
        fb.plan(0)
    assert _build.is_kernel_fault(ei.value)
    assert fb.events == [] and fb.active_name == "milo"
    if fault == "refusal":
        assert isinstance(ei.value, _build.KernelInputError)
        assert isinstance(ei.value, ValueError)   # still a ValueError for callers


def test_session_selector_fallback_chain_matches_reference():
    """A session with a declared chain degrades a failing primary
    (``milo_fixed`` without features: a build-time ValueError) to
    ``adaptive_random`` with the hop in the plan's provenance — the
    reference's plan, index for index."""
    kw = dict(selector="milo_fixed", subset_fraction=0.25,
              selector_fallback=("adaptive_random",))
    sel_t = tsel.MiloSession(tsel.MiloSessionConfig(**kw), device="cpu").selector(n=64)
    sel_j = jsel.MiloSession(jsel.MiloSessionConfig(**kw)).selector(n=64)
    for epoch in (0, 1, 2):
        pt, pj = sel_t.plan(epoch).validate(64), sel_j.plan(epoch)
        np.testing.assert_array_equal(pt.indices, pj.indices)
        assert dict(pt.provenance) == dict(pj.provenance)
    assert sel_t.active_name == "adaptive_random"
    assert pt.provenance["fallback_from"] == "milo_fixed"
    assert pt.provenance["fallback_events"][0]["stage"] == "build"
    bare = tsel.MiloSessionConfig(selector="milo_fixed", subset_fraction=0.25)
    with pytest.raises(ValueError, match="features"):
        tsel.MiloSession(bare, device="cpu").selector(n=64)


def test_session_fallback_trains_on_the_degraded_plan():
    feats, labs = _dataset(n=64, d=6)
    s = tsel.MiloSession(selector="milo_fixed", subset_fraction=0.25, total_epochs=2,
                         selector_fallback=("adaptive_random",), device="cpu")
    rep = s.train(feats, labs, test_x=feats, test_y=labs)
    assert rep.steps == 2 and np.isfinite(rep.final_acc)
