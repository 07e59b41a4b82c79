"""The paper's baselines on PyTorch (``repro_torch.baselines``, the registry's
el2n, selfsup_prune, craig_pb, gradmatch_pb and glister) against the
reference, on the CPU, on the fixtures of ``tests/test_selection.py`` and
``tests/test_training_integration.py``.

Tolerances: CRAIG, GLISTER and EL2N index-exact (CRAIG's weights equal);
GRAD-MATCH index-exact with its OMP coefficients at rtol 1e-10 (float64 on
both sides); self-supervised pruning index-exact, or differing only in rows
whose distance lies within rtol 1e-5 of the k-th; registry plans equal over
epochs 0-5 (weights at rtol 1e-6).  Also: the session's windowed selection
cadence, CRAIG's weighted plans through the fused engine against the step
loop bit for bit, and a finished session releasing its fused engine.
"""
import gc
import importlib
import weakref

import jax
import numpy as np
import pytest
import torch

import repro.baselines.selectors as jbase
import repro.selection as jsel
import repro_torch.baselines.selectors as tbase
import repro_torch.selection as tsel
from repro_torch.data.pipeline import Pipeline
from repro_torch.models.classifier import params_from_jax
from repro_torch.train import engine as engine_mod
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

tsession = importlib.import_module("repro_torch.selection.session")

# tests/test_selection.py:26-65 and tests/test_training_integration.py:115-128
SELECTION = dict(n=120, k=24, dim=10)
INTEGRATION = dict(n=64, k=16, dim=8)


def _fixture(n, k, dim, *, grads_f32):
    feats = np.random.default_rng(0).normal(size=(n, dim)).astype(np.float32)
    g = np.random.default_rng(1).normal(size=(n, dim))
    gv = np.random.default_rng(2).normal(size=(dim,))
    if grads_f32:
        g, gv = g.astype(np.float32), gv.astype(np.float32)
    scores = np.random.default_rng(3).random(n)
    return dict(n=n, k=k, feats=feats, g=g, gv=gv, scores=scores)


FIXTURES = {
    "selection": _fixture(**SELECTION, grads_f32=False),
    "integration": _fixture(**INTEGRATION, grads_f32=True),
}


@pytest.fixture(params=sorted(FIXTURES))
def fx(request):
    return FIXTURES[request.param]


# ---------------------------------------------------------------------------
# the selection math
# ---------------------------------------------------------------------------

def test_craig_pb_select_matches_reference(fx):
    idx_j, w_j = jbase.craig_pb_select(fx["g"], fx["k"])
    idx_t, w_t = tbase.craig_pb_select(fx["g"], fx["k"], device="cpu")
    assert idx_t.dtype == np.int64 and w_t.dtype == np.float32
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(w_t, w_j)
    assert not np.allclose(w_t, 1.0)  # genuinely weighted


def test_craig_pb_select_routes_and_inputs_agree(fx, monkeypatch):
    """A tensor input gives the array's result, and the plain facility
    location the B4 route's (its plain version on the CPU), bit for bit."""
    from repro_torch.core.submodular import facility_location

    ref = tbase.craig_pb_select(fx["g"], fx["k"], device="cpu")
    tensor_in = tbase.craig_pb_select(torch.as_tensor(fx["g"]), fx["k"])
    monkeypatch.setattr(tbase, "make_facility_location_pallas", lambda: facility_location)
    for out in (tensor_in, tbase.craig_pb_select(fx["g"], fx["k"], device="cpu")):
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_array_equal(out[1], ref[1])


def test_gradmatch_omp_select_matches_reference(fx):
    idx_j, w_j = jbase.gradmatch_omp_select(fx["g"], fx["k"])
    idx_t, w_t = tbase.gradmatch_omp_select(fx["g"], fx["k"], device="cpu")
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_allclose(w_t, w_j, rtol=1e-10)


def test_gradmatch_coefficients_match_reference(fx, monkeypatch):
    """The raw OMP coefficients (before the float32 normalisation), by
    replaying the reference's loop in numpy float64."""
    g = np.asarray(fx["g"], np.float64)
    residual = g.mean(0)
    chosen, coefs = [], []
    for _ in range(fx["k"]):
        scores = g @ residual
        scores[chosen] = -np.inf
        j = int(np.argmax(scores))
        chosen.append(j)
        w = max(0.0, (g[j] @ residual) / ((g[j] @ g[j]) + 0.5))
        coefs.append(w)
        residual = residual - w * g[j]
    captured = {}
    orig = tbase._normalize_weights

    def spy(w):
        captured["w"] = np.asarray(w)
        return orig(w)

    monkeypatch.setattr(tbase, "_normalize_weights", spy)
    idx_t, _ = tbase.gradmatch_omp_select(fx["g"], fx["k"], device="cpu")
    np.testing.assert_array_equal(idx_t, chosen)
    assert captured["w"].dtype == np.float64
    np.testing.assert_allclose(captured["w"], coefs, rtol=1e-10)


def test_glister_select_matches_reference(fx):
    idx_j = jbase.glister_select(fx["g"], fx["gv"], fx["k"])
    idx_t = tbase.glister_select(fx["g"], fx["gv"], fx["k"], device="cpu")
    assert idx_t.dtype == np.int64
    np.testing.assert_array_equal(idx_t, idx_j)


@pytest.mark.parametrize("keep", ["hard", "easy"])
def test_el2n_selector_matches_reference(fx, keep):
    a = jbase.EL2NSelector(fx["scores"], fx["k"], keep=keep)
    b = tbase.EL2NSelector(fx["scores"], fx["k"], keep=keep)
    for e in range(3):
        np.testing.assert_array_equal(b.indices_for_epoch(e), a.indices_for_epoch(e))


def _reference_distances(z, n_prototypes, seed):
    """The reference's Lloyd iterations and distances, in numpy."""
    rng = np.random.default_rng(seed)
    protos = z[rng.choice(len(z), n_prototypes, replace=False)].copy()
    for _ in range(10):
        assign = ((z[:, None] - protos[None]) ** 2).sum(-1).argmin(1)
        for c in range(n_prototypes):
            if (assign == c).any():
                protos[c] = z[assign == c].mean(0)
    return ((z[:, None] - protos[None]) ** 2).sum(-1).min(1)


@pytest.mark.parametrize("n_prototypes", [4, 10])
def test_selfsup_prune_selector_matches_reference(fx, n_prototypes):
    a = jbase.SelfSupPruneSelector(fx["feats"], fx["k"], n_prototypes=n_prototypes)
    b = tbase.SelfSupPruneSelector(fx["feats"], fx["k"], n_prototypes=n_prototypes,
                                   device="cpu")
    ia, ib = a.indices_for_epoch(0), b.indices_for_epoch(0)
    if not np.array_equal(ia, ib):
        dist = _reference_distances(fx["feats"], n_prototypes, 0)
        kth = np.sort(dist)[-fx["k"]]
        differ = np.setxor1d(ia, ib)
        np.testing.assert_allclose(dist[differ], kth, rtol=1e-5)


def test_prototype_distances_keep_an_emptied_prototype():
    """A prototype no row is nearest to keeps its place (the reference's
    ``if m.any()``), and the distances are the (z − p)² form's."""
    z = torch.tensor([[0.0, 0.0], [0.1, 0.0], [10.0, 10.0]])
    protos = torch.tensor([[0.0, 0.0], [10.0, 10.0], [100.0, 100.0]])
    dist = tbase.prototype_distances(z, protos, iters=3)
    torch.testing.assert_close(dist, torch.tensor([0.0025, 0.0025, 0.0]))


def test_legacy_selectors_match_reference():
    """``test_training_integration.py``'s contract, each legacy class against
    the reference's for epochs 0-2."""
    f = FIXTURES["integration"]
    n, k = f["n"], f["k"]

    def pair(name, *args, **kw):
        dev = {} if name in ("RandomSelector", "AdaptiveRandomSelector", "EL2NSelector") \
            else {"device": "cpu"}
        return getattr(jbase, name)(*args, **kw), getattr(tbase, name)(*args, **kw, **dev)

    pairs = [
        pair("RandomSelector", n, k),
        pair("AdaptiveRandomSelector", n, k, R=2),
        pair("MiloFixedSelector", f["feats"], k),
        pair("EL2NSelector", f["scores"], k),
        pair("SelfSupPruneSelector", f["feats"], k, n_prototypes=4),
        pair("CraigPBSelector", lambda: f["g"], k, R=2),
        pair("GradMatchPBSelector", lambda: f["g"], k, R=2),
        pair("GlisterSelector", lambda: f["g"], lambda: f["gv"], k, R=2),
    ]
    for a, b in pairs:
        for e in (0, 1, 2):
            ib = np.asarray(b.indices_for_epoch(e))
            assert ib.shape == (k,) and len(set(ib.tolist())) == k, type(b).__name__
            np.testing.assert_array_equal(ib, a.indices_for_epoch(e), err_msg=type(b).__name__)
    craig = pairs[5][1]
    assert craig.selection_time > 0.0 and craig._weights.shape == (k,)


# ---------------------------------------------------------------------------
# the registry's plans
# ---------------------------------------------------------------------------

def _build_kwargs(name, f, *, port):
    dev = {"device": "cpu"} if port and name != "el2n" else {}
    kw = {
        "el2n": dict(scores=f["scores"], k=f["k"]),
        "selfsup_prune": dict(features=f["feats"], k=f["k"], n_prototypes=4, seed=0),
        "craig_pb": dict(grad_fn=lambda: f["g"], k=f["k"], R=3),
        "gradmatch_pb": dict(grad_fn=lambda: f["g"], k=f["k"], R=3),
        "glister": dict(grad_fn=lambda: f["g"], val_grad_fn=lambda: f["gv"], k=f["k"], R=3),
    }[name]
    return {**kw, **dev}


BASELINES = ["el2n", "selfsup_prune", "craig_pb", "gradmatch_pb", "glister"]


@pytest.mark.parametrize("name", BASELINES)
def test_registry_plans_match_reference(fx, name):
    sel_j = jsel.build_selector(name, **_build_kwargs(name, fx, port=False))
    sel_t = tsel.build_selector(name, **_build_kwargs(name, fx, port=True))
    entry_j, entry_t = jsel.selector_entry(name), tsel.selector_entry(name)
    assert (entry_t.paper, entry_t.doc) == (entry_j.paper, entry_j.doc)
    for e in range(6):
        pj, pt = sel_j.plan(e), sel_t.plan(e)
        pt.validate(fx["n"])
        np.testing.assert_array_equal(pt.indices, pj.indices)
        np.testing.assert_allclose(pt.weights, pj.weights, rtol=1e-6)
        assert (pt.phase, pt.epoch) == (pj.phase, pj.epoch)
        assert set(pt.provenance) == set(pj.provenance)
        assert {k: v for k, v in pt.provenance.items() if k != "selection_time"} == \
               {k: v for k, v in pj.provenance.items() if k != "selection_time"}
    if name in ("craig_pb", "gradmatch_pb", "glister"):
        assert pt.phase == "adaptive" and pt.provenance["window"] == 5 // 3
        assert sel_t.selection_time > 0.0


@pytest.mark.parametrize("name", ["craig_pb", "gradmatch_pb", "glister"])
def test_windowed_selector_recomputes_once_per_window(name):
    """One selection per R-epoch window; ``reset_cache`` forces the next."""
    f = FIXTURES["integration"]
    calls = []

    def grad_fn():
        calls.append(1)
        return f["g"]

    kw = _build_kwargs(name, f, port=True)
    kw["grad_fn"] = grad_fn
    sel = tsel.build_selector(name, **kw)
    for e in range(7):
        sel.plan(e)
    assert len(calls) == 3   # windows 0, 1, 2 at R = 3
    sel.plan(6)
    assert len(calls) == 3
    sel.reset_cache()
    sel.plan(6)
    assert len(calls) == 4


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

N, K, DIM, CLASSES = 120, 24, 10, 4


@pytest.fixture(scope="module")
def session_data():
    feats = np.random.default_rng(0).normal(size=(N, DIM)).astype(np.float32)
    return feats, np.arange(N, dtype=np.int64) % CLASSES


def test_session_windowed_selector_selects_once_per_window(session_data):
    """The port's side of the reference's test of the same name
    (``tests/test_selection.py``): 4 epochs at R = 2 is one warm-up
    selection plus one per window."""
    feats, labels = session_data
    calls = []

    def grad_fn():
        calls.append(1)
        return np.random.default_rng(1).normal(size=(N, DIM))

    session = tsel.MiloSession(tsel.MiloSessionConfig(
        subset_fraction=K / N, n_sge_subsets=3, total_epochs=4, gram_block=64, sub_steps=1),
        device="cpu")
    session.preprocess(feats, labels)
    report = session.train(feats, labels, test_x=feats, test_y=labels,
                           selector="craig_pb", grad_fn=grad_fn, R=2)
    assert len(calls) == 3, calls
    assert report.steps == 4 and np.isfinite(report.final_acc)


@pytest.mark.parametrize("name", BASELINES)
def test_session_builds_every_baseline(session_data, name):
    """``MiloSession.selector`` forwards its k (the artifact's), seed,
    features and device to each baseline, as the reference's does."""
    feats, labels = session_data
    cfg = dict(subset_fraction=K / N, n_sge_subsets=3, total_epochs=4, gram_block=64)
    ts = tsel.MiloSession(tsel.MiloSessionConfig(**cfg), device="cpu")
    js = jsel.MiloSession(jsel.MiloSessionConfig(**cfg))
    ts.preprocess(feats, labels)
    js.preprocess(feats, labels)
    f = dict(FIXTURES["selection"], feats=feats)
    extra = {k: v for k, v in _build_kwargs(name, f, port=False).items()
             if k not in ("k", "features", "seed")}
    sel_t = ts.selector(name, n=N, features=feats, **extra)
    sel_j = js.selector(name, n=N, features=feats, **extra)
    for e in (0, 3):
        np.testing.assert_array_equal(sel_t.plan(e).indices, sel_j.plan(e).indices)
    assert sel_t.plan(0).k == K


# ---------------------------------------------------------------------------
# CRAIG's weighted plans through the fused engine
# ---------------------------------------------------------------------------

FUSED_N, FUSED_D, FUSED_CLASSES, FUSED_HIDDEN, FUSED_K, BATCH = 256, 8, 4, 16, 96, 16


def test_craig_weighted_plans_fused_matches_loop_bit_for_bit():
    """CRAIG's γ-weighted plans (``tests/test_fused_engine.py``'s
    ``test_fused_respects_log_every_and_weights``) reach the fused engine's
    on-device batches: parameters, momenta and every history record equal
    the step loop's bit for bit, and the weights change the loss."""
    from repro.models.classifier import init_mlp as jinit_mlp

    rng = np.random.default_rng(0)
    feats = rng.normal(size=(FUSED_N, FUSED_D)).astype(np.float32)
    labs = rng.integers(0, FUSED_CLASSES, size=FUSED_N).astype(np.int64)
    sel = tsel.build_selector("craig_pb", grad_fn=lambda: feats, k=FUSED_K, R=1, device="cpu")
    assert not np.allclose(sel.plan(0).weights, 1.0)
    params_np = {k: np.asarray(v) for k, v in
                 jinit_mlp(jax.random.PRNGKey(0), FUSED_D, FUSED_CLASSES, FUSED_HIDDEN).items()}
    loop = Pipeline(lambda i: {"x": feats[i], "y": labs[i]}, sel, BATCH, seed=1, device="cpu")
    fused = Pipeline(None, sel, BATCH, seed=1, arrays={"x": feats, "y": labs}, device="cpu")
    epochs = 2
    total = loop.steps_per_epoch() * epochs
    step = tsession._classifier_step_fn(2)
    tcfg = TrainerConfig(epochs=epochs, log_every_steps=2)

    def state():
        params = params_from_jax(params_np, "cpu")
        return tsession._ClassifierState(
            params, {k: torch.zeros_like(v) for k, v in params.items()},
            torch.zeros((), dtype=torch.int64), torch.tensor(0.05), torch.tensor(float(total)))

    tr_loop = Trainer(step, loop, tcfg)
    tr_fused = Trainer(step, fused, tcfg, fused=True, superstep=4)
    assert tr_fused.fused_active()
    s_loop, s_fused = tr_loop.fit(state()), tr_fused.fit(state())
    for k in s_loop.params:
        assert torch.equal(s_loop.params[k], s_fused.params[k]), k
        assert torch.equal(s_loop.mom[k], s_fused.mom[k]), k
    assert [h["step"] for h in tr_fused.history] == [2, 4, 6, 8, 10, 12]
    assert [{k: v for k, v in h.items() if k != "wall"} for h in tr_loop.history] == \
           [{k: v for k, v in h.items() if k != "wall"} for h in tr_fused.history]
    # uniform weights over the same subset train to other parameters
    uniform = tsel.SelectionPlan(sel.plan(0).indices, None, "fixed", 0)

    class Uniform:
        def plan(self, epoch):
            return uniform

    tr_u = Trainer(step, Pipeline(None, Uniform(), BATCH, seed=1,
                                  arrays={"x": feats, "y": labs}, device="cpu"),
                   tcfg, fused=True, superstep=4)
    s_u = tr_u.fit(state())
    assert not torch.equal(s_u.params["w1"], s_fused.params["w1"])


# ---------------------------------------------------------------------------
# a finished session releases what its fused engine holds
# ---------------------------------------------------------------------------

def test_finished_session_releases_its_engine(session_data):
    """The session owns its step functions, so the fused engine (weakly
    keyed by step), its graphs, static state and resident buffers die with
    the session; within the session the engine is reused."""
    feats, labels = session_data
    session = tsel.MiloSession(selector="random", subset_fraction=0.2, batch_size=8,
                               superstep=2, total_epochs=2, fused_training=True, device="cpu")
    session.train(feats, labels, test_x=feats, test_y=labels)
    (step,) = session._steps.values()
    engine = engine_mod._ENGINE_CACHE[step]["weights"]
    session.train(feats, labels, test_x=feats, test_y=labels, lr=0.01)
    assert session._steps == {session.config.sub_steps: step}
    assert engine_mod._ENGINE_CACHE[step]["weights"] is engine
    ref_engine, ref_step = weakref.ref(engine), weakref.ref(step)
    del session, step, engine
    gc.collect()
    assert ref_step() is None
    assert ref_engine() is None

