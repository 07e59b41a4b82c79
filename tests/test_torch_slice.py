"""The ported slice as a whole against the JAX reference: preprocess →
artifact → curriculum plans → training, on the CPU.

The reference runs ``MiloSession(use_pallas=True)`` as its own tests run it
(the similarity kernel in interpret mode); the port runs the same config on
``device="cpu"`` with the reference's JAX draws injected through its seams
(``sge_noise=`` on preprocess, ``wre_noise=`` on the milo selector).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.selection as jsel
from repro.core.metadata import MiloMetadata as JMeta
from repro.core.partition import ByClass, proportional_budgets
from repro.data.datasets import GaussianMixtureDataset
from repro.data.pipeline import Pipeline as JPipeline
from repro.models.classifier import init_mlp as jinit_mlp
from repro.train.trainer import Trainer as JTrainer, TrainerConfig as JTrainerConfig
import repro_torch.selection as tsel
from repro_torch.core.metadata import MiloMetadata as TMeta
from repro_torch.data.pipeline import Pipeline as TPipeline
from repro_torch.models.classifier import params_from_jax
from repro_torch.train.trainer import Trainer as TTrainer, TrainerConfig as TTrainerConfig

# the suite runs in parallel workers beside wall-clock-sensitive tests:
# keep this file's PyTorch CPU work on one thread per worker
torch.set_num_threads(1)

jsession = importlib.import_module("repro.selection.session")
tsession = importlib.import_module("repro_torch.selection.session")

SEED = 3
EPOCHS = 12


def _next_pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


@pytest.fixture(scope="module")
def data():
    ds = GaussianMixtureDataset(n=720, n_classes=3, dim=32, seed=0)
    tr, _, te = ds.split(val_frac=0.0, test_frac=1 / 6)
    return ds.x[tr], ds.y[tr], ds.x[te], ds.y[te]


def reference_sge_noise(labels, cfg, bucketed=True):
    """The reference's per-class SGE draws: ``key, k_sge = split(key)`` per
    partition (``core/milo.py``), then ``split(k_sge, n_subsets)``, then
    ``split(kk, k_run)``, then ``gumbel(keys[t], (n_run,))`` — in the
    geometry (n_run, k_run) the reference runs each class at (bucketed to
    powers of two unless ``bucketed=False``)."""
    parts = ByClass().partition(labels, len(labels))
    budgets = proportional_budgets(parts, max(1, round(cfg.subset_fraction * len(labels))))
    key = jax.random.PRNGKey(cfg.resolved_prep_seed())
    noise = []
    for part, k_c in zip(parts, budgets):
        key, k_sge = jax.random.split(key)
        n_run = _next_pow2(len(part.indices)) if bucketed else len(part.indices)
        k_run = min(n_run, _next_pow2(k_c)) if bucketed else k_c

        def run(kk, k_run=k_run, n_run=n_run):
            return jax.vmap(lambda kt: jax.random.gumbel(kt, (n_run,)))(jax.random.split(kk, k_run))

        noise.append(np.asarray(jax.vmap(run)(jax.random.split(k_sge, cfg.n_sge_subsets))))
    return noise


def reference_wre_noise(seed, m):
    """The reference's WRE draw of a window: ``fold_in(PRNGKey(seed), window)``
    (``core/milo.py``), then ``gumbel(key, (m,))`` (``core/exploration.py``)."""
    return lambda window: np.asarray(
        jax.random.gumbel(jax.random.fold_in(jax.random.PRNGKey(seed), window), (m,)))


@pytest.fixture(scope="module")
def sessions(data):
    x, y, _, _ = data
    js = jsel.MiloSession(use_pallas=True, total_epochs=EPOCHS, seed=SEED)
    md_j = js.preprocess(x, y)
    ts_ = tsel.MiloSession(use_pallas=True, total_epochs=EPOCHS, seed=SEED, device="cpu")
    md_t = ts_.preprocess(x, y, sge_noise=reference_sge_noise(y, ts_.config))
    return js, ts_, md_j, md_t


def test_preprocess_matches_reference(sessions, data):
    x, y, _, _ = data
    _, _, md_j, md_t = sessions
    assert md_t.config == md_j.config
    assert md_t.config_hash() == md_j.config_hash()
    np.testing.assert_array_equal(md_t.class_budgets, md_j.class_budgets)
    np.testing.assert_array_equal(md_t.class_labels, md_j.class_labels)
    np.testing.assert_allclose(md_t.wre_importance, md_j.wre_importance, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(md_t.wre_probs, md_j.wre_probs, rtol=1e-5, atol=1e-9)
    # the two CPU Grams differ in the last ulps (the reference's interpret-mode
    # Pallas dot against a PyTorch matmul); the bank must still be index-exact
    np.testing.assert_array_equal(md_t.sge_subsets, md_j.sge_subsets)


def test_plans_match_reference(sessions, data):
    """The same artifact served by both selectors: SGE lookups and WRE draws
    (reference draws injected) agree index for index at every epoch."""
    x, _, _, _ = data
    js, ts_, md_j, _ = sessions
    sel_j = js.selector("milo", n=len(x))
    ts_.metadata = TMeta(md_j.sge_subsets, md_j.wre_probs, md_j.wre_importance,
                         md_j.class_labels, md_j.class_budgets, dict(md_j.config))
    sel_t = ts_.selector("milo", n=len(x), wre_noise=reference_wre_noise(SEED, len(x)))
    phases = set()
    for epoch in range(EPOCHS):
        pj, pt = sel_j.plan(epoch), sel_t.plan(epoch)
        assert pt.phase == pj.phase
        phases.add(pt.phase)
        np.testing.assert_array_equal(pt.indices, pj.indices)
        np.testing.assert_array_equal(pt.weights, pj.weights)
        assert dict(pt.provenance) == dict(pj.provenance)
    assert phases == {"sge", "wre"}


def test_artifacts_load_across_packages(sessions, data, tmp_path):
    x, y, _, _ = data
    _, _, md_j, md_t = sessions
    for src, load in ((md_j, TMeta.load), (md_t, JMeta.load)):
        path = str(tmp_path / f"{type(src).__module__}.npz")
        src.save(path)
        back = load(path, expected_hash=src.config_hash())
        assert back.config == src.config and back.config_hash() == src.config_hash()
        for f in ("sge_subsets", "wre_probs", "wre_importance", "class_labels", "class_budgets"):
            np.testing.assert_array_equal(getattr(back, f), getattr(src, f))
    # a port session reuses the reference's artifact through metadata_path
    path = str(tmp_path / "shared.npz")
    md_j.save(path)
    reuse = tsel.MiloSession(use_pallas=True, total_epochs=EPOCHS, seed=SEED,
                             metadata_path=path, device="cpu")
    assert reuse.preprocess(x, y).config_hash() == md_j.config_hash()
    assert reuse.loaded_from_artifact


def test_trainer_steps_match_reference(data):
    """Same initial parameters (carried across from JAX), same plans and batch
    stream: a few Trainer steps give the same losses and parameters."""
    x, y, _, _ = data
    n, d, n_classes, hidden, sub_steps = len(x), x.shape[1], 3, 16, 4
    epochs, batch = 3, 40
    params_np = {k: np.asarray(v) for k, v in jinit_mlp(jax.random.PRNGKey(0), d, n_classes, hidden).items()}

    def make_batch(idx):
        return {"x": x[idx], "y": y[idx].astype(np.int64)}

    sel_j = jsel.build_selector("adaptive_random", n=n, k=120, seed=1)
    sel_t = tsel.build_selector("adaptive_random", n=n, k=120, seed=1)
    pipe_j = JPipeline(make_batch, sel_j, batch, seed=SEED, prefetch=False)
    pipe_t = TPipeline(make_batch, sel_t, batch, seed=SEED)
    steps = pipe_t.steps_per_epoch() * epochs
    assert steps == pipe_j.steps_per_epoch() * epochs

    state_j = jsession._ClassifierState(
        {k: jnp.asarray(v) for k, v in params_np.items()},
        {k: jnp.zeros_like(jnp.asarray(v)) for k, v in params_np.items()},
        jnp.zeros((), jnp.int32), jnp.asarray(0.05, jnp.float32), jnp.asarray(steps, jnp.float32))
    params_t = params_from_jax(params_np, "cpu")
    state_t = tsession._ClassifierState(
        params_t, {k: torch.zeros_like(v) for k, v in params_t.items()},
        torch.zeros((), dtype=torch.int64), torch.tensor(0.05), torch.tensor(float(steps)))

    tr_j = JTrainer(jsession._classifier_step_fn(sub_steps), pipe_j,
                    JTrainerConfig(epochs=epochs, log_every_steps=1))
    tr_t = TTrainer(tsession._classifier_step_fn(sub_steps), pipe_t,
                    TTrainerConfig(epochs=epochs, log_every_steps=1),
                    put_batch=lambda b: {k: torch.as_tensor(v) for k, v in b.items()})
    state_j = tr_j.fit(state_j, resume=False)
    state_t = tr_t.fit(state_t)
    assert state_t.step == int(state_j.step) == steps
    losses_j = [h["loss"] for h in tr_j.history if "loss" in h]
    losses_t = [h["loss"] for h in tr_t.history if "loss" in h]
    assert len(losses_t) == len(losses_j) == steps
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert [h["phase"] for h in tr_t.history] == [h["phase"] for h in tr_j.history]
    for k in params_np:
        np.testing.assert_allclose(state_t.params[k].detach().numpy(),
                                   np.asarray(state_j.params[k]), rtol=1e-5, atol=1e-6)


def test_train_reaches_reference_accuracy(sessions, data):
    x, y, tx, ty = data
    js, ts_, _, _ = sessions
    rj = js.train(x, y, test_x=tx, test_y=ty)
    rt = ts_.train(x, y, test_x=tx, test_y=ty)
    assert rt.steps == rj.steps == EPOCHS
    assert abs(rt.final_acc - rj.final_acc) <= 0.05
    assert rt.final_acc > 0.9, "the mixture is separable"
    evals = [h for h in rt.history if h.get("eval")]
    assert len(evals) == EPOCHS


# ---------------------------------------------------------------------------
# the gram-free route: facility-location importance under lazy gains
# ---------------------------------------------------------------------------

LAZY = dict(gram_free=True, use_pallas=True, hard_fn="facility_location", lazy_gains=True,
            lazy_two_level=True)


@pytest.fixture(scope="module")
def lazy_sessions(data):
    """The slice's path in both packages: the reference with its Pallas
    kernels in interpret mode, the port on the CPU with the reference's
    SGE draws injected."""
    x, y, _, _ = data
    js = jsel.MiloSession(total_epochs=EPOCHS, seed=SEED, **LAZY)
    md_j = js.preprocess(x, y)
    ts_ = tsel.MiloSession(total_epochs=EPOCHS, seed=SEED, device="cpu", **LAZY)
    md_t = ts_.preprocess(x, y, sge_noise=reference_sge_noise(y, ts_.config))
    return js, ts_, md_j, md_t


def _assert_importance_per_lazy_rules(imp_t, imp_j, labels):
    """Per class, over the first n_c/4 greedy picks (the shortlist horizon;
    facility location is monotone submodular, so its greedy gains never
    increase and importance ranks the picks in order): the port picks what
    the reference picks, with its gains, until the first near-tie that the
    cached gains cannot resolve — two elements whose reference gains lie
    within the tolerance below at that step (the reference's pick's gain
    and the port's pick's gain).  Past it the order may differ; the sorted
    gain sequence must still match (the reference's full-pass check).

    Tolerance: rtol 1e-5 plus 4 fp32 ulps of the class's first gain.  A
    cached gain is that first gain corrected step by step, so it carries
    absolute rounding of that size (on this mixture the first pick gains
    ~190 and the later ones ~0.03)."""
    for c in np.unique(labels):
        it, ij = imp_t[labels == c], imp_j[labels == c]
        atol = 4 * float(np.spacing(np.float32(ij.max())))
        order_j = np.argsort(-ij, kind="stable")
        order_t = np.argsort(-it, kind="stable")
        top = len(ij) // 4
        parted = np.nonzero(order_t[:top] != order_j[:top])[0]
        exact = parted[0] if len(parted) else top
        if exact < top:
            a, b = order_j[exact], order_t[exact]
            gap = abs(float(ij[a]) - float(it[b]))
            assert gap <= atol + 1e-5 * abs(float(ij[a])), (
                f"class {c}: pick {exact} is {b} (gain {it[b]}) where the reference "
                f"picks {a} (gain {ij[a]}): a gap of {gap} > {atol}")
        np.testing.assert_allclose(it[order_j[:exact]], ij[order_j[:exact]], rtol=1e-5, atol=atol)
        np.testing.assert_allclose(np.sort(it), np.sort(ij), rtol=1e-4, atol=max(1e-5, atol))
        assert (it > 0).all() and (ij > 0).all()


def test_lazy_route_matches_reference(lazy_sessions, data):
    _, y, _, _ = data
    _, _, md_j, md_t = lazy_sessions
    assert md_t.config == md_j.config and md_t.config_hash() == md_j.config_hash()
    assert md_t.config["gram_free"] and md_t.config["lazy_gains"]
    # the gram-free graph-cut bank: no kernel, injected draws, index-exact
    diff = np.argwhere(md_t.sge_subsets != md_j.sge_subsets)
    assert not len(diff), f"bank parts from the reference at (slot, position) {diff[0].tolist()}"
    _assert_importance_per_lazy_rules(md_t.wre_importance, md_j.wre_importance, y)
    np.testing.assert_allclose(np.sort(md_t.wre_probs), np.sort(md_j.wre_probs),
                               rtol=1e-4, atol=1e-8)


def test_lazy_route_two_level_is_bit_identical(lazy_sessions, data):
    x, y, _, _ = data
    _, ts_, _, md_t = lazy_sessions
    one = tsel.MiloSession(total_epochs=EPOCHS, seed=SEED, device="cpu",
                           **dict(LAZY, lazy_two_level=False))
    md_1 = one.preprocess(x, y, sge_noise=reference_sge_noise(y, one.config))
    np.testing.assert_array_equal(md_1.sge_subsets, md_t.sge_subsets)
    np.testing.assert_array_equal(md_1.wre_importance, md_t.wre_importance)
    np.testing.assert_array_equal(md_1.wre_probs, md_t.wre_probs)


def test_lazy_route_artifacts_load_across_packages(lazy_sessions, data, tmp_path):
    x, y, tx, ty = data
    js, _, md_j, md_t = lazy_sessions
    for src, load in ((md_j, TMeta.load), (md_t, JMeta.load)):
        path = str(tmp_path / f"lazy_{type(src).__module__}.npz")
        src.save(path)
        back = load(path, expected_hash=src.config_hash())
        assert back.config == src.config
        np.testing.assert_array_equal(back.wre_importance, src.wre_importance)
    # each package's session reuses the other's artifact through metadata_path
    for md, make in ((md_j, lambda p: tsel.MiloSession(total_epochs=EPOCHS, seed=SEED,
                                                       metadata_path=p, device="cpu", **LAZY)),
                     (md_t, lambda p: jsel.MiloSession(total_epochs=EPOCHS, seed=SEED,
                                                       metadata_path=p, **LAZY))):
        path = str(tmp_path / f"shared_{type(md).__module__}.npz")
        md.save(path)
        reuse = make(path)
        assert reuse.preprocess(x, y).config_hash() == md.config_hash()
        assert reuse.loaded_from_artifact
    # a session on another route refuses the artifact instead of reusing it
    path = str(tmp_path / "shared_lazy.npz")
    md_t.save(path)
    with pytest.raises(tsession.MetadataMismatchError, match="lazy_gains"):
        tsel.MiloSession(total_epochs=EPOCHS, seed=SEED, metadata_path=path, device="cpu",
                         **dict(LAZY, lazy_gains=False)).preprocess(x, y)


def test_lazy_route_trains(lazy_sessions, data):
    x, y, tx, ty = data
    _, ts_, _, _ = lazy_sessions
    r = ts_.train(x, y, test_x=tx, test_y=ty)
    assert r.steps == EPOCHS and r.final_acc > 0.9


@pytest.mark.parametrize("bucketed", [True, False])
def test_gram_free_paper_defaults_match_reference(data, bucketed):
    """gram_free=True with the paper's functions (graph-cut bank,
    disparity-min importance), with and without size bucketing."""
    x, y, _, _ = data
    cfg = dict(gram_free=True, use_pallas=True, bucket_classes=bucketed,
               total_epochs=EPOCHS, seed=SEED)
    md_j = jsel.MiloSession(**cfg).preprocess(x, y)
    ts_ = tsel.MiloSession(device="cpu", **cfg)
    noise = reference_sge_noise(y, ts_.config)
    if not bucketed:
        noise = reference_sge_noise(y, ts_.config, bucketed=False)
    md_t = ts_.preprocess(x, y, sge_noise=noise)
    assert md_t.config == md_j.config
    diff = np.argwhere(md_t.sge_subsets != md_j.sge_subsets)
    assert not len(diff), f"bank parts from the reference at (slot, position) {diff[0].tolist()}"
    np.testing.assert_allclose(md_t.wre_importance, md_j.wre_importance, rtol=1e-5, atol=1e-6)


def test_gram_free_refuses_non_cosine(data):
    x, y, _, _ = data
    with pytest.raises(ValueError, match="cosine"):
        tsel.MiloSession(gram_free=True, metric="rbf", device="cpu").preprocess(x, y)
