"""The tuning workflow of the port against the reference: ``milo_fixed``,
``MiloSession.adopt_metadata`` and ``MiloSession.tune``, on the CPU.

* ``milo_fixed`` is index-exact against the reference on both routes.
* ``adopt_metadata`` takes a reference-built artifact and refuses the
  reference's mismatches.
* ``tune``: the reference's trial stream on ``examples/tune_hparams.py``'s
  dataset is replayed trial by trial — each (config, budget) trained by the
  port from the reference's initial parameters (carried across) and plans
  (the reference's artifact, adopted, and its WRE draws injected) — and the
  validation accuracies are held within ``ACC_BOUND``.  Comparing trial by
  trial avoids the near-ties of halving, where one flipped validation row
  can reorder a rung.
"""
import dataclasses
import importlib

import jax
import numpy as np
import pytest
import torch

import repro.selection as jsel
from repro.core.metadata import MetadataMismatchError as JMismatch
from repro.data.datasets import GaussianMixtureDataset
from repro.models.classifier import init_mlp as jinit_mlp
import repro_torch.selection as tsel
from repro_torch.core.metadata import MetadataMismatchError, MiloMetadata as TMeta
from repro_torch.models.classifier import params_from_jax

torch.set_num_threads(1)

tsession = importlib.import_module("repro_torch.selection.session")

SPACE = {"lr": ("log", 3e-3, 0.3), "hidden": ("choice", [32, 64, 128])}
EXAMPLE = dict(subset_fraction=0.1, n_sge_subsets=4, total_epochs=30, eval_every_epochs=10)
# One validation row of 120: the port and the reference train from the same
# parameters on the same batches and differ by float rounding only (XLA's
# and PyTorch's sums), so a row at the decision boundary may flip.  All 44
# trials agreed exactly when this bound was set.
ACC_BOUND = 1 / 120


def reference_wre_noise(seed, m):
    """The reference's WRE draw of a window: ``fold_in(PRNGKey(seed), window)``
    then ``gumbel(key, (m,))`` (as in ``tests/test_torch_slice.py``)."""
    return lambda window: np.asarray(
        jax.random.gumbel(jax.random.fold_in(jax.random.PRNGKey(seed), window), (m,)))


@pytest.fixture(scope="module")
def example():
    ds = GaussianMixtureDataset(n=1200, n_classes=6, dim=24, seed=0)
    tr, va, _ = ds.split()
    feats, labs = ds.features()[tr], ds.y[tr]
    js = jsel.MiloSession(jsel.MiloSessionConfig(**EXAMPLE))
    md = js.preprocess(feats, labs)
    return feats, labs, ds.x[va], ds.y[va], js, md


def _port_session(md_j, tmp_path, **overrides):
    path = str(tmp_path / "reference.npz")
    md_j.save(path)
    ts = tsel.MiloSession(**{**EXAMPLE, **overrides}, device="cpu")
    ts.adopt_metadata(TMeta.load(path))
    return ts


# ---------------------------------------------------------------------------
# milo_fixed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gram_free", [False, True])
def test_milo_fixed_index_exact_against_reference(example, gram_free):
    feats, labs, _, _, _, _ = example
    for k in (1, 17, 96):
        sel_j = jsel.build_selector("milo_fixed", features=feats, k=k, gram_free=gram_free)
        sel_t = tsel.build_selector("milo_fixed", features=feats, k=k, gram_free=gram_free,
                                    device="cpu")
        pj, pt = sel_j.plan(3), sel_t.plan(3)
        np.testing.assert_array_equal(pt.indices, pj.indices)
        np.testing.assert_array_equal(pt.weights, pj.weights)
        assert (pt.phase, pt.epoch, dict(pt.provenance)) == (pj.phase, pj.epoch, dict(pj.provenance))


def test_milo_fixed_through_the_session_and_refusals(example, tmp_path):
    feats, labs, _, _, js, md = example
    ts = _port_session(md, tmp_path)
    sel = ts.selector("milo_fixed", n=len(feats), features=feats)
    ref = js.selector("milo_fixed", n=len(feats), features=feats)
    assert len(sel.plan(0).indices) == md.k
    np.testing.assert_array_equal(sel.plan(0).indices, ref.plan(0).indices)
    with pytest.raises(ValueError, match="needs `features`"):
        ts.selector("milo_fixed", n=len(feats))
    # shard_selection on one process: the gram-free path, as the reference's
    a = tsel.build_selector("milo_fixed", features=feats, k=5, shard_selection=True, device="cpu")
    b = jsel.build_selector("milo_fixed", features=feats, k=5, shard_selection=True)
    np.testing.assert_array_equal(a.plan(0).indices, b.plan(0).indices)
    assert [f.name for f in dataclasses.fields(tsel.MiloFixedConfig)][:4] == \
           [f.name for f in dataclasses.fields(jsel.MiloFixedConfig)]


# ---------------------------------------------------------------------------
# adopt_metadata
# ---------------------------------------------------------------------------

def test_adopt_metadata_accepts_a_reference_artifact(example, tmp_path):
    feats, labs, vx, vy, _, md = example
    ts = _port_session(md, tmp_path)
    assert ts.loaded_from_artifact and ts.metadata.config_hash() == md.config_hash()
    np.testing.assert_array_equal(ts.metadata.sge_subsets, md.sge_subsets)
    report = ts.train(feats, labs, test_x=vx, test_y=vy, selector="milo", epochs=4)
    assert report.steps == 4 and {h["phase"] for h in report.history if "phase" in h} <= {"sge", "wre"}
    fresh = tsel.MiloSession(**EXAMPLE, device="cpu")
    fresh.adopt_metadata(ts.metadata, loaded=False)
    assert not fresh.loaded_from_artifact


@pytest.mark.parametrize("override,key", [
    (dict(subset_fraction=0.2), "subset_fraction"), (dict(n_sge_subsets=8), "n_sge_subsets"),
    (dict(prep_seed=5), "prep_seed"), (dict(seed=3), "prep_seed"),
])
def test_adopt_metadata_refuses_mismatches_like_the_reference(example, tmp_path, override, key):
    _, _, _, _, _, md = example
    path = str(tmp_path / "reference.npz")
    md.save(path)
    md_t = TMeta.load(path)
    with pytest.raises(MetadataMismatchError, match=key) as et:
        tsel.MiloSession(**{**EXAMPLE, **override}, device="cpu").adopt_metadata(md_t)
    with pytest.raises(JMismatch) as ej:
        jsel.MiloSession(jsel.MiloSessionConfig(**{**EXAMPLE, **override})).adopt_metadata(md)
    assert str(et.value) == str(ej.value)


def test_adopt_metadata_refuses_partition_provenance(example, tmp_path):
    _, _, _, _, _, md = example
    path = str(tmp_path / "reference.npz")
    md.save(path)
    md_t = TMeta.load(path)
    md_t.config["partition"] = "random_blocks"
    with pytest.raises(MetadataMismatchError, match="partition"):
        tsel.MiloSession(**EXAMPLE, device="cpu").adopt_metadata(md_t)


# ---------------------------------------------------------------------------
# tune
# ---------------------------------------------------------------------------

def test_tune_refuses_unknown_keys_and_searches(example, tmp_path):
    feats, labs, vx, vy, js, md = example
    ts = _port_session(md, tmp_path)
    for session, err in ((ts, ValueError), (js, ValueError)):
        with pytest.raises(err, match="unsupported space keys"):
            session.tune(feats, labs, vx, vy, {"lr": ("log", 1e-3, 0.1), "wd": ("uniform", 0, 1)})
        with pytest.raises(err, match="unknown search"):
            session.tune(feats, labs, vx, vy, SPACE, search="bayes")


@pytest.mark.parametrize("selector", ["full", "milo"])
def test_tune_trials_match_reference_trial_by_trial(example, tmp_path, monkeypatch, selector):
    feats, labs, vx, vy, js, md = example
    ref = js.tune(feats, labs, vx, vy, SPACE, selector=selector, search="tpe", max_budget=9,
                  eta=3)
    assert len(ref.trials) == 22 and ref.total_epochs == 78
    ts = _port_session(md, tmp_path)
    seed = ts.config.seed

    def reference_init(gen, d_in, n_classes, hidden, *, device):
        p = jinit_mlp(jax.random.PRNGKey(seed), d_in, n_classes, hidden)
        return params_from_jax({k: np.asarray(v) for k, v in p.items()}, device)

    monkeypatch.setattr(tsession, "init_mlp", reference_init)
    extra = {"wre_noise": reference_wre_noise(seed, len(feats))} if selector == "milo" else {}
    gaps = []
    for trial in ref.trials:
        cfg, budget = trial["config"], trial["budget"]
        report = ts.train(feats, labs, test_x=vx, test_y=vy, selector=selector,
                          epochs=max(2, budget), seed=seed, lr=cfg["lr"], hidden=cfg["hidden"],
                          **extra)
        gaps.append(abs(report.final_acc - trial["score"]))
    assert max(gaps) <= ACC_BOUND, gaps


def test_tune_runs_and_resumes_from_its_checkpoint(example, tmp_path):
    """The port's own sweep (the fused engine, ``milo_fixed``): a sweep
    ended by ``should_stop`` after its first bracket and relaunched with the
    same ``checkpoint=`` gives the uninterrupted run's trial stream."""
    feats, labs, vx, vy, _, md = example
    ts = _port_session(md, tmp_path, fused_training=True, superstep=4, batch_size=16)
    kw = dict(selector="milo_fixed", search="tpe", max_budget=3, eta=3, seed=1)
    full = ts.tune(feats, labs, vx, vy, SPACE, **kw)
    assert len(full.trials) == 6 and not full.stopped and full.failed_trials == 0
    assert ts._columns is None
    polls = {"n": 0}

    def stop_after_first_bracket():
        polls["n"] += 1
        return polls["n"] > 2   # bracket 1 has two rungs

    ckpt = str(tmp_path / "hb.json")
    first = ts.tune(feats, labs, vx, vy, SPACE, checkpoint=ckpt,
                    should_stop=stop_after_first_bracket, **kw)
    assert first.stopped and len(first.trials) == 4
    resumed = ts.tune(feats, labs, vx, vy, SPACE, checkpoint=ckpt, **kw)
    assert resumed.trials == full.trials and resumed.best_config == full.best_config
    calls = []

    def batched(configs, budget):
        calls.append(len(configs))
        return [-abs(np.log10(c["lr"]) + 1.5) for c in configs]

    res = ts.tune(feats, labs, vx, vy, SPACE, batched_objective=batched, **kw)
    assert sum(calls) == len(res.trials)
    assert res.best_score == max(t["score"] for t in res.trials)
