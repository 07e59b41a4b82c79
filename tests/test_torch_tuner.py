"""The port's tuner (``repro_torch.tuning.tuner``) against the reference's
(``repro.tuning.tuner``).

The objectives are deterministic numpy functions of (config, budget), so the
two packages must produce *identical* trial streams and ``best_config``s:
the same draws, the same halving, the same quarantine and the same rung
checkpoints, which cross packages both ways.  Tolerance: none (``==``).
"""
import json
import math

import numpy as np
import pytest

import repro.tuning.tuner as jtuner
import repro_torch.tuning.tuner as ttuner

SPACE = {"lr": ("log", 3e-3, 0.3), "hidden": ("choice", [32, 64, 128]),
         "wd": ("uniform", 0.0, 0.1)}
SCHEDULES = [(9, 3), (27, 3), (16, 2), (8, 2)]


def objective(cfg, budget):
    return (-abs(math.log10(cfg["lr"]) + 1.5) - 0.01 * abs(cfg["hidden"] - 64) / 64
            - cfg["wd"] + 0.05 * math.log1p(budget))


def batched(configs, budget):
    return [objective(c, budget) for c in configs]


def _search(pkg, name, seed=0, space=SPACE):
    return getattr(pkg, name)(space, seed=seed)


def _run(pkg, name, max_budget=9, eta=3, seed=0, **kw):
    obj = kw.pop("objective", objective)
    return pkg.hyperband(obj, _search(pkg, name, seed), max_budget=max_budget, eta=eta, **kw)


def _same(a, b):
    assert a.trials == b.trials
    assert a.best_config == b.best_config
    assert a.best_score == b.best_score
    assert a.total_epochs == b.total_epochs
    assert (a.stopped, a.failed_trials) == (b.stopped, b.failed_trials)


@pytest.mark.parametrize("search", ["RandomSearch", "TPESearch"])
@pytest.mark.parametrize("max_budget,eta", SCHEDULES)
def test_hyperband_identical_to_reference(search, max_budget, eta):
    t = _run(ttuner, search, max_budget, eta, seed=max_budget)
    j = _run(jtuner, search, max_budget, eta, seed=max_budget)
    _same(t, j)
    assert len(t.trials) > 3


@pytest.mark.parametrize("search", ["RandomSearch", "TPESearch"])
def test_batched_and_bucketed_identical_to_sequential_and_reference(search):
    seq = _run(ttuner, search, 27, 3)
    bat = _run(ttuner, search, 27, 3, objective=None, batched_objective=batched)
    calls = []

    def per_bucket(configs, budget):
        assert len({c["hidden"] for c in configs}) == 1
        calls.append(len(configs))
        return batched(configs, budget)

    buck = _run(ttuner, search, 27, 3, objective=None,
                batched_objective=ttuner.shape_bucketed_objective(per_bucket))
    ref = _run(jtuner, search, 27, 3, objective=None,
               batched_objective=jtuner.shape_bucketed_objective(batched))
    for other in (bat, buck, ref):
        _same(seq, other)
    assert any(n > 1 for n in calls)


def test_quarantine_of_raising_and_nan_trials_matches_reference():
    def flaky(cfg, budget):
        if cfg["hidden"] == 128:
            raise RuntimeError("diverged")
        if cfg["hidden"] == 32 and budget > 1:
            return float("nan")
        return objective(cfg, budget)

    t = _run(ttuner, "RandomSearch", 9, 3, objective=flaky)
    j = _run(jtuner, "RandomSearch", 9, 3, objective=flaky)
    _same(t, j)
    failed = [tr for tr in t.trials if tr.get("failed")]
    assert t.failed_trials == len(failed) > 0
    assert {tr["error"] for tr in failed} == {"RuntimeError('diverged')", "non-finite score nan"}
    assert all(tr["score"] == -np.inf for tr in failed)
    assert t.best_config["hidden"] == 64

    def broken(cfg, budget):
        raise ValueError("harness bug")

    with pytest.raises(RuntimeError, match="all .* trial evaluations failed"):
        _run(ttuner, "RandomSearch", 9, 3, objective=broken)
    with pytest.raises(ValueError, match="scores"):
        _run(ttuner, "RandomSearch", 9, 3, objective=None,
             batched_objective=lambda cfgs, b: [0.0])
    with pytest.raises(ValueError, match="objective"):
        ttuner.hyperband(None, _search(ttuner, "RandomSearch"))


def _stopper(n_rungs):
    polls = {"n": 0}

    def should_stop():
        polls["n"] += 1
        return polls["n"] > n_rungs

    return should_stop


@pytest.mark.parametrize("n_rungs", [0, 1, 3, 4])
def test_should_stop_matches_reference(n_rungs):
    t = _run(ttuner, "TPESearch", 27, 3, should_stop=_stopper(n_rungs))
    j = _run(jtuner, "TPESearch", 27, 3, should_stop=_stopper(n_rungs))
    _same(t, j)
    assert t.stopped
    assert (t.best_config is None) == (n_rungs == 0)


@pytest.mark.parametrize("writer,resumer", [(ttuner, ttuner), (ttuner, jtuner), (jtuner, ttuner)],
                         ids=["port-port", "port-reference", "reference-port"])
@pytest.mark.parametrize("n_rungs", [1, 4])
def test_checkpoint_resume_identical_across_packages(tmp_path, writer, resumer, n_rungs):
    """A sweep killed at a rung boundary (``should_stop``) and relaunched
    with the same ``checkpoint=`` gives the uninterrupted run's trial stream
    and ``best_config``, whichever package wrote the file."""
    full = _run(ttuner, "TPESearch", 27, 3)
    ckpt = str(tmp_path / "hb.json")
    first = _run(writer, "TPESearch", 27, 3, checkpoint=ckpt, should_stop=_stopper(n_rungs))
    assert first.stopped and len(first.trials) < len(full.trials)
    resumed = _run(resumer, "TPESearch", 27, 3, checkpoint=ckpt)
    _same(full, resumed)
    state = json.loads(open(ckpt).read())
    assert state["format"] == ttuner.HB_CHECKPOINT_FORMAT and state["done"]
    # a finished sweep short-circuits to its recorded result
    again = _run(resumer, "TPESearch", 27, 3, checkpoint=ckpt)
    assert again.trials == full.trials and again.best_config == full.best_config


def test_checkpoint_identity_and_corruption_refused(tmp_path):
    ckpt = str(tmp_path / "hb.json")
    _run(ttuner, "RandomSearch", 9, 3, checkpoint=ckpt)
    with pytest.raises(ValueError, match="different sweep"):
        _run(ttuner, "TPESearch", 9, 3, checkpoint=ckpt)
    with pytest.raises(ValueError, match="different sweep"):
        _run(ttuner, "RandomSearch", 27, 3, checkpoint=ckpt)
    (tmp_path / "bad.json").write_text("{not json")
    with pytest.raises(ValueError, match="corrupt"):
        _run(ttuner, "RandomSearch", 9, 3, checkpoint=str(tmp_path / "bad.json"))
    state = json.loads(open(ckpt).read())
    del state["search_state"]
    (tmp_path / "torn.json").write_text(json.dumps(state))
    with pytest.raises(ValueError, match="missing keys"):
        _run(ttuner, "RandomSearch", 9, 3, checkpoint=str(tmp_path / "torn.json"))


@pytest.mark.parametrize("search", ["RandomSearch", "TPESearch"])
def test_search_state_round_trip_and_draws_match_reference(search):
    t, j = _search(ttuner, search, 5), _search(jtuner, search, 5)
    hist = [(ttuner.sample_config(SPACE, np.random.default_rng(i)), float(i)) for i in range(12)]
    assert [t.suggest(hist) for _ in range(4)] == [j.suggest(hist) for _ in range(4)]
    saved = t.get_state()
    ahead = [t.suggest(hist) for _ in range(3)]
    t.set_state(json.loads(json.dumps(saved)))  # through JSON, as the checkpoint holds it
    assert [t.suggest(hist) for _ in range(3)] == ahead


def test_kendall_tau_and_stack_configs_match_reference():
    rng = np.random.default_rng(0)
    for n in (2, 7, 40):
        a = rng.normal(size=n)
        b = a + rng.normal(size=n)
        a_tied = np.round(a, 0)
        for x, y in ((a, b), (a_tied, b), (a, a), (a, -a), (np.ones(n), b)):
            assert ttuner.kendall_tau(x, y) == jtuner.kendall_tau(x, y)
    cfgs = [{"lr": 0.1, "wd": 1.0}, {"lr": 0.2, "wd": 2.0}]
    t, j = ttuner.stack_configs(cfgs), jtuner.stack_configs(cfgs)
    assert t.keys() == j.keys()
    for k in t:
        np.testing.assert_array_equal(t[k], j[k])
    with pytest.raises(ValueError, match="keys"):
        ttuner.stack_configs([{"lr": 0.1}, {"wd": 1.0}])
    with pytest.raises(ValueError, match="no configs"):
        ttuner.stack_configs([])


def test_subset_objective_builds_a_selector_per_evaluation():
    built = []

    def factory(budget):
        built.append(budget)
        return object()

    def train_fn(cfg, budget, sel):
        return objective(cfg, budget)

    res = ttuner.hyperband(ttuner.subset_objective(train_fn, factory),
                           _search(ttuner, "RandomSearch"), max_budget=9, eta=3)
    assert built == [t["budget"] for t in res.trials]
