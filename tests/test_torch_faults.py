"""The port's fault-injection harness (``repro_torch.testing.faults``)
against ``repro.testing.faults`` on the CPU: poisoned features bit for bit,
scripted call failures and objective failures with the reference's
counters and trial records, NaN steps at the same step on the step loop
and the fused path with the reference's guard record, slow steps, a
process killed at a step, and checkpoints damaged as the reference's
tests expect (the same bytes either harness damages).
"""
from __future__ import annotations

import filecmp
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import Pipeline as JPipeline
from repro.health import GuardPolicy as JGuard
from repro.models.classifier import init_mlp as jinit_mlp, nesterov_update, weighted_nll
from repro.selection import build_selector as j_build_selector
from repro.testing import faults as JF
from repro.train.trainer import Trainer as JTrainer, TrainerConfig as JTrainerConfig
from repro.tuning.tuner import RandomSearch as JRandom, hyperband as j_hyperband
from repro_torch.checkpoint.checkpointer import CheckpointCorruptionError, CheckpointManager
from repro_torch.data.pipeline import Pipeline
from repro_torch.health import GUARD_KEY, GuardPolicy
from repro_torch.selection import build_selector
from repro_torch.selection import session as S
from repro_torch.testing import faults as TF
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tuning.tuner import RandomSearch, hyperband

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# poisoned features
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
@pytest.mark.parametrize("rows", [
    dict(nan_rows=[3]), dict(inf_rows=[0, 7]), dict(zero_rows=[11]),
    dict(nan_rows=[1, 2], inf_rows=[2, 5], zero_rows=[5, 9]), dict(),
])
def test_poison_features_bit_equal_to_reference(dtype, rows):
    feats = np.random.default_rng(0).normal(size=(12, 5)).astype(dtype)
    out_t, out_j = TF.poison_features(feats, **rows), JF.poison_features(feats, **rows)
    assert out_t.dtype == out_j.dtype and out_t is not feats
    assert out_t.tobytes() == out_j.tobytes()
    assert feats.tobytes() == np.random.default_rng(0).normal(size=(12, 5)).astype(dtype).tobytes()


def test_poison_features_refuses_integers():
    with pytest.raises(TypeError, match="floating"):
        TF.poison_features(np.zeros((3, 2), np.int64), nan_rows=[0])


# ---------------------------------------------------------------------------
# scripted call failures and objective failures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("schedule", [dict(failures=2), dict(fail_on={3}), dict(fail_on={1, 4, 5})])
def test_scripted_call_failures_match_reference(schedule):
    def run(mod):
        def fn(x):
            return x * 2
        wrapped = (mod.flaky(fn, failures=schedule["failures"]) if "failures" in schedule
                   else mod.fail_nth_calls(fn, fail_on=schedule["fail_on"]))
        out = []
        for i in range(6):
            try:
                out.append(wrapped(i))
            except mod.TransientFault as e:
                out.append(("fault", str(e), bool(getattr(e, "transient", False))))
        return out, wrapped.calls, wrapped.failures_injected, wrapped.__name__
    assert run(TF) == run(JF)
    assert issubclass(TF.TransientFault, TF.FaultInjected)


HB_SPACE = {"lr": ("log", 1e-4, 1e-1), "hidden": ("choice", [16, 32, 64])}


def _hb_obj(cfg, budget):
    return -abs(cfg["lr"] - 0.01) * 100 + budget * 0.001 + cfg["hidden"] * 1e-5


def test_objective_failures_quarantine_like_the_reference():
    first = hyperband(_hb_obj, RandomSearch(HB_SPACE, seed=7), max_budget=9, eta=3)
    fail_cfgs = [dict(t["config"]) for t in first.trials[:3]]
    tf = TF.fail_objective_for_configs(_hb_obj, fail_configs=fail_cfgs)
    jf = JF.fail_objective_for_configs(_hb_obj, fail_configs=fail_cfgs)
    out_t = hyperband(tf, RandomSearch(HB_SPACE, seed=7), max_budget=9, eta=3)
    out_j = j_hyperband(jf, JRandom(HB_SPACE, seed=7), max_budget=9, eta=3)
    assert out_t.trials == out_j.trials and out_t.best_config == out_j.best_config
    assert out_t.failed_trials == tf.failures_injected == jf.failures_injected == 3
    assert tf.calls == jf.calls


def test_slow_steps_sleep_on_the_chosen_calls():
    import time

    marks = []
    step = TF.slow_steps(lambda s, b: (s + 1, {}), slow={2}, delay=0.2)
    for i in range(3):
        t0 = time.perf_counter()
        step(i, None)
        marks.append(time.perf_counter() - t0)
    assert step.calls == 3 and marks[1] >= 0.2 > max(marks[0], marks[2])


# ---------------------------------------------------------------------------
# NaN steps on both training paths, with the reference's guard record
# ---------------------------------------------------------------------------

N_TR, D_TR, C_TR, K_TR, BATCH_TR = 256, 8, 4, 96, 16   # 6 steps per epoch


def _data():
    rng = np.random.default_rng(0)
    labs = rng.integers(0, C_TR, N_TR).astype(np.int64)
    feats = (rng.normal(size=(N_TR, D_TR)) + 0.5 * labs[:, None]).astype(np.float32)
    return feats, labs


class _JState(NamedTuple):
    params: dict
    mom: dict
    step: jax.Array


def _j_step(state, batch):
    loss, g = jax.value_and_grad(weighted_nll)(state.params, batch["x"], batch["y"],
                                               batch["weights"])
    p, m = nesterov_update(state.params, state.mom, g, 0.05)
    return _JState(p, m, state.step + 1), {"loss": loss}


def _reference_run(action, nan_step, fused):
    feats, labs = _data()
    sel = j_build_selector("adaptive_random", n=N_TR, k=K_TR, R=1, seed=3)
    pipe = JPipeline(None, sel, BATCH_TR, seed=1, arrays={"x": feats, "y": labs})
    tr = JTrainer(jax.jit(JF.nan_at_step(_j_step, step=nan_step)), pipe,
                  JTrainerConfig(epochs=3, log_every_steps=1,
                                 guard=None if action is None else JGuard(action=action)),
                  fused=fused, superstep=32)
    params = jinit_mlp(jax.random.PRNGKey(0), D_TR, C_TR)
    state = _JState(params, jax.tree.map(jnp.zeros_like, params), jnp.zeros((), jnp.int32))
    return tr.fit(state), tr


def _port_run(action, nan_step, fused):
    feats, labs = _data()
    step = TF.nan_at_step(S._classifier_step_fn(1), step=nan_step)
    sel = build_selector("adaptive_random", n=N_TR, k=K_TR, R=1, seed=3)
    pipe = Pipeline(None, sel, BATCH_TR, seed=1, arrays={"x": feats, "y": labs}, device="cpu")
    tr = Trainer(step, pipe, TrainerConfig(
        epochs=3, log_every_steps=1,
        guard=None if action is None else GuardPolicy(action=action)), fused=fused, superstep=32)
    state = S._init_classifier(0, D_TR, C_TR, 16, 0.05, 18, torch.device("cpu"))
    return tr.fit(state), tr


@pytest.mark.parametrize("nan_step", [0, 8, 17])
def test_nan_step_guard_record_matches_reference(nan_step):
    """The step whose incoming counter is ``nan_step`` is skipped on both of
    the port's paths, and the guard's record is the reference's."""
    _, tr_j = _reference_run("skip_step", nan_step, fused=False)
    ref = tr_j.guard_report()
    assert ref["events"] == [{"action": "skip_step", "step": nan_step + 1,
                              "epoch": nan_step // 6}]
    results = {}
    for fused in (False, True):
        out, tr = _port_run("skip_step", nan_step, fused)
        assert tr.guard_report() == ref
        assert int(out.step) == 18
        flags = [h[GUARD_KEY] for h in tr.history if GUARD_KEY in h]
        assert flags == [1.0 if s == nan_step else 0.0 for s in range(18)]
        results[fused] = out
    for k in results[True].params:
        assert torch.equal(results[True].params[k], results[False].params[k])


def test_nan_step_wrecks_an_unguarded_run_on_both_paths():
    for fused in (False, True):
        out, _ = _port_run(None, 8, fused)
        assert not all(torch.isfinite(v).all() for v in out.params.values())
        assert int(out.step) == 18


def test_nan_at_step_keeps_the_in_place_attribute():
    step = TF.nan_at_step(S._classifier_step_fn(1), step=0)
    assert step.updates_in_place is True
    assert step.__name__ == "train_step"


# ---------------------------------------------------------------------------
# a process killed at a step
# ---------------------------------------------------------------------------

KILL_SCRIPT = """
import numpy as np, torch
from repro_torch.data.pipeline import Pipeline
from repro_torch.selection import build_selector, session as S
from repro_torch.testing.faults import KillAtStep
from repro_torch.train.trainer import Trainer, TrainerConfig

rng = np.random.default_rng(0)
feats = rng.normal(size=(64, 4)).astype(np.float32)
labs = rng.integers(0, 2, 64).astype(np.int64)
sel = build_selector("adaptive_random", n=64, k=32, R=1, seed=3)
pipe = Pipeline(None, sel, 8, seed=1, arrays={"x": feats, "y": labs}, device="cpu")
tr = Trainer(S._classifier_step_fn(1), pipe, TrainerConfig(epochs=4, log_every_steps=1))
tr.monitor = KillAtStep(5)
state = S._init_classifier(0, 4, 2, 8, 0.05, 16, torch.device("cpu"))
tr.fit(state)
print("survived")
"""


def test_kill_at_step_sigkills_the_process():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", KILL_SCRIPT], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert out.returncode == -signal.SIGKILL, (out.returncode, out.stderr[-2000:])
    assert "survived" not in out.stdout


# ---------------------------------------------------------------------------
# damaged checkpoints
# ---------------------------------------------------------------------------

def _tree(offset: float = 0.0):
    return {"a": torch.arange(12.0).reshape(3, 4) + offset, "b": {"c": torch.ones(64) * (1 + offset)}}


@pytest.mark.parametrize("mode", TF.CORRUPTION_MODES)
def test_corrupt_checkpoint_damages_port_checkpoints(tmp_path, mode):
    """Every mode fails validation and is skipped by ``latest_valid_step``;
    the port's harness damages exactly the bytes the reference's does."""
    assert TF.CORRUPTION_MODES == JF.CORRUPTION_MODES
    mgr = CheckpointManager(str(tmp_path / "t"), keep_last=5)
    for step in (1, 2, 3):
        mgr.save(step, _tree(step))
    shutil.copytree(tmp_path / "t", tmp_path / "j")
    damaged = TF.corrupt_checkpoint(str(tmp_path / "t"), 3, mode=mode)
    damaged_j = JF.corrupt_checkpoint(str(tmp_path / "j"), 3, mode=mode)
    assert os.path.relpath(damaged, tmp_path / "t") == os.path.relpath(damaged_j, tmp_path / "j")
    assert os.path.basename(os.path.dirname(damaged)) == "step_3"
    for name in sorted(os.listdir(tmp_path / "t" / "step_3")):
        assert filecmp.cmp(tmp_path / "t" / "step_3" / name, tmp_path / "j" / "step_3" / name,
                           shallow=False)
    assert sorted(os.listdir(tmp_path / "t" / "step_3")) == sorted(
        os.listdir(tmp_path / "j" / "step_3"))
    assert mgr.all_steps() == [1, 2, 3]
    assert not mgr.is_valid_step(3) and mgr.is_valid_step(2)
    assert mgr.latest_valid_step() == 2
    with pytest.raises(CheckpointCorruptionError):
        mgr.restore(3, _tree())
    assert torch.equal(mgr.restore(2, _tree())["a"], torch.arange(12.0).reshape(3, 4) + 2)


def test_corrupt_checkpoint_refuses_unknown_modes_and_steps(tmp_path):
    with pytest.raises(ValueError, match="unknown corruption mode"):
        TF.corrupt_checkpoint(str(tmp_path), 1, mode="melt")
    with pytest.raises(FileNotFoundError):
        TF.corrupt_checkpoint(str(tmp_path), 1)
