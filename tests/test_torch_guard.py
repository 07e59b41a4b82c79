"""The port's divergence guard (``health.guard``) on its own and on the
Trainer's two paths, mirroring ``tests/test_health.py``: non-finite and
spiking steps are skipped with the step counter advanced, the healthy path
is bit-identical to an unguarded run, ``rollback`` ends bit-identical to
``skip_step``, ``abort`` raises, rollback without a checkpoint raises, and
the rollback budget is enforced.  On the CPU the fused path runs its
segments eagerly; the card runs them as CUDA graphs (``chip_smoke.py``
phase 18c)."""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import pytest
import torch

from repro.health import guard as jguard
from repro_torch.data.pipeline import Pipeline
from repro_torch.health import GUARD_KEY, DivergenceError, GuardPolicy, guarded_step
from repro_torch.selection import build_selector
from repro_torch.selection import session as S
from repro_torch.train import engine as engine_mod
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)


class _TinyState(NamedTuple):
    p: torch.Tensor
    step: torch.Tensor


def _tiny_step(state, batch):
    loss = torch.sum(state.p * batch["x"])
    return _TinyState(state.p - 0.1 * batch["x"], state.step + 1), {"loss": loss}


def nan_at_step(train_step, *, step: int):
    """The reference's ``testing.faults.nan_at_step`` on tensors: the step
    whose incoming counter equals ``step`` poisons every floating leaf of
    its new state and metrics (read before the step, which may update the
    state in place; ``functools.wraps`` carries its ``updates_in_place``)."""
    @functools.wraps(train_step)
    def wrapper(state, batch):
        hit = state.step == step
        new_state, metrics = train_step(state, batch)

        def nanify(x):
            if not torch.is_floating_point(x):
                return x
            with torch.no_grad():
                return torch.where(hit, torch.full_like(x, float("nan")), x)

        from repro_torch import tree as T

        return T.map(nanify, new_state), {k: nanify(v) for k, v in metrics.items()}

    return wrapper


def test_policy_constants_match_reference():
    assert GUARD_KEY == jguard.GUARD_KEY
    from repro_torch.health import GUARD_ACTIONS

    assert GUARD_ACTIONS == jguard.GUARD_ACTIONS
    assert hash(GuardPolicy()) == hash(GuardPolicy()) and GuardPolicy() == GuardPolicy()


def test_guarded_step_skips_nonfinite_and_advances_counter():
    g = guarded_step(nan_at_step(_tiny_step, step=1), GuardPolicy())
    s = _TinyState(torch.ones(3), torch.zeros((), dtype=torch.int32))
    s, m0 = g(s, {"x": torch.ones(3)})
    assert float(m0[GUARD_KEY]) == 0.0
    p_before = s.p.clone()
    s, m1 = g(s, {"x": torch.ones(3)})           # poisoned step
    assert float(m1[GUARD_KEY]) == 1.0
    assert torch.equal(s.p, p_before)            # update skipped
    assert int(s.step) == 2                      # counter still advanced
    s, m2 = g(s, {"x": torch.ones(3)})           # healthy again (no livelock)
    assert float(m2[GUARD_KEY]) == 0.0 and not torch.equal(s.p, p_before)


def test_guarded_step_max_loss_spike_counts_as_bad():
    g = guarded_step(_tiny_step, GuardPolicy(max_loss=1.0))
    s = _TinyState(torch.ones(3), torch.zeros((), dtype=torch.int32))
    _, m = g(s, {"x": torch.ones(3)})            # loss = 3.0 > 1.0
    assert float(m[GUARD_KEY]) == 1.0
    _, m = g(s, {"x": torch.ones(3) * 0.1})      # loss = 0.3 <= 1.0
    assert float(m[GUARD_KEY]) == 0.0


def test_guard_policy_validates_action():
    with pytest.raises(ValueError, match="guard action"):
        GuardPolicy(action="panic")


def test_guarded_in_place_step_keeps_its_pre_step_state():
    """A step that updates its state in place (the session's) is still
    skipped: the guard copied the pre-step state before calling it."""
    feats = np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32)
    state = S._init_classifier(0, 4, 2, 8, 0.1, 4, torch.device("cpu"))
    before = {k: v.detach().clone() for k, v in state.params.items()}
    batch = {"x": torch.as_tensor(feats), "y": torch.zeros(16, dtype=torch.long),
             "weights": torch.full((16,), float("nan"))}
    out, m = guarded_step(S._classifier_step_fn(1), GuardPolicy())(state, batch)
    assert float(m[GUARD_KEY]) == 1.0 and int(out.step) == 1
    assert all(torch.equal(out.params[k], before[k]) for k in before)


def test_guarded_step_refuses_an_undeclared_in_place_step():
    """A step that changes its input without declaring ``updates_in_place``
    raises: the guard, copying nothing, could not skip it."""
    def sneaky(state, batch):
        with torch.no_grad():
            state.p.sub_(batch["x"])
        return state, {"loss": torch.sum(state.p)}

    s = _TinyState(torch.ones(3), torch.zeros((), dtype=torch.int32))
    with pytest.raises(RuntimeError, match="updates_in_place"):
        guarded_step(sneaky, GuardPolicy())(s, {"x": torch.ones(3)})
    sneaky.updates_in_place = True
    s = _TinyState(torch.ones(3), torch.zeros((), dtype=torch.int32))
    out, m = guarded_step(sneaky, GuardPolicy(max_loss=-1.0))(s, {"x": torch.ones(3)})
    assert float(m[GUARD_KEY]) == 1.0 and torch.equal(out.p, torch.ones(3))


def test_guarded_functional_step_reads_its_untouched_input():
    """A step that returns a new state is guarded over its input, which it
    left as it was: skipped, the state is the input's values, the input's
    tensors unchanged, and the counter advanced."""
    s = _TinyState(torch.ones(3), torch.zeros((), dtype=torch.int32))
    version = s.p._version
    out, m = guarded_step(_tiny_step, GuardPolicy(max_loss=1.0))(s, {"x": torch.ones(3)})
    assert float(m[GUARD_KEY]) == 1.0 and int(out.step) == 1 and int(s.step) == 0
    assert torch.equal(out.p, torch.ones(3)) and s.p._version == version


def test_guarded_step_in_superstep_matches_step_loop():
    g = guarded_step(nan_at_step(_tiny_step, step=2), GuardPolicy())
    xs = torch.tile(torch.arange(3.0) + 1, (5, 1))
    s0 = _TinyState(torch.ones(3), torch.zeros((), dtype=torch.int32))
    s_loop = s0
    for t in range(5):
        s_loop, _ = g(s_loop, {"x": xs[t]})
    s_seg, ms = engine_mod.make_superstep(nan_at_step(_tiny_step, step=2),
                                          guard=GuardPolicy())(s0, {"x": xs})
    assert torch.equal(s_seg.p, s_loop.p) and int(s_seg.step) == 5
    assert ms[GUARD_KEY].tolist() == [0.0, 0.0, 1.0, 0.0, 0.0]


# ---------------------------------------------------------------------------
# the Trainer: skip / rollback / abort
# ---------------------------------------------------------------------------

N_TR, D_TR, C_TR, K_TR, BATCH_TR = 256, 8, 4, 96, 16   # 6 steps per epoch


def _data():
    rng = np.random.default_rng(0)
    return (rng.normal(size=(N_TR, D_TR)).astype(np.float32),
            rng.integers(0, C_TR, size=N_TR).astype(np.int64))


def _run_guarded(action=None, *, nan_step=None, ckpt_dir=None, fused=True, epochs=3,
                 max_rollbacks=4):
    feats, labs = _data()
    step = S._classifier_step_fn(1)
    if nan_step is not None:
        step = nan_at_step(step, step=nan_step)
    sel = build_selector("adaptive_random", n=N_TR, k=K_TR, R=1, seed=3)
    pipe = Pipeline(None, sel, BATCH_TR, seed=1, arrays={"x": feats, "y": labs}, device="cpu")
    tr = Trainer(step, pipe, TrainerConfig(
        epochs=epochs, log_every_steps=1, checkpoint_dir=ckpt_dir,
        checkpoint_every_steps=5 if ckpt_dir else 0, async_checkpoint=False,
        guard=None if action is None else GuardPolicy(action=action,
                                                      max_rollbacks=max_rollbacks)),
        fused=fused, superstep=32)
    state = S._init_classifier(0, D_TR, C_TR, 16, 0.05, 18, torch.device("cpu"))
    return tr.fit(state, resume=bool(ckpt_dir)), tr


def _params_equal(a, b) -> bool:
    return all(torch.equal(a.params[k], b.params[k]) and torch.equal(a.mom[k], b.mom[k])
               for k in a.params)


@pytest.mark.parametrize("fused", [True, False])
def test_guard_healthy_path_bit_identical_to_unguarded(fused):
    ref, _ = _run_guarded(None, fused=fused)
    out, tr_out = _run_guarded("skip_step", fused=fused)
    assert _params_equal(ref, out)
    assert tr_out.guard_report() is None
    recs = [h for h in tr_out.history if "loss" in h]
    assert recs and all(h[GUARD_KEY] == 0.0 for h in recs)


def test_guard_rollback_bit_identical_to_skip(tmp_path):
    skip, tr_skip = _run_guarded("skip_step", nan_step=8)
    assert int(skip.step) == 18
    rep = tr_skip.guard_report()
    assert rep["skipped_steps"] == 1 and rep["rollbacks"] == 0
    assert rep["events"] == [{"action": "skip_step", "step": 9, "epoch": 1}]

    rb, tr_rb = _run_guarded("rollback", nan_step=8, ckpt_dir=str(tmp_path / "ckpt"))
    assert int(rb.step) == 18
    rep = tr_rb.guard_report()
    assert rep["rollbacks"] == 1 and rep["skipped_steps"] == 1
    restores = [h for h in tr_rb.history if h.get("guard") == "rollback"]
    assert len(restores) == 1 and restores[0]["restored_step"] == 5
    assert _params_equal(skip, rb)

    loop, tr_loop = _run_guarded("skip_step", nan_step=8, fused=False)
    assert _params_equal(skip, loop)
    assert tr_loop.guard_report()["skipped_steps"] == 1

    rb_loop, tr_rbl = _run_guarded("rollback", nan_step=8, ckpt_dir=str(tmp_path / "ckpt2"),
                                   fused=False)
    assert _params_equal(skip, rb_loop) and tr_rbl.guard_report()["rollbacks"] == 1


@pytest.mark.parametrize("fused", [True, False])
def test_guard_abort_raises_divergence_error(fused):
    with pytest.raises(DivergenceError):
        _run_guarded("abort", nan_step=8, fused=fused)


def test_guard_rollback_without_checkpoint_raises():
    with pytest.raises(DivergenceError, match="checkpoint"):
        _run_guarded("rollback", nan_step=8)


def test_guard_rollback_budget_exhaustion_raises(tmp_path):
    with pytest.raises(DivergenceError, match="rollback"):
        _run_guarded("rollback", nan_step=8, ckpt_dir=str(tmp_path), max_rollbacks=0)


def test_unguarded_nan_wrecks_the_run():
    """The fault is real: without the guard the parameters go non-finite."""
    out, _ = _run_guarded(None, nan_step=8)
    assert not all(torch.isfinite(v).all() for v in out.params.values())
