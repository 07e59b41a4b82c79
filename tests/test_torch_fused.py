"""The port's fused device-resident engine (``train/engine.py``,
``Pipeline.device_epoch``, ``Trainer(fused=True)``) on the CPU.

Within the port the contract is bit for bit: the fused path runs the step
loop's ops on the same (seed, epoch, step) batch stream, so final
parameters and every history record (but the wall clock) are equal.
Against the reference's fused path the tolerance is
``test_trainer_steps_match_reference``'s (losses rtol 1e-5; parameters rtol
1e-5, atol 1e-6).  The card's form of the engine (CUDA graphs) is held to
the same bit-equality in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
phase 14.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.selection as jsel
from repro.data.pipeline import Pipeline as JPipeline
from repro.models.classifier import init_mlp as jinit_mlp
from repro.train.trainer import Trainer as JTrainer, TrainerConfig as JTrainerConfig
import repro_torch.selection as tsel
from repro_torch.data.pipeline import Pipeline
from repro_torch.models.classifier import params_from_jax
from repro_torch.selection.plan import SelectionPlan
from repro_torch.train import engine as engine_mod
from repro_torch.train.engine import epoch_engine, make_superstep, segment_length
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

jsession = importlib.import_module("repro.selection.session")
tsession = importlib.import_module("repro_torch.selection.session")

N, D, CLASSES, HIDDEN = 256, 8, 4, 16
K, BATCH = 96, 16          # 6 steps per epoch
SUB_STEPS = 2


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(N, D)).astype(np.float32)
    labs = rng.integers(0, CLASSES, size=N).astype(np.int64)
    return feats, labs


@pytest.fixture(scope="module")
def params_np():
    return {k: np.asarray(v) for k, v in jinit_mlp(jax.random.PRNGKey(0), D, CLASSES, HIDDEN).items()}


def _state(params_np, total_steps, lr=0.05):
    params = params_from_jax(params_np, "cpu")
    return tsession._ClassifierState(
        params, {k: torch.zeros_like(v) for k, v in params.items()},
        torch.zeros((), dtype=torch.int64), torch.tensor(lr), torch.tensor(float(total_steps)))


class _WeightedSelector:
    """A fixed subset with non-uniform plan weights (the port has no
    weighted baseline yet)."""

    def __init__(self, k=K, seed=11):
        rng = np.random.default_rng(seed)
        self.idx = rng.choice(N, size=k, replace=False)
        self.w = rng.uniform(0.2, 2.0, size=k).astype(np.float32)

    def plan(self, epoch):
        return SelectionPlan(self.idx, self.w, "fixed", epoch, {"selector": "weighted"})


def _pipelines(feats, labs, selector=None, **kw):
    sel = selector or tsel.build_selector("adaptive_random", n=N, k=K, R=1, seed=3)

    def make_batch(idx):
        return {"x": feats[idx], "y": labs[idx]}

    loop = Pipeline(make_batch, sel, BATCH, seed=1, device="cpu", **kw)
    fused = Pipeline(None, sel, BATCH, seed=1, arrays={"x": feats, "y": labs}, device="cpu", **kw)
    return loop, fused


def _fit_both(feats, labs, params_np, *, epochs, superstep, log_every=1, selector=None,
              eval_fn=None, **pipe_kw):
    loop_pipe, fused_pipe = _pipelines(feats, labs, selector, **pipe_kw)
    total = loop_pipe.steps_per_epoch() * epochs
    step = tsession._classifier_step_fn(SUB_STEPS)
    tcfg = TrainerConfig(epochs=epochs, log_every_steps=log_every,
                         eval_every_epochs=1 if eval_fn else 0)
    tr_loop = Trainer(step, loop_pipe, tcfg, eval_fn=eval_fn)
    tr_fused = Trainer(step, fused_pipe, tcfg, eval_fn=eval_fn, fused=True, superstep=superstep)
    assert tr_fused.fused_active() and not tr_loop.fused_active()
    s_loop = tr_loop.fit(_state(params_np, total))
    s_fused = tr_fused.fit(_state(params_np, total))
    return (s_loop, tr_loop), (s_fused, tr_fused)


def _assert_bit_equal(loop, fused):
    (s_loop, tr_loop), (s_fused, tr_fused) = loop, fused
    assert int(s_loop.step) == int(s_fused.step)
    for k in s_loop.params:
        assert torch.equal(s_loop.params[k], s_fused.params[k]), k
        assert torch.equal(s_loop.mom[k], s_fused.mom[k]), k
    assert len(tr_loop.history) == len(tr_fused.history) > 0
    for ha, hb in zip(tr_loop.history, tr_fused.history):
        assert {k: v for k, v in ha.items() if k != "wall"} == \
               {k: v for k, v in hb.items() if k != "wall"}


# ---------------------------------------------------------------------------
# device_epoch and segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("start", [0, 2])
def test_device_epoch_matches_epoch_batches(data, drop, start):
    """device_epoch's (indices, weights) stream is exactly the content of
    epoch()'s batches, including start_step offsets and wrap padding."""
    feats, labs = data
    pipe = Pipeline(None, _WeightedSelector(k=90), BATCH, seed=2, drop_remainder=drop,
                    arrays={"x": feats, "y": labs}, device="cpu")
    idx, w = pipe.device_epoch(4, start_step=start)
    assert idx.dtype == torch.int64 and w.dtype == torch.float32
    batches = list(pipe.epoch(4, start_step=start))
    assert idx.shape == (len(batches), BATCH) == (pipe.steps_per_epoch() - start, BATCH)
    for t, b in enumerate(batches):
        np.testing.assert_array_equal(feats[idx[t].numpy()], b["x"])
        np.testing.assert_array_equal(w[t].numpy(), b["weights"])


def test_device_epoch_matches_reference(data):
    feats, labs = data
    sel_t = tsel.build_selector("random", n=N, k=90, seed=7)
    sel_j = jsel.build_selector("random", n=N, k=90, seed=7)
    for drop in (True, False):
        pt = Pipeline(None, sel_t, BATCH, seed=2, drop_remainder=drop,
                      arrays={"x": feats, "y": labs}, device="cpu")
        pj = JPipeline(None, sel_j, BATCH, seed=2, drop_remainder=drop,
                       arrays={"x": feats, "y": labs})
        for t, j in zip(pt.device_epoch(3, start_step=1), pj.device_epoch(3, start_step=1)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_pipeline_arrays_validation(data):
    feats, labs = data
    sel = tsel.build_selector("random", n=N, k=K, seed=0)
    with pytest.raises(ValueError, match="length"):
        Pipeline(None, sel, BATCH, arrays={"x": feats, "y": labs[:-1]})
    with pytest.raises(ValueError, match="weight_key"):
        Pipeline(None, sel, BATCH, arrays={"x": feats, "weights": np.ones(N, np.float32)})
    with pytest.raises(ValueError, match="arrays"):
        Pipeline(None, sel, BATCH)
    plain = Pipeline(lambda i: {"x": feats[i]}, sel, BATCH)
    assert not plain.supports_device_epoch
    with pytest.raises(ValueError, match="device_epoch"):
        plain.device_epoch(0)


def test_segment_length_boundaries():
    assert segment_length(32, 0, 100, 0) == 32
    assert segment_length(32, 0, 7, 0) == 7
    assert segment_length(8, 13, 100, 5) == 2     # next checkpoint at step 15
    assert segment_length(8, 15, 100, 5) == 5
    assert segment_length(1, 0, 100, 0) == 1
    assert segment_length(32, 128, 28, 0) == 28   # phase 14's remainder segment
    with pytest.raises(ValueError):
        segment_length(0, 0, 10, 0)


# ---------------------------------------------------------------------------
# fused against loop, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("superstep", [1, 4, 6, 32])
def test_fused_matches_loop_bit_for_bit(data, params_np, superstep):
    """Supersteps below, at and above the epoch length (6 steps)."""
    feats, labs = data
    loop, fused = _fit_both(feats, labs, params_np, epochs=3, superstep=superstep)
    _assert_bit_equal(loop, fused)
    assert int(fused[0].step) == 18 and len(fused[1].history) == 18


def test_fused_log_every_weights_and_evals_bit_for_bit(data, params_np):
    """Non-uniform plan weights reach the on-device batches, log_every_steps
    > 1 thins history identically, and eval records land at the same
    places."""
    feats, labs = data

    @torch.no_grad()
    def eval_fn(state):
        return {"pnorm": torch.sqrt(sum((p * p).sum() for p in state.params.values()))}

    loop, fused = _fit_both(feats, labs, params_np, epochs=3, superstep=4, log_every=4,
                            selector=_WeightedSelector(), eval_fn=eval_fn)
    _assert_bit_equal(loop, fused)
    assert [h["step"] for h in fused[1].history if "loss" in h] == [4, 8, 12, 16]
    assert [h["epoch"] for h in fused[1].history if h.get("eval")] == [0, 1, 2]
    # the weights do move the loss
    _, unweighted = _fit_both(feats, labs, params_np, epochs=3, superstep=4, log_every=4,
                              selector=tsel.build_selector("random", n=N, k=K, seed=0))
    assert not torch.equal(unweighted[0].params["w1"], fused[0].params["w1"])


def test_fused_wrap_padded_remainder_bit_for_bit(data, params_np):
    feats, labs = data
    sel = tsel.build_selector("random", n=N, k=90, seed=5)   # 90 % 16 != 0
    loop, fused = _fit_both(feats, labs, params_np, epochs=2, superstep=4, selector=sel,
                            drop_remainder=False)
    _assert_bit_equal(loop, fused)
    assert int(fused[0].step) == 12


def test_fused_falls_back_without_column_store(data, params_np):
    """A custom make_batch pipeline (no arrays) takes the loop path (the
    reference's rule); a custom put_batch forces it too."""
    feats, labs = data
    loop_pipe, fused_pipe = _pipelines(feats, labs)
    step = tsession._classifier_step_fn(SUB_STEPS)
    tr = Trainer(step, loop_pipe, TrainerConfig(epochs=1), fused=True)
    assert not tr.fused_active()
    assert int(tr.fit(_state(params_np, 6)).step) == 6
    tr2 = Trainer(step, fused_pipe, TrainerConfig(epochs=1), fused=True,
                  put_batch=lambda b: {k: torch.as_tensor(v) for k, v in b.items()})
    assert not tr2.fused_active()


def test_engine_updates_in_place_and_is_cached(data, params_np):
    """The returned state is the caller's (updated in place); the engine is
    shared per (step, weight key, guard); make_superstep equals the engine
    on the same batches; the guarded engine equals it on healthy data."""
    feats, labs = data
    step = tsession._classifier_step_fn(SUB_STEPS)
    engine = epoch_engine(step)
    assert epoch_engine(step) is engine and epoch_engine(step, weight_key=None) is not engine
    bufs = {"x": torch.as_tensor(feats), "y": torch.as_tensor(labs)}
    idx = torch.arange(32, dtype=torch.int64).reshape(2, 16)
    w = torch.ones((2, 16))
    state = _state(params_np, 10)
    w1 = state.params["w1"]
    out, metrics = engine(state, bufs, idx, w)
    assert out.params["w1"] is w1 and int(out.step) == 2
    assert metrics["loss"].shape == (2,)
    assert torch.equal(bufs["x"], torch.as_tensor(feats))
    superstep = make_superstep(step)
    s2, m2 = superstep(_state(params_np, 10), {"x": bufs["x"][idx], "y": bufs["y"][idx],
                                              "weights": w})
    assert torch.equal(m2["loss"], metrics["loss"])
    assert all(torch.equal(s2.params[k], out.params[k]) for k in out.params)
    # the guarded engine: its own cache entry; on healthy data the same
    # state and losses, and a zero skip flag per step
    from repro_torch.health import GUARD_KEY, GuardPolicy

    guarded = epoch_engine(step, guard=GuardPolicy())
    assert guarded is not engine and epoch_engine(step, guard=GuardPolicy()) is guarded
    s3, m3 = guarded(_state(params_np, 10), bufs, idx, w)
    assert torch.equal(m3["loss"], metrics["loss"]) and m3[GUARD_KEY].tolist() == [0.0, 0.0]
    assert all(torch.equal(s3.params[k], out.params[k]) for k in out.params)
    assert int(s3.step) == 2
    s4, m4 = make_superstep(step, guard=GuardPolicy())(
        _state(params_np, 10), {"x": bufs["x"][idx], "y": bufs["y"][idx], "weights": w})
    assert torch.equal(m4["loss"], metrics["loss"]) and m4[GUARD_KEY].tolist() == [0.0, 0.0]
    assert all(torch.equal(s4.params[k], out.params[k]) for k in out.params)
    assert engine_mod.captures == engine_mod.replays == 0, "no graph on the CPU"


# ---------------------------------------------------------------------------
# the session, and the reference's fused path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("selector,batch_size", [("random", BATCH), ("full", 0),
                                                ("adaptive_random", 24)])
def test_session_fused_training_matches_loop(data, selector, batch_size):
    feats, labs = data
    base = dict(selector=selector, subset_fraction=K / N, total_epochs=4,
                batch_size=batch_size, superstep=4, seed=0, device="cpu")
    r_loop = tsel.MiloSession(**base).train(feats, labs, test_x=feats[:40], test_y=labs[:40])
    r_fused = tsel.MiloSession(fused_training=True, **base).train(
        feats, labs, test_x=feats[:40], test_y=labs[:40])
    assert r_loop.steps == r_fused.steps > 0
    assert r_loop.final_acc == r_fused.final_acc
    assert len(r_loop.history) == len(r_fused.history)
    for ha, hb in zip(r_loop.history, r_fused.history):
        assert {k: v for k, v in ha.items() if k != "wall"} == \
               {k: v for k, v in hb.items() if k != "wall"}


def test_fused_matches_reference_fused(data, params_np):
    """The port's fused path against the reference's (``lax.scan``) on the
    session's step function, from the same parameters and plans."""
    feats, labs = data
    epochs = 3
    sel_j = jsel.build_selector("adaptive_random", n=N, k=K, R=1, seed=3)
    sel_t = tsel.build_selector("adaptive_random", n=N, k=K, R=1, seed=3)
    pipe_j = JPipeline(None, sel_j, BATCH, seed=1, arrays={"x": feats, "y": labs})
    pipe_t = Pipeline(None, sel_t, BATCH, seed=1, arrays={"x": feats, "y": labs}, device="cpu")
    steps = pipe_t.steps_per_epoch() * epochs
    state_j = jsession._ClassifierState(
        {k: jnp.asarray(v) for k, v in params_np.items()},
        {k: jnp.zeros_like(jnp.asarray(v)) for k, v in params_np.items()},
        jnp.zeros((), jnp.int32), jnp.asarray(0.05, jnp.float32), jnp.asarray(steps, jnp.float32))
    tr_j = JTrainer(jsession._classifier_step_fn(SUB_STEPS), pipe_j,
                    JTrainerConfig(epochs=epochs, log_every_steps=1), fused=True, superstep=4)
    tr_t = Trainer(tsession._classifier_step_fn(SUB_STEPS), pipe_t,
                   TrainerConfig(epochs=epochs, log_every_steps=1), fused=True, superstep=4)
    assert tr_j.fused_active() and tr_t.fused_active()
    state_j = tr_j.fit(state_j, resume=False)
    state_t = tr_t.fit(_state(params_np, steps))
    assert int(state_t.step) == int(state_j.step) == steps
    losses_j = [h["loss"] for h in tr_j.history]
    losses_t = [h["loss"] for h in tr_t.history]
    assert len(losses_t) == len(losses_j) == steps
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-5)
    assert [(h["step"], h["epoch"], h["phase"]) for h in tr_t.history] == \
           [(h["step"], h["epoch"], h["phase"]) for h in tr_j.history]
    for k in params_np:
        np.testing.assert_allclose(state_t.params[k].detach().numpy(),
                                   np.asarray(state_j.params[k]), rtol=1e-5, atol=1e-6)
