"""The port's checkpoints and restart: ``checkpoint.checkpointer``, the
copied ``distributed.fault_tolerance`` pieces and the trainer's resume.

Mirrors ``tests/test_fault_tolerance.py``: torn and corrupted checkpoints
are skipped (damaged with the reference's own ``corrupt_checkpoint``), an
async write failure re-raises on ``wait``, GC never deletes an in-flight
step, a SIGKILLed run resumes bit-identically on the loop and fused paths,
and a device-count change surfaces an elastic plan.  Across packages, a
checkpoint written by either restores in the other leaf for leaf, and the
port's npz entries are byte-identical to the reference's (bf16 included).
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import threading
import zipfile

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import CheckpointManager as JManager
from repro.configs import registry as jreg
from repro.distributed import fault_tolerance as jft
from repro.optim import optimizers as jopt
from repro.testing.faults import CORRUPTION_MODES, corrupt_checkpoint
from repro.train import train_state as jts
from repro_torch import tree as T
from repro_torch.checkpoint.checkpointer import CheckpointCorruptionError, CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import Pipeline
from repro_torch.distributed import fault_tolerance as tft
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizers as topt
from repro_torch.selection import build_selector
from repro_torch.train import train_state as tts

torch.set_num_threads(1)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(offset: float = 0.0):
    return {"a": torch.arange(12.0).reshape(3, 4) + offset,
            "b": {"c": torch.ones(64) * (1 + offset)}}


# ---------------------------------------------------------------------------
# the copied fault-tolerance pieces give the reference's outputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,spe", [(0, 0, 6), (11, 8, 6), (3, 25, 4), (7, 100, 1)])
def test_restart_state_matches_reference(seed, step, spe):
    assert tft.restart_state(seed, step, spe) == jft.restart_state(seed, step, spe)


@pytest.mark.parametrize("n,mp,batch,mb", [(8, 1, 64, 8), (4, 2, 64, 16), (6, 1, 48, 4),
                                           (3, 1, 16, 4), (5, 1, 16, 4), (8, 3, 16, 2)])
def test_elastic_plan_matches_reference(n, mp, batch, mb):
    def plan(mod):
        try:
            return dataclasses.astuple(mod.elastic_plan(
                n, model_parallel=mp, global_batch=batch, microbatch_per_replica=mb))
        except ValueError as e:
            return ("ValueError", str(e))

    assert plan(tft) == plan(jft)


def test_straggler_monitor_matches_reference():
    rng = np.random.default_rng(0)
    dts = list(rng.uniform(0.09, 0.11, 30)) + [0.5] + list(rng.uniform(0.09, 0.11, 10)) + [0.9]
    mt, mj = tft.StragglerMonitor(), jft.StragglerMonitor()
    flags = [(mt.observe(i, dt), mj.observe(i, dt)) for i, dt in enumerate(dts)]
    assert all(a == b for a, b in flags) and mt.flagged == mj.flagged
    assert mt.flagged and mt.mean_step_time == mj.mean_step_time


def test_restart_state_matches_pipeline_replay():
    n, k, batch, seed = 128, 64, 16, 11
    sel = build_selector("adaptive_random", n=n, k=k, R=1, seed=3)
    pipe = Pipeline(None, sel, batch, seed=seed, arrays={"x": np.zeros((n, 4), np.float32)},
                    device="cpu")
    spe = pipe.steps_per_epoch()
    cur = tft.restart_state(seed, spe + 2, spe)
    assert cur["epoch"] == 1 and cur["step_in_epoch"] == 2
    assert cur["data_seed"] == seed * 1_000_003 + cur["epoch"]
    full_idx, full_w = pipe.device_epoch(1)
    res_idx, res_w = pipe.device_epoch(cur["epoch"], start_step=cur["step_in_epoch"])
    assert torch.equal(res_idx, full_idx[2:]) and torch.equal(res_w, full_w[2:])


# ---------------------------------------------------------------------------
# checkpoint hardening: validation, torn-checkpoint skipping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", CORRUPTION_MODES)
def test_corrupted_checkpoint_detected_and_skipped(tmp_path, mode):
    mgr = CheckpointManager(str(tmp_path), keep_last=5)
    for step in (1, 2, 3):
        mgr.save(step, _tree(step))
    damaged = corrupt_checkpoint(str(tmp_path), 3, mode=mode)
    assert os.path.basename(os.path.dirname(damaged)) == "step_3"
    assert mgr.all_steps() == [1, 2, 3]
    assert not mgr.is_valid_step(3) and mgr.is_valid_step(2)
    assert mgr.latest_valid_step() == 2
    with pytest.raises(CheckpointCorruptionError):
        mgr.restore(3, _tree())
    out = mgr.restore(2, _tree())
    assert torch.equal(out["a"], torch.arange(12.0).reshape(3, 4) + 2)


def test_latest_valid_step_none_when_all_damaged(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    corrupt_checkpoint(str(tmp_path), 1, mode="truncate_manifest")
    assert mgr.latest_valid_step() is None


def test_async_save_failure_reraises_on_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))

    def boom(step, host, extra=None):
        raise OSError("disk gone")

    mgr._write = boom
    mgr.save_async(7, _tree())
    with pytest.raises(OSError, match="disk gone"):
        mgr.wait()
    mgr.wait()   # the error is consumed


def test_gc_never_deletes_inflight_async_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=1)
    gate = threading.Event()
    orig_write = mgr._write

    def gated_write(step, host, extra=None):
        if step == 5:
            assert gate.wait(30)
        return orig_write(step, host, extra)

    mgr._write = gated_write
    mgr.save_async(5, _tree())       # blocked mid-write, registered in-flight
    mgr.save(6, _tree())             # concurrent sync save triggers GC
    with mgr._lock:
        assert 5 in mgr._inflight
    gate.set()
    mgr.wait()
    assert mgr.is_valid_step(5) and mgr.is_valid_step(6)
    assert set(mgr.last_save) == {"step", "snapshot_s", "write_s", "sha256_s", "sha256_wait_s",
                                  "bytes"}


def test_async_save_snapshots_before_returning(tmp_path):
    """The host snapshot is taken in ``save_async``: later in-place updates
    do not reach the checkpoint."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save_async(1, tree)
    tree["a"].add_(100.0)
    mgr.wait()
    assert torch.equal(mgr.restore(1, tree)["a"], torch.arange(12.0).reshape(3, 4))


# ---------------------------------------------------------------------------
# across packages: the LM's TrainState (bf16 leaves) both ways
# ---------------------------------------------------------------------------

def _lm_states(dtype="bfloat16"):
    jcfg = dataclasses.replace(jreg.smoke("granite-moe-1b-a400m"), dtype=dtype)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    js = jts.init_train_state(jax.random.PRNGKey(0), jcfg, jopt.adamw())
    ts = tts.init_train_state(tcfg, topt.adamw(), seed=1, device="cpu")
    return js, ts


def _raw(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 and a.dtype.kind in "V" or \
        a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lm_checkpoint_crosses_packages_both_ways(tmp_path, dtype):
    js, ts = _lm_states(dtype)
    # reference -> port: every leaf of the port's state is the reference's
    JManager(str(tmp_path / "j")).save(3, js, extra={"device_count": 1})
    got = CheckpointManager(str(tmp_path / "j")).restore(3, ts)
    assert got.params["embed"].dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    as_jax = jts.TrainState(params=tlm.params_to_jax(got.params),
                            opt_state={"m": tlm.params_to_jax(got.opt_state["m"]),
                                       "t": got.opt_state["t"].numpy(),
                                       "v": tlm.params_to_jax(got.opt_state["v"])},
                            step=got.step.numpy())
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(as_jax)):
        assert np.shape(a) == np.shape(b) and np.array_equal(_raw(a), _raw(b))
    assert got.step.dtype == torch.int32 and got.opt_state["t"].dtype == torch.int32
    # port -> reference: validates there and restores to the same leaves
    CheckpointManager(str(tmp_path / "t")).save(5, got)
    jm = JManager(str(tmp_path / "t"))
    assert jm.latest_valid_step() == 5
    back = jm.restore(5, js)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back)):
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(_raw(a), _raw(b))
    # the shard files hold the same npy entries, byte for byte
    zj = zipfile.ZipFile(tmp_path / "j" / "step_3" / "shard_0.npz")
    zt = zipfile.ZipFile(tmp_path / "t" / "step_5" / "shard_0.npz")
    assert zj.namelist() == zt.namelist()
    assert all(zj.read(n) == zt.read(n) for n in zj.namelist())
    assert jm.manifest(5)["leaves"] == JManager(str(tmp_path / "j")).manifest(3)["leaves"]


# ---------------------------------------------------------------------------
# kill-and-resume: SIGKILL mid-epoch, bit-identical final state + history
# ---------------------------------------------------------------------------

FAULT_SCRIPT = r"""
import json, os, signal, sys
mode, path, ckpt_dir, out = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4]
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.data.pipeline import Pipeline
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.selection import build_selector
from repro_torch.selection import session as S
from repro_torch.train.trainer import Trainer, TrainerConfig

N, D, C, K, BATCH = 256, 8, 4, 96, 16      # 6 steps per epoch
rng = np.random.default_rng(0)
feats = rng.normal(size=(N, D)).astype(np.float32)
labs = rng.integers(0, C, size=N).astype(np.int64)

class KillAtStep(StragglerMonitor):
    def __init__(self, kill_step):
        super().__init__()
        self.kill_step = kill_step
    def observe(self, step, dt):
        if step >= self.kill_step:
            os.kill(os.getpid(), signal.SIGKILL)
        return super().observe(step, dt)

sel = build_selector("adaptive_random", n=N, k=K, R=1, seed=3)
pipe = Pipeline(None, sel, BATCH, seed=1, arrays={"x": feats, "y": labs}, device="cpu")
tr = Trainer(S._classifier_step_fn(1), pipe,
             TrainerConfig(epochs=3, checkpoint_dir=ckpt_dir, checkpoint_every_steps=5,
                           async_checkpoint=True, log_every_steps=1),
             fused=path == "fused", superstep=32)
if mode == "kill":
    # dies at the first boundary past step 13 (mid-epoch 2): the save at 10
    # waited for the async save at 5, so at least that one is on disk
    tr.monitor = KillAtStep(14)
state = tr.fit(S._init_classifier(0, D, C, 16, 0.05, 18, torch.device("cpu")), resume=True)
flat = {f"p{k}": v.detach().numpy() for k, v in state.params.items()}
flat.update({f"m{k}": v.numpy() for k, v in state.mom.items()})
np.savez(out + ".npz", step=int(state.step), **flat)
hist = [{k: v for k, v in h.items() if k != "wall"} for h in tr.history if "loss" in h]
json.dump(hist, open(out + ".hist.json", "w"))
print("RUN_COMPLETE", int(state.step))
"""


def _run_child(argv, *, expect_sigkill=False, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-c", FAULT_SCRIPT, *argv], capture_output=True,
                       text=True, env=env, cwd=REPO_ROOT, timeout=timeout)
    if expect_sigkill:
        assert r.returncode == -signal.SIGKILL, (r.returncode, r.stdout[-1000:], r.stderr[-2000:])
    else:
        assert r.returncode == 0, r.stderr[-2000:]
    return r


@pytest.mark.parametrize("path", ["loop", "fused"])
def test_kill_and_resume_bit_identical(tmp_path, path):
    ref_out = str(tmp_path / "ref")
    _run_child(["ref", path, str(tmp_path / "ref_ckpt"), ref_out])
    ckpt = str(tmp_path / "ckpt")
    r = _run_child(["kill", path, ckpt, str(tmp_path / "dead")], expect_sigkill=True)
    assert "RUN_COMPLETE" not in r.stdout
    res_out = str(tmp_path / "res")
    _run_child(["run", path, ckpt, res_out])
    with np.load(ref_out + ".npz") as ref, np.load(res_out + ".npz") as res:
        assert int(ref["step"]) == int(res["step"]) == 18
        for k in ref.files:
            np.testing.assert_array_equal(ref[k], res[k])
    ref_h = json.load(open(ref_out + ".hist.json"))
    res_h = json.load(open(res_out + ".hist.json"))
    assert 0 < len(res_h) < len(ref_h)
    assert res_h == ref_h[len(ref_h) - len(res_h):]


def test_resume_surfaces_elastic_plan_on_device_count_change(tmp_path):
    from repro_torch.selection import session as S
    from repro_torch.train.trainer import Trainer, TrainerConfig

    N, D, C, K, BATCH = 128, 8, 4, 64, 16
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(N, D)).astype(np.float32)
    labs = rng.integers(0, C, size=N).astype(np.int64)
    sel = build_selector("adaptive_random", n=N, k=K, R=1, seed=3)
    pipe = Pipeline(None, sel, BATCH, seed=1, arrays={"x": feats, "y": labs}, device="cpu")
    tr = Trainer(S._classifier_step_fn(1), pipe,
                 TrainerConfig(epochs=2, checkpoint_dir=str(tmp_path)), fused=True)
    state = S._init_classifier(0, D, C, 16, 0.05, 8, torch.device("cpu"))
    # a checkpoint written by a (fictional) 4-device run of the same job
    tr.ckpt.save(4, state, extra={"device_count": 4, "batch_size": BATCH, "data_seed": 1})
    tr.fit(state, resume=True)
    assert tr.elastic is not None and tr.elastic.grad_accum == 4   # 16 / (1 device * mb 4)
    recs = [h for h in tr.history if h.get("elastic")]
    assert len(recs) == 1 and recs[0]["step"] == 4 and recs[0]["mesh_shape"] == [1, 1]


# ---------------------------------------------------------------------------
# examples/train_lm_milo.py's flow, stricter: past a corrupted checkpoint
# ---------------------------------------------------------------------------

def test_lm_kill_and_resume_past_a_corrupted_checkpoint(tmp_path):
    """The smoke granite-moe LM on MILO subsets (chunked attention, remat,
    bf16): a checkpoint every 16 of 24 steps; the newest one's shard loses
    one byte; a fresh Trainer resumes from step 16 and replays to the end —
    parameters, both Adam moments and the replayed history bit-equal."""
    from repro_torch.configs import registry
    from repro_torch.core.milo import MiloPreprocessor
    from repro_torch.data.datasets import TokenLMDataset
    from repro_torch.optim.schedules import cosine
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = dataclasses.replace(registry.smoke("granite-moe-1b-a400m"), attention_impl="chunked",
                              remat=True, dtype="bfloat16")
    ds = TokenLMDataset(n_docs=256, seq_len=64, vocab=cfg.vocab_size, seed=0)
    md = MiloPreprocessor(subset_fraction=0.5, n_sge_subsets=4, classwise=False,
                          device="cpu").preprocess(ds.features(), None, seed=0)
    assert md.k // 16 == 8
    sel = build_selector("milo", metadata=md, total_epochs=3, kappa=1 / 6, R=1, device="cpu")
    pipe = Pipeline(ds.batch, sel, 16, seed=0, device="cpu")
    opt = topt.adamw()
    step_fn = tts.make_train_step(cfg, opt, cosine(1e-3, 24, warmup=10))
    tcfg = TrainerConfig(epochs=3, checkpoint_dir=str(tmp_path), checkpoint_every_steps=16,
                         log_every_steps=4)
    tr = Trainer(step_fn, pipe, tcfg)
    ref = tr.fit(tts.init_train_state(cfg, opt, seed=0, device="cpu"), resume=False)
    assert tr.ckpt.all_steps() == [16, 24] and int(ref.step) == 24
    losses = [h["loss"] for h in tr.history if "loss" in h]
    assert losses[-1] < losses[0]
    shard = tmp_path / "step_24" / "shard_0.npz"
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0xFF
    shard.write_bytes(bytes(data))
    assert tr.ckpt.latest_valid_step() == 16
    tr2 = Trainer(step_fn, pipe, tcfg)
    resumed = tr2.fit(tts.init_train_state(cfg, opt, seed=7, device="cpu"), resume=True)
    for a, b in zip(T.leaves(ref), T.leaves(resumed)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    strip = lambda hs: [{k: v for k, v in h.items() if k != "wall"} for h in hs]  # noqa: E731
    assert strip(tr2.history) == strip([h for h in tr.history if h["step"] > 16])
    assert tr2.ckpt.latest_valid_step() == 24   # the replay rewrote the damaged step
