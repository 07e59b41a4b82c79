"""Multi-host execution in the port (``repro_torch.distributed.multihost``,
``compression``, the two-phase checkpoint commit, the Trainer's heartbeats
and the multi-process fault helpers) against the reference.

In-process: the single-process cases of ``tests/test_multihost.py`` —
``initialize`` a no-op without the env, the single-rank mesh and
``global_put``, ``FileBarrier`` (which meets the reference's), the two-phase
save simulated on two threads over a ``FileBarrier`` (one global manifest, a
torn shard skipped on every host, a dead host publishing nothing, no
barrier refused, the single-host format unchanged, a resume recording the
topology change), two-host checkpoints crossing packages both ways, int8
round trips, error feedback, checksums whose bits are the reference's, and
the compressed set function's guard.  The knobs that used to refuse now
work: ``shard_selection`` without a process group takes the single-device
path, ``multihost_init`` without the env is a no-op, ``heartbeat_dir``
writes beacons the reference's monitor reads.

Two-process jobs (gloo CPU processes started by the port's
``launch_hosts``, each launch with a timeout of its own): a selection plan
on 2 ranks against 1 process, and a SIGKILLed host whose survivor exits
with ``HostLossError`` and whose restarted pair ends bit-equal to an
uninterrupted 2-rank run and to 1 process.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import CheckpointManager as JManager
from repro.distributed import compression as jcomp
from repro.distributed import multihost as jmh
from repro_torch.checkpoint.checkpointer import CheckpointManager
from repro_torch.core import greedy as tg
from repro_torch.core import gram_free as tgf
from repro_torch.core import sharded as tsh
from repro_torch.data.pipeline import Pipeline
from repro_torch.distributed import compression as tcomp
from repro_torch.distributed import multihost
from repro_torch.distributed.fault_tolerance import HostLossError
from repro_torch.distributed.multihost import FileBarrier
from repro_torch.distributed.sharding import selection_mesh
from repro_torch.selection import build_selector
from repro_torch.selection import session as S
from repro_torch.testing.faults import launch_hosts
from repro_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_ENV = {"PYTHONPATH": os.path.join(REPO_ROOT, "src"), "OMP_NUM_THREADS": "1"}


def _tree(offset: float = 0.0):
    return {"a": torch.arange(12.0).reshape(3, 4) + offset,
            "b": {"c": torch.ones(64) * (1 + offset)}}


def _jtree(offset: float = 0.0):
    return {"a": jnp.arange(12.0).reshape(3, 4) + offset,
            "b": {"c": jnp.ones((64,), jnp.float32) * (1 + offset)}}


# ---------------------------------------------------------------------------
# runtime primitives; the knobs that used to refuse
# ---------------------------------------------------------------------------

def test_initialize_is_noop_without_multihost_env(monkeypatch):
    for var in ("MILO_COORDINATOR", "MILO_NUM_PROCESSES", "MILO_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert multihost.initialize("localhost:1", num_processes=1) is False
    assert not multihost.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.is_coordinator()
    assert multihost.default_barrier() is None
    # the session's knob: a no-op without the env, as the reference's
    s = S.MiloSession(multihost_init=True, device="cpu")
    assert s.config.multihost_init and not multihost.is_initialized()


def test_backend_choice_never_swaps_a_named_backend():
    assert multihost.choose_backend("gloo", 2) == "gloo"
    if not torch.cuda.is_available():
        assert multihost.choose_backend(None, 2) == "gloo"
        with pytest.raises(ValueError, match="share"):
            multihost.choose_backend("nccl", 2)
    with pytest.raises(ValueError, match="unknown backend"):
        multihost.choose_backend("mpi", 1)


@pytest.mark.parametrize("hosts,cards,want", [
    (("a", "b"), 1, ([(1, 0), (1, 0)], "nccl")),             # 2 hosts x 1 card
    (("a",) * 8 + ("b",) * 8, 8, ([(8, i % 8) for i in range(16)], "nccl")),
    (("a", "a"), 1, ([(2, 0), (2, 1)], "gloo")),             # 2 ranks share 1 card
])
def test_local_layout_counts_the_ranks_on_each_host(monkeypatch, hosts, cards, want):
    """Without ``LOCAL_WORLD_SIZE`` each rank posts its host name to the
    store and counts the ranks that share it: a multi-node job picks NCCL
    when each rank has a card of its own, and gloo only where ranks share."""
    store = torch.distributed.HashStore()
    got = [None] * len(hosts)

    def rank(i):
        got[i] = multihost.local_layout(store, i, len(hosts), host=hosts[i], timeout=10.0)

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(len(hosts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=20)
    layout, backend = want
    assert got == layout
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert {multihost.choose_backend(None, n) for n, _ in got} == {backend}


def test_only_a_lost_peer_becomes_host_loss():
    """A collective's error is a ``HostLossError`` only for the transports'
    lost-peer wording; a live job's own error (an NCCL usage error, out of
    memory) propagates as it is."""
    from repro_torch.distributed.sharding import SelectionMesh, is_host_loss

    mesh = SelectionMesh(object(), (0, 1), 0)
    for text in ("[gloo/transport/tcp/pair.cc:534] Connection closed by peer [127.0.0.1]:1",
                 "Connection reset by peer", "Timed out waiting 60000ms for recv operation",
                 "Watchdog caught collective operation timeout: WorkNCCL(SeqNum=3)",
                 "NCCL error: remote process exited or there was a network error"):
        assert is_host_loss(RuntimeError(text)), text

        def fail(*a, text=text, **kw):
            raise RuntimeError(text)

        with pytest.raises(HostLossError):
            mesh._call("all_gather", fail)
    for text in ("NCCL error in: ProcessGroupNCCL.cpp:1970, invalid usage",
                 "CUDA out of memory. Tried to allocate 2.00 GiB"):
        assert not is_host_loss(RuntimeError(text)), text

        def fail(*a, text=text, **kw):
            raise RuntimeError(text)

        with pytest.raises(RuntimeError) as ei:
            mesh._call("all_gather", fail)
        assert not isinstance(ei.value, HostLossError)
    assert is_host_loss(torch.distributed.DistNetworkError("socket"))


def test_single_process_mesh_and_global_put_round_trip():
    mesh = selection_mesh()
    assert mesh.size == 1 and mesh.shape["sel"] == 1 and mesh.group is None
    assert selection_mesh() is mesh
    assert not multihost.mesh_spans_processes(mesh)
    x = torch.arange(12.0).reshape(4, 3)
    assert multihost.global_put(x, mesh) is x
    shard = multihost.global_put(x, mesh, (mesh.axis, None))
    assert torch.equal(shard.local, x) and shard.n == 4 and shard.offset == 0
    with pytest.raises(ValueError, match="out of range"):
        selection_mesh(2)


def test_file_barrier_rendezvous_timeout_and_the_references(tmp_path):
    root = str(tmp_path / "bar")
    b0 = FileBarrier(root, 0, 2, timeout=10.0)
    b1 = jmh.FileBarrier(root, 1, 2, timeout=10.0)      # the reference's meets the port's
    t = threading.Thread(target=b1.wait, args=("go",))
    t.start()
    b0.wait("go")
    t.join(timeout=10)
    assert not t.is_alive()
    alone = FileBarrier(str(tmp_path / "bar2"), 0, 2, timeout=0.2)
    with pytest.raises(HostLossError) as ei:
        alone.wait("nobody_comes")
    assert ei.value.hosts == (1,)


def _tiny_trainer(tmp_path, **tcfg):
    N, D, C = 64, 8, 4
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(N, D)).astype(np.float32)
    labs = rng.integers(0, C, size=N).astype(np.int64)
    sel = build_selector("adaptive_random", n=N, k=32, R=1, seed=3)
    pipe = Pipeline(None, sel, 16, seed=1, arrays={"x": feats, "y": labs}, device="cpu")
    tr = Trainer(S._classifier_step_fn(1), pipe, TrainerConfig(log_every_steps=1, **tcfg))
    return tr, S._init_classifier(0, D, C, 16, 0.05, 8, torch.device("cpu"))


def test_heartbeat_dir_writes_beacons_the_reference_reads(tmp_path):
    hb = str(tmp_path / "hb")
    tr, state = _tiny_trainer(tmp_path, epochs=2, heartbeat_dir=hb)
    tr.fit(state)
    mon = jmh.HeartbeatMonitor(hb, timeout=60.0, expected=1)
    assert mon.stale_hosts() == [] and set(mon.ages()) == {0}
    with open(os.path.join(hb, "host_0.json")) as f:
        beat = json.load(f)
    assert beat["process_index"] == 0 and beat["step"] == 3    # the last boundary: 4 steps
    # a peer whose beacon is stale stops the run with HostLossError
    jmh.HeartbeatWriter(hb, 1, clock=lambda: time.time() - 1000.0).beat(0)
    tr2, state2 = _tiny_trainer(tmp_path, epochs=1, heartbeat_dir=hb, heartbeat_timeout=5.0)
    with pytest.raises(HostLossError) as ei:
        tr2.fit(state2)
    assert ei.value.hosts == (1,)


def test_shard_selection_without_a_process_group_is_the_single_device_path():
    """One rank: every class takes the single-device path and the artifact
    is the unsharded one, bit for bit (``shard_selection`` is provenance)."""
    from repro_torch.core.milo import MiloPreprocessor

    rng = np.random.default_rng(14)
    labels = np.repeat(np.arange(3), [40, 30, 20])
    feats = rng.normal(size=(90, 12)).astype(np.float32)
    kw = dict(subset_fraction=0.1, gram_free=True, device="cpu")
    a = MiloPreprocessor(**kw).preprocess(feats, labels, 0)
    b = MiloPreprocessor(shard_selection=True, **kw).preprocess(feats, labels, 0)
    np.testing.assert_array_equal(a.sge_subsets, b.sge_subsets)
    np.testing.assert_array_equal(a.wre_importance, b.wre_importance)
    assert b.config["shard_selection"] is True and a.config["shard_selection"] is False
    with pytest.raises(ValueError, match="gram_free"):
        MiloPreprocessor(subset_fraction=0.1, shard_selection=True,
                         device="cpu").preprocess(feats, labels, 0)
    plan = build_selector("milo_fixed", features=feats, k=9, shard_selection=True,
                          device="cpu").plan(0)
    ref = build_selector("milo_fixed", features=feats, k=9, gram_free=True, device="cpu").plan(0)
    np.testing.assert_array_equal(plan.indices, ref.indices)


# ---------------------------------------------------------------------------
# two-phase coordinated distributed checkpoint (simulated two hosts)
# ---------------------------------------------------------------------------

def _two_host_save(make, ckpt_root, bar_root, step, tree, *, extra=None, timeout=30.0):
    """One coordinated save on two managers of class ``make`` on threads."""
    mgrs = [make(ckpt_root, process_index=i, process_count=2,
                 barrier=FileBarrier(bar_root, i, 2, timeout=timeout), barrier_timeout=timeout)
            for i in range(2)]
    errs: list[BaseException | None] = [None, None]

    def run(i):
        try:
            mgrs[i].save(step, tree, extra=extra)
        except BaseException as e:  # surfaced to the test
            errs[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a host hung in the save"
    return mgrs, errs


def test_two_phase_save_publishes_one_global_manifest(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    mgrs, errs = _two_host_save(CheckpointManager, ckpt, str(tmp_path / "bar"), 3, _tree(1.0),
                                extra={"process_count": 2})
    assert errs == [None, None]
    for mgr in mgrs:
        man = mgr.validate_step(3)
        assert man["format"] == 3 and man["num_shards"] == 2 and man["hosts"] == [0, 1]
        assert set(man["checksums"]) == {"shard_0.npz", "shard_1.npz"}
        assert man["extra"] == {"process_count": 2}
        assert mgr.latest_valid_step() == 3
    out = mgrs[0].restore(3, _tree())
    np.testing.assert_array_equal(out["a"].numpy(), np.arange(12.0).reshape(3, 4) + 1.0)
    assert not os.path.exists(os.path.join(ckpt, "step_3.tmp"))


def test_torn_multihost_shard_skipped_on_every_host(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _two_host_save(CheckpointManager, ckpt, str(tmp_path / "bar1"), 1, _tree(1.0))
    mgrs, errs = _two_host_save(CheckpointManager, ckpt, str(tmp_path / "bar2"), 2, _tree(2.0))
    assert errs == [None, None]
    shard1 = os.path.join(ckpt, "step_2", "shard_1.npz")
    with open(shard1, "r+b") as f:
        f.truncate(os.path.getsize(shard1) // 2)
    for mgr in mgrs:
        assert not mgr.is_valid_step(2)
        assert mgr.latest_valid_step() == 1
    assert JManager(ckpt).latest_valid_step() == 1      # and on the reference's


def test_dead_host_publishes_nothing(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    mgr = CheckpointManager(ckpt, process_index=0, process_count=2,
                            barrier=FileBarrier(str(tmp_path / "bar"), 0, 2, timeout=0.3),
                            barrier_timeout=0.3)
    with pytest.raises(HostLossError) as ei:
        mgr.save(5, _tree())
    assert ei.value.hosts == (1,)
    assert mgr.latest_valid_step() is None
    assert not os.path.exists(os.path.join(ckpt, "step_5"))


def test_multiprocess_manager_requires_a_barrier(tmp_path):
    """process_count > 1 with no process group and no injected barrier
    fails loudly with the reference's error, writing nothing."""
    for make in (CheckpointManager, JManager):
        mgr = make(str(tmp_path / make.__module__), process_index=0, process_count=2)
        with pytest.raises(RuntimeError, match="barrier"):
            mgr.save(1, _tree() if make is CheckpointManager else _jtree())
        assert mgr.latest_valid_step() is None


def test_single_host_manifest_format_unchanged(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    man = mgr.validate_step(1)
    assert man["format"] == 2 and man["num_shards"] == 1 and "hosts" not in man


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_two_host_checkpoints_cross_packages(tmp_path, writer):
    """A two-host checkpoint written by either package validates and
    restores in the other's ``CheckpointManager``, leaf for leaf."""
    ckpt = str(tmp_path / "ckpt")
    if writer == "port":
        _, errs = _two_host_save(CheckpointManager, ckpt, str(tmp_path / "bar"), 4, _tree(3.0),
                                 extra={"process_count": 2})
        reader = JManager(ckpt)
        out = reader.restore(4, _jtree())
        got = {"a": np.asarray(out["a"]), "c": np.asarray(out["b"]["c"])}
    else:
        _, errs = _two_host_save(JManager, ckpt, str(tmp_path / "bar"), 4, _jtree(3.0),
                                 extra={"process_count": 2})
        reader = CheckpointManager(ckpt)
        out = reader.restore(4, _tree())
        got = {"a": out["a"].numpy(), "c": out["b"]["c"].numpy()}
    assert errs == [None, None]
    man = reader.validate_step(4)
    assert man["format"] == 3 and man["num_shards"] == 2 and reader.latest_valid_step() == 4
    np.testing.assert_array_equal(got["a"], np.arange(12.0).reshape(3, 4) + 3.0)
    np.testing.assert_array_equal(got["c"], np.full(64, 4.0, np.float32))


def test_resume_from_two_host_checkpoint_records_topology_change(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    tr, state = _tiny_trainer(tmp_path, epochs=2, checkpoint_dir=ckpt)
    _, errs = _two_host_save(CheckpointManager, ckpt, str(tmp_path / "bar"), 2, state,
                             extra={"device_count": 1, "process_count": 2, "data_seed": 1,
                                    "batch_size": 16})
    assert errs == [None, None]
    tr.fit(state, resume=True)
    recs = [h for h in tr.history if h.get("elastic")]
    assert len(recs) == 1 and recs[0]["step"] == 2
    assert recs[0]["process_count"] == [2, 1]
    assert tr.elastic is None


# ---------------------------------------------------------------------------
# compression: checksummed payloads, error feedback, the exact escape hatch
# ---------------------------------------------------------------------------

def test_int8_round_trip_exact_on_grid_and_exact_escape_hatch():
    q = torch.arange(-127, 128, dtype=torch.int32).to(torch.int8)
    x = q.float() * 0.5
    p = tcomp.int8_compress_checked(x)
    assert bool(tcomp.payload_ok(p))
    assert torch.equal(p.q, q) and torch.equal(tcomp.decompress_checked(p), x)
    assert torch.equal(tcomp.int8_decompress(tcomp.Int8Compressed(p.q, p.scale)), x)
    # one rank's exact sharded run is the single-device engine, bit for bit
    rng = np.random.default_rng(0)
    from repro_torch.core.similarity import normalize_rows

    z = normalize_rows(torch.from_numpy(rng.normal(size=(64, 8)).astype(np.float32)))
    fn_exact = tsh.make_sharded_facility_location(mesh=selection_mesh(1))
    assert "_c8" not in fn_exact.name
    a = tg.greedy(tgf.get_gram_free("facility_location"), z, 8)
    b = tsh.sharded_greedy(fn_exact, z, 8, mesh=selection_mesh(1))
    assert torch.equal(a.indices, b.indices) and torch.equal(a.gains, b.gains)


def test_int8_payloads_and_checksums_are_the_references():
    """q, scale and the wrapped int32 checksum equal the reference's bits,
    on payloads long enough for every intermediate to wrap."""
    rng = np.random.default_rng(1)
    for n in (1, 257, 4096, 70001):
        x = rng.normal(size=(n,)).astype(np.float32) * 3.0
        pj = jcomp.int8_compress_checked(jnp.asarray(x))
        pt = tcomp.int8_compress_checked(torch.from_numpy(x))
        np.testing.assert_array_equal(pt.q.numpy(), np.asarray(pj.q))
        assert pt.scale.numpy().tobytes() == np.asarray(pj.scale).tobytes()
        assert pt.checksum.dtype == torch.int32
        assert int(pt.checksum) == int(pj.checksum), n
    q = rng.integers(-127, 128, size=(100000,)).astype(np.int8)
    assert int(tcomp.payload_checksum(torch.from_numpy(q))) == \
        int(jcomp.payload_checksum(jnp.asarray(q)))


def test_checksum_rejects_bit_flipped_payload():
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(257,)).astype(np.float32))
    p = tcomp.int8_compress_checked(x)
    tcomp.check_payload(p)
    q = p.q.clone()
    q[3] ^= 1
    bad = tcomp.CheckedPayload(q, p.scale, p.checksum)
    assert not bool(tcomp.payload_ok(bad))
    assert torch.isnan(tcomp.decompress_checked(bad)).all()
    with pytest.raises(tcomp.CompressionIntegrityError):
        tcomp.check_payload(bad)


def test_error_feedback_deterministic_under_fixed_seed():
    rng = np.random.default_rng(3)
    grads = {"w": torch.from_numpy(rng.normal(size=(32, 8)).astype(np.float32)),
             "b": torch.from_numpy(rng.normal(size=(8,)).astype(np.float32))}

    def run():
        gen = torch.Generator().manual_seed(5)
        ef = tcomp.init_error_feedback(grads)
        outs = []
        for _ in range(3):
            out, ef = tcomp.compress_with_feedback(grads, ef, scheme="int8", generator=gen)
            outs.append(out)
        return outs, ef

    outs1, ef1 = run()
    outs2, ef2 = run()
    for o1, o2 in zip(outs1, outs2):
        for k in o1:
            assert torch.equal(o1[k], o2[k])
    for k in grads:
        assert torch.equal(ef1.residual[k], ef2.residual[k])
    ef0 = tcomp.init_error_feedback(grads)
    out1, ef_next = tcomp.compress_with_feedback(grads, ef0, scheme="int8",
                                                 generator=torch.Generator().manual_seed(5))
    np.testing.assert_allclose((ef_next.residual["w"] + out1["w"]).numpy(),
                               (grads["w"] + ef0.residual["w"]).numpy(), rtol=0, atol=1e-6)
    # the deterministic path: the reference's outputs and residuals, bit for bit
    jg = {k: jnp.asarray(v.numpy()) for k, v in grads.items()}
    jout, jef = jcomp.compress_with_feedback(jg, jcomp.init_error_feedback(jg), scheme="int8")
    tout, tef = tcomp.compress_with_feedback(grads, tcomp.init_error_feedback(grads),
                                             scheme="int8")
    for k in grads:
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
        np.testing.assert_array_equal(tef.residual[k].numpy(), np.asarray(jef.residual[k]))


def test_compressed_setfunction_naming_and_corrupt_gain_guard():
    from repro_torch.distributed.sharding import SelectionMesh

    mesh2 = SelectionMesh(None, (0, 1), 0)
    fnc = tsh.make_sharded_facility_location(mesh=mesh2, compress="int8", compress_rounds=3)
    assert fnc.name.endswith("_c8r3")
    with pytest.raises(ValueError, match="unknown compression scheme"):
        tsh.make_sharded_facility_location(mesh=mesh2, compress="zstd")

    class Compressed:
        name = "x_c8r2"

    class Exact:
        name = "x"

    with pytest.raises(tcomp.CompressionIntegrityError):
        tsh._raise_if_corrupt(Compressed, torch.tensor([1.0, float("nan")]))
    tsh._raise_if_corrupt(Compressed, torch.tensor([1.0, 2.0]))
    tsh._raise_if_corrupt(Exact, torch.tensor([float("nan")]))


# ---------------------------------------------------------------------------
# real two-process jobs (gloo CPU processes)
# ---------------------------------------------------------------------------

SELECT_SCRIPT = r"""
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
out = sys.argv[1]
from repro_torch.distributed import multihost
multihost.initialize(timeout=60.0, device="cpu")
from repro_torch.core import sharded as S
from repro_torch.core.similarity import normalize_rows
from repro_torch.distributed.sharding import selection_mesh
from repro_torch.selection import build_selector

rng = np.random.default_rng(0)
feats = rng.normal(size=(256, 16)).astype(np.float32)
z = normalize_rows(torch.from_numpy(feats))
mesh = selection_mesh()
W = mesh.size
res = S.sharded_greedy(S.make_sharded_gram_free("facility_location", mesh=mesh), z, 24, mesh=mesh)
fnc = S.make_sharded_gram_free("facility_location", mesh=mesh, compress="int8",
                               compress_rounds=2)
resc = S.sharded_greedy(fnc, z, 24, mesh=mesh)
plan = build_selector("milo_fixed", features=feats, k=32, shard_selection=True,
                      device="cpu").plan(0)
bits = lambda t: np.asarray(t, np.float32).view(np.uint32).tolist()
payload = {"ranks": W, "indices": res.indices.tolist(), "gains_bits": bits(res.gains),
           "gains": res.gains.tolist(), "c_indices": resc.indices.tolist(),
           "c_gains_bits": bits(resc.gains), "plan_indices": np.asarray(plan.indices).tolist(),
           "plan_weights_bits": bits(plan.weights), "plan_phase": plan.phase,
           "hops": mesh.hops}
with open(f"{out}.{multihost.process_index()}.json", "w") as f:
    json.dump(payload, f)
print("SELECT_DONE", multihost.process_index())
"""

TRAIN_SCRIPT = r"""
import sys
mode, ckpt_dir, hb_dir, out = sys.argv[1:5]
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.distributed import multihost
multihost.initialize(timeout=60.0, device="cpu")
from repro_torch.data.pipeline import Pipeline
from repro_torch.selection import build_selector
from repro_torch.selection import session as S
from repro_torch.train.trainer import Trainer, TrainerConfig

N, D, C, K, BATCH = 256, 8, 4, 96, 16      # 6 steps per epoch
rng = np.random.default_rng(0)
feats = rng.normal(size=(N, D)).astype(np.float32)
labs = rng.integers(0, C, size=N).astype(np.int64)
sel = build_selector("adaptive_random", n=N, k=K, R=1, seed=3)
pipe = Pipeline(None, sel, BATCH, seed=1, arrays={"x": feats, "y": labs}, device="cpu")
tr = Trainer(S._classifier_step_fn(1), pipe,
             TrainerConfig(epochs=3, checkpoint_dir=ckpt_dir, checkpoint_every_steps=4,
                           async_checkpoint=False, log_every_steps=1, barrier_timeout=10.0,
                           heartbeat_dir=(None if hb_dir == "none" else hb_dir),
                           heartbeat_timeout=300.0))
if mode == "kill":
    from repro_torch.testing.faults import KillHost
    tr.monitor = KillHost(10, process_to_kill=1)   # mid-epoch 1
state = tr.fit(S._init_classifier(0, D, C, 16, 0.05, 18, torch.device("cpu")), resume=True)
flat = {f"p{k}": v.detach().numpy() for k, v in state.params.items()}
flat.update({f"m{k}": v.numpy() for k, v in state.mom.items()})
np.savez(f"{out}.{multihost.process_index()}.npz", step=int(state.step), **flat)
print("TRAIN_COMPLETE", multihost.process_index(), int(state.step))
"""


def _run_single(script, argv, *, timeout=120):
    """The same child script as ONE process (no env triplet)."""
    env = dict(os.environ)
    for var in ("MILO_COORDINATOR", "MILO_NUM_PROCESSES", "MILO_PROCESS_ID"):
        env.pop(var, None)
    env.update(CHILD_ENV)
    r = subprocess.run([sys.executable, "-c", script, *[str(a) for a in argv]],
                       capture_output=True, text=True, env=env, cwd=REPO_ROOT, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


def test_two_process_selection_plan_against_one_process(tmp_path):
    """2 ranks × 1 process each run the selection SPMD: both hold the same
    bits (exact and compressed), the indices and the milo_fixed plan are
    one process's, the facility-location gains within the ring sum's ulps."""
    out2 = str(tmp_path / "two")
    results = launch_hosts(SELECT_SCRIPT, [out2], num_processes=2, env=CHILD_ENV,
                           cwd=REPO_ROOT, timeout=120.0)
    for r in results:
        assert r.returncode == 0, (r.process_id, r.stderr[-3000:])
        assert "SELECT_DONE" in r.stdout
    one = str(tmp_path / "one")
    _run_single(SELECT_SCRIPT, [one])
    got = [json.load(open(f"{out2}.{i}.json")) for i in range(2)]
    want = json.load(open(f"{one}.0.json"))
    assert got[0] == got[1], "the two ranks diverged"
    assert got[0]["ranks"] == 2 and want["ranks"] == 1
    assert got[0]["hops"] > 0 and want["hops"] == 0
    for key in ("indices", "plan_indices", "plan_weights_bits", "plan_phase"):
        assert got[0][key] == want[key], key
    np.testing.assert_allclose(got[0]["gains"], want["gains"], rtol=1e-6, atol=1e-6)
    overlap = len(set(got[0]["c_indices"]) & set(want["indices"]))
    assert overlap >= 20, overlap


def test_two_process_kill_resume_bit_identical(tmp_path):
    """SIGKILL host 1 mid-epoch (two-phase checkpoints every 4 steps): the
    survivor exits non-zero with ``HostLossError`` within the barrier
    timeout, only complete checkpoints remain, and the restarted pair ends
    bit-equal to the uninterrupted 2-rank run and to one process."""
    ref = launch_hosts(TRAIN_SCRIPT, ["run", str(tmp_path / "ck_ref"), "none",
                                      str(tmp_path / "ref")],
                       num_processes=2, env=CHILD_ENV, cwd=REPO_ROOT, timeout=120.0)
    for r in ref:
        assert r.returncode == 0, (r.process_id, r.stderr[-3000:])
        assert "TRAIN_COMPLETE" in r.stdout
    _run_single(TRAIN_SCRIPT, ["run", str(tmp_path / "ck_one"), "none", str(tmp_path / "one")])

    ck, hb = str(tmp_path / "ck"), str(tmp_path / "hb")
    t0 = time.perf_counter()
    dead = launch_hosts(TRAIN_SCRIPT, ["kill", ck, hb, str(tmp_path / "dead")],
                        num_processes=2, env=CHILD_ENV, cwd=REPO_ROOT, timeout=120.0)
    assert time.perf_counter() - t0 < 60.0
    assert dead[1].returncode == -signal.SIGKILL, dead[1].returncode
    assert dead[0].returncode != 0, dead[0].returncode
    assert "TRAIN_COMPLETE" not in dead[0].stdout
    assert "HostLossError" in dead[0].stderr, dead[0].stderr[-3000:]
    view = CheckpointManager(ck)
    assert view.latest_valid_step() == 8
    assert view.validate_step(8)["num_shards"] == 2
    assert JManager(ck).latest_valid_step() == 8
    assert os.path.exists(os.path.join(hb, "host_0.json"))

    res = launch_hosts(TRAIN_SCRIPT, ["run", ck, hb, str(tmp_path / "res")],
                       num_processes=2, env=CHILD_ENV, cwd=REPO_ROOT, timeout=120.0)
    for r in res:
        assert r.returncode == 0, (r.process_id, r.stderr[-3000:])
        assert "TRAIN_COMPLETE" in r.stdout

    def load(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}

    want = load(str(tmp_path / "ref") + ".0.npz")
    assert int(want["step"]) == 18
    for name in ("ref.1", "one.0", "res.0", "res.1"):
        got = load(str(tmp_path / name) + ".npz")
        assert int(got["step"]) == 18, name
        for k in want:
            np.testing.assert_array_equal(want[k], got[k], err_msg=name)
