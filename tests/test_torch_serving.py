"""Selection as a service on the port (``repro_torch.serve``) against
``repro.serve`` on the CPU: the artifact store (keys, single flight,
eviction and reload, pins, versions, the cross-process lockfile, one store
root shared by both packages), the shared buffers, and the ``MiloServer``
request lifecycle re-expressed from ``tests/test_serving.py`` and the
server cases of ``tests/test_health.py`` and ``tests/test_fault_tolerance.py``;
``RetryPolicy``'s delays; a tune through the server against the session's
own and, with the reference's initial parameters carried in (as
``tests/test_torch_tune.py``), against the reference server's trial stream.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import repro.selection as jsel
import repro.serve as JS
from repro.data.datasets import GaussianMixtureDataset
from repro.models.classifier import init_mlp as jinit_mlp
from repro.selection.session import _data_fingerprint as j_fingerprint
from repro.core.metadata import config_hash as j_config_hash
from repro_torch.core.metadata import MetadataMismatchError, config_hash
from repro_torch.distributed.multihost import HeartbeatMonitor, HeartbeatWriter
from repro_torch.health import CircuitBreaker, CircuitOpenError
from repro_torch.kernels import _build
from repro_torch.models.classifier import params_from_jax
from repro_torch.selection.session import MiloSession, MiloSessionConfig, _data_fingerprint
from repro_torch.serve import (
    CANCELLED, DONE, ERROR, EXPIRED, ArtifactStore, BufferRegistry, MiloClient, MiloServer,
    RetryPolicy, ServerOverloadedError, TransientServeError, artifact_request_config,
)
from repro_torch.testing.faults import TransientFault, fail_nth_calls, flaky

torch.set_num_threads(1)

tsession = importlib.import_module("repro_torch.selection.session")

N, D, CLASSES = 240, 8, 3
CPU = "cpu"


def _dataset(seed: int = 0, n: int = N):
    rng = np.random.default_rng(seed)
    labs = rng.integers(0, CLASSES, n).astype(np.int64)
    feats = (rng.normal(size=(n, D)) + 0.8 * labs[:, None]).astype(np.float32)
    vx = rng.normal(size=(48, D)).astype(np.float32)
    vy = rng.integers(0, CLASSES, 48).astype(np.int64)
    return feats, labs, vx, vy


def _kw(**kw):
    base = dict(subset_fraction=0.2, n_sge_subsets=2, gram_free=True, total_epochs=4,
                eval_every_epochs=2, sub_steps=2, fused_training=True)
    base.update(kw)
    return base


def _config(**kw) -> MiloSessionConfig:
    return MiloSessionConfig(**_kw(**kw))


def _build_fn(cfg, feats, labs, fp):
    session = MiloSession(cfg, device=CPU)
    return lambda: session.build_metadata(feats, labs, fingerprint=fp)


# ---------------------------------------------------------------------------
# keys across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(lazy_gains=True), dict(gram_free=False, prep_seed=7),
                                dict(firewall="quarantine", seed=3)])
def test_keys_equal_across_packages(kw):
    feats, _, _, _ = _dataset()
    cfg_t, cfg_j = _config(**kw), jsel.MiloSessionConfig(**_kw(**kw))
    req_t, req_j = artifact_request_config(cfg_t), JS.artifact_request_config(cfg_j)
    assert req_t == req_j
    assert config_hash(req_t) == j_config_hash(req_j)
    assert _data_fingerprint(feats) == j_fingerprint(feats)
    assert ArtifactStore.key_for("f" * 16, req_t) == JS.ArtifactStore.key_for("f" * 16, req_j)
    assert config_hash(dataclasses.asdict(cfg_t)) == j_config_hash(dataclasses.asdict(cfg_j))


# ---------------------------------------------------------------------------
# artifact store
# ---------------------------------------------------------------------------

def test_store_single_flight_concurrent_builds(tmp_path):
    feats, labs, _, _ = _dataset()
    cfg = _config()
    store = ArtifactStore(str(tmp_path / "store"))
    req = artifact_request_config(cfg)
    session = MiloSession(cfg, device=CPU)
    fp = "f" * 16
    key = store.key_for(fp, req)
    calls, results, errors = [], [], []

    def build():
        calls.append(1)
        time.sleep(0.05)  # widen the race window
        return session.build_metadata(feats, labs, fingerprint=fp)

    def worker():
        try:
            md, _, source = store.get_or_build(key, req, build)
            results.append((md, source))
        except BaseException as e:  # pragma: no cover - fail loudly below
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert len(calls) == 1 and store.builds == 1
    assert len({id(md) for md, _ in results}) == 1
    assert sorted(s for _, s in results) == ["built"] + ["memory"] * 5


def test_store_failed_build_releases_flight_lock(tmp_path):
    feats, labs, _, _ = _dataset()
    cfg = _config()
    store = ArtifactStore(str(tmp_path / "store"))
    req = artifact_request_config(cfg)
    fp = "f" * 16
    key = store.key_for(fp, req)
    build = flaky(_build_fn(cfg, feats, labs, fp), failures=1)
    results, errors = [], []

    def worker():
        try:
            results.append(store.get_or_build(key, req, build)[2])
        except TransientFault as e:
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "waiters hung on the flight lock"
    assert len(errors) == 1 and sorted(results) == ["built", "memory", "memory"]
    assert store.build_failures == 1 and store.builds == 1 and build.calls == 2
    assert store.get_or_build(key, req, build)[2] == "memory"


def test_store_foreign_artifact_and_wrong_fingerprint_raise(tmp_path):
    feats, labs, _, _ = _dataset()
    cfg_a, cfg_b = _config(subset_fraction=0.2), _config(subset_fraction=0.1)
    store = ArtifactStore(str(tmp_path / "store"))
    fp = "a" * 16
    req_a, req_b = artifact_request_config(cfg_a), artifact_request_config(cfg_b)
    key_a, key_b = store.key_for(fp, req_a), store.key_for(fp, req_b)
    store.get_or_build(key_a, req_a, _build_fn(cfg_a, feats, labs, fp))
    shutil.copy(store.path_for(key_a), store.path_for(key_b))
    with pytest.raises(MetadataMismatchError, match="subset_fraction"):
        ArtifactStore(store.root).get_or_build(key_b, req_b, _build_fn(cfg_b, feats, labs, fp))
    key_c = store.key_for("c" * 16, req_a)
    shutil.copy(store.path_for(key_a), store.path_for(key_c))
    with pytest.raises(MetadataMismatchError, match="fingerprint"):
        ArtifactStore(store.root).get_or_build(key_c, req_a,
                                               _build_fn(cfg_a, feats, labs, "c" * 16))


def test_store_evict_reload_bit_identical_plans(tmp_path):
    cfg = _config()
    store = ArtifactStore(str(tmp_path / "store"), capacity=1)
    req = artifact_request_config(cfg)
    sessions, keys, built = {}, {}, {}
    for seed in (0, 1):
        feats, labs, _, _ = _dataset(seed)
        fp = f"{seed}" * 16
        key = store.key_for(fp, req)
        md, _, source = store.get_or_build(key, req, _build_fn(cfg, feats, labs, fp))
        assert source == "built"
        keys[seed], built[seed] = key, md
        sess = MiloSession(cfg, device=CPU)
        sess.adopt_metadata(md)
        sessions[seed] = sess
    assert store.evictions == 1
    assert not store.resident(keys[0]) and store.resident(keys[1])
    md0, entry, source = store.get_or_build(keys[0], req,
                                            lambda: pytest.fail("reload must not rebuild"))
    assert source == "disk" and store.disk_loads == 1 and store.builds == 2
    assert entry.version == 1
    for f in ("sge_subsets", "wre_probs", "wre_importance"):
        np.testing.assert_array_equal(getattr(md0, f), getattr(built[0], f))
    reloaded = MiloSession(cfg, device=CPU)
    reloaded.adopt_metadata(md0)
    for epoch in (0, 3):
        a, b = sessions[0].selector(n=N).plan(epoch), reloaded.selector(n=N).plan(epoch)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.weights, b.weights)


def test_store_pins_and_force_versions(tmp_path):
    cfg = _config()
    store = ArtifactStore(str(tmp_path / "store"), capacity=1)
    req = artifact_request_config(cfg)
    feats, labs, _, _ = _dataset()
    k1 = store.key_for("p" * 16, req)
    _, e1, _ = store.get_or_build(k1, req, _build_fn(cfg, feats, labs, "p" * 16), pin=True)
    k2 = store.key_for("q" * 16, req)
    store.get_or_build(k2, req, _build_fn(cfg, feats, labs, "q" * 16))
    assert store.resident(k1), "pinned entry must never be evicted"
    store.unpin(k1)
    store.get_or_build(store.key_for("r" * 16, req), req, _build_fn(cfg, feats, labs, "r" * 16))
    assert not store.resident(k1)
    with pytest.raises(KeyError):
        store.pin(("no", "such"))
    _, e2, s2 = store.get_or_build(k1, req, _build_fn(cfg, feats, labs, "p" * 16))
    assert (e1.version, e2.version, s2) == (1, 1, "disk")
    _, e3, s3 = store.get_or_build(k1, req, _build_fn(cfg, feats, labs, "p" * 16), force=True)
    assert (e3.version, s3) == (2, "built")
    assert {e.key: e.version for e in store.entries()}[k1] == 2
    with pytest.raises(ValueError, match="capacity"):
        ArtifactStore(capacity=0)


def _dead_pid() -> int:
    proc = subprocess.run([sys.executable, "-c", "import os; print(os.getpid())"],
                          capture_output=True, text=True, timeout=60)
    return int(proc.stdout)


def test_store_stale_lock_takeover_and_timeout(tmp_path):
    """A lockfile whose holder is dead is taken over; one held by a live
    process stalls a waiter only until ``lock_timeout`` (injected clock)."""
    feats, labs, _, _ = _dataset()
    cfg = _config()
    root = str(tmp_path / "store")
    store = ArtifactStore(root, lock_poll=0.0)
    req = artifact_request_config(cfg)
    key = store.key_for("s" * 16, req)
    lock = store.path_for(key) + ".lock"
    with open(lock, "w") as f:
        f.write(str(_dead_pid()))
    _, _, source = store.get_or_build(key, req, _build_fn(cfg, feats, labs, "s" * 16))
    assert source == "built" and store.lock_steals == 1 and store.lock_waits == 1
    assert not os.path.exists(lock)

    now = [0.0]
    slow = ArtifactStore(root, lock_timeout=5.0, lock_poll=1.0, clock=lambda: now[0],
                         sleep=lambda dt: now.__setitem__(0, now[0] + dt))
    key2 = slow.key_for("t" * 16, req)
    with open(slow.path_for(key2) + ".lock", "w") as f:
        f.write(str(os.getpid()))            # a live holder that never finishes
    _, _, source = slow.get_or_build(key2, req, _build_fn(cfg, feats, labs, "t" * 16))
    assert source == "built" and slow.lock_timeouts == 1 and slow.lock_steals == 0
    st = slow.stats()
    assert st["lock_timeouts"] == 1 and st["builds"] == 1


@pytest.mark.parametrize("builder", ["port", "reference"])
def test_store_root_shared_across_packages(tmp_path, builder):
    """A key built by either package's store is a disk load for the other's,
    under the same file name, and the plans it serves are bit-equal."""
    feats, labs, _, _ = _dataset()
    root = str(tmp_path / "store")
    cfg_t, cfg_j = _config(), jsel.MiloSessionConfig(**_kw())
    req_t, req_j = artifact_request_config(cfg_t), JS.artifact_request_config(cfg_j)
    fp = _data_fingerprint(feats)
    t_store, j_store = ArtifactStore(root), JS.ArtifactStore(root)
    key = t_store.key_for(fp, req_t)
    assert j_store.key_for(fp, req_j) == key
    if builder == "port":
        md_b, _, s_b = t_store.get_or_build(key, req_t, _build_fn(cfg_t, feats, labs, fp))
        js = jsel.MiloSession(cfg_j)
        md_l, _, s_l = j_store.get_or_build(
            key, req_j, lambda: js.build_metadata(feats, labs, fingerprint=fp))
    else:
        js = jsel.MiloSession(cfg_j)
        md_b, _, s_b = j_store.get_or_build(
            key, req_j, lambda: js.build_metadata(feats, labs, fingerprint=fp))
        md_l, _, s_l = t_store.get_or_build(key, req_t, _build_fn(cfg_t, feats, labs, fp))
    assert (s_b, s_l) == ("built", "disk")
    assert os.listdir(root) == [f"{key[0]}_{key[1]}.npz"]
    assert md_l.config_hash() == md_b.config_hash()
    for f in ("sge_subsets", "wre_probs", "wre_importance", "class_labels", "class_budgets"):
        np.testing.assert_array_equal(getattr(md_l, f), getattr(md_b, f))
    # the plans each package serves from the shared artifact (SGE lookups,
    # and WRE draws with the reference's draws carried in)
    ts = MiloSession(cfg_t, device=CPU)
    ts.adopt_metadata(md_b if builder == "port" else md_l)
    jss = jsel.MiloSession(cfg_j)
    jss.adopt_metadata(md_l if builder == "port" else md_b)
    wre = lambda window: np.asarray(jax.random.gumbel(  # noqa: E731
        jax.random.fold_in(jax.random.PRNGKey(0), window), (N,)))
    sel_t, sel_j = ts.selector(n=N, wre_noise=wre), jss.selector(n=N)
    for epoch in range(4):
        pt, pj = sel_t.plan(epoch), sel_j.plan(epoch)
        assert pt.phase == pj.phase
        np.testing.assert_array_equal(pt.indices, pj.indices)
        np.testing.assert_array_equal(pt.weights, pj.weights)


# ---------------------------------------------------------------------------
# shared device buffers
# ---------------------------------------------------------------------------

def test_buffer_registry_identity_and_put_counting():
    reg = BufferRegistry(CPU)
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    b1, b2, b3 = reg.column(x), reg.column(x), reg.column(x.copy())
    assert b1 is b2 is b3 and torch.is_tensor(b1) and b1.device.type == "cpu"
    assert reg.put_count == 1 and reg.hits == 2
    assert reg.column(x + 1.0) is not b1 and reg.put_count == 2
    assert reg.release(x) and not reg.release(x)
    assert reg.stats()["resident_columns"] == 1
    from repro.serve.buffers import array_fingerprint as j_fp
    from repro_torch.serve import array_fingerprint
    assert array_fingerprint(x) == j_fp(x)


def test_concurrent_trainers_share_one_device_buffer():
    feats, labs, vx, vy = _dataset()
    reg = BufferRegistry(CPU)
    reports = []
    for seed in (0, 1):
        sess = MiloSession(_config(), device=CPU, buffer_registry=reg)
        sess.preprocess(feats, labs)
        reports.append(sess.train(feats, labs, test_x=vx, test_y=vy, seed=seed))
    assert all(r.steps > 0 for r in reports)
    st = reg.stats()
    assert st["put_count"] == 2 and st["resident_columns"] == 2 and st["hits"] >= 2
    a, b = reg.get({"x": feats, "y": labs}), reg.get({"x": feats, "y": labs})
    assert a["x"] is b["x"] and a["y"] is b["y"] and reg.put_count == 2


# ---------------------------------------------------------------------------
# server lifecycle
# ---------------------------------------------------------------------------

SPACE = {"lr": ("log", 1e-3, 0.3)}


@pytest.fixture(scope="module")
def warm_server(tmp_path_factory):
    feats, labs, vx, vy = _dataset()
    server = MiloServer(_config(), device=CPU,
                        store_root=str(tmp_path_factory.mktemp("artifacts")),
                        num_workers=2).start()
    out = server.warm(feats, labs, val_x=vx, val_y=vy, space=SPACE)
    assert out["tune_replayed"] and out["warmed_geometries"] >= 1
    assert server.warm(feats, labs, val_x=vx, val_y=vy, space=SPACE)["warmed_geometries"] == 0
    yield server, (feats, labs, vx, vy)
    server.shutdown()


def test_server_concurrent_identical_submits_build_once(warm_server):
    server, (feats, labs, vx, vy) = warm_server
    builds = server.store.builds
    rids = [server.submit("tune", features=feats, labels=labs, val_x=vx, val_y=vy,
                          space=SPACE, max_budget=3, tenant=f"t{i}", seed=50 + i)
            for i in range(3)]
    results = [server.result(rid, timeout=300) for rid in rids]
    assert server.store.builds == builds, "no request may rebuild"
    for rid, res in zip(rids, results):
        row = server.poll(rid)
        assert row["status"] == DONE and row["artifact_source"] == "memory"
        assert res.best_config is not None and not res.stopped


def test_server_tenants_equal_a_serial_replay(warm_server, tmp_path):
    """Tenants tuning at once on two workers get the bits of the same
    requests run one at a time on one worker."""
    server, (feats, labs, vx, vy) = warm_server
    rids = [MiloClient(server, tenant=f"c{i}").submit_tune(
        feats, labs, vx, vy, SPACE, max_budget=3, seed=70 + i) for i in range(3)]
    concurrent = [server.result(r, timeout=300) for r in rids]
    with MiloServer(_config(), device=CPU, store_root=str(tmp_path / "s"),
                    num_workers=1) as serial:
        for i, res in enumerate(concurrent):
            again = MiloClient(serial).tune(feats, labs, vx, vy, SPACE, max_budget=3, seed=70 + i)
            assert again.trials == res.trials and again.best_config == res.best_config


def test_server_train_and_log(warm_server):
    server, (feats, labs, vx, vy) = warm_server
    report = MiloClient(server, tenant="trainer").train(feats, labs, test_x=vx, test_y=vy)
    assert report.steps > 0
    last = server.request_log()[-1]
    assert {"request_id", "kind", "tenant", "status", "artifact_key", "artifact_version",
            "artifact_source", "submitted", "started", "finished", "attempts"} <= set(last)
    assert last["kind"] == "train" and last["tenant"] == "trainer"
    assert last["status"] == DONE and last["finished"] >= last["started"]
    st = server.stats()
    assert st["sessions"] >= 1 and st["warmed"] == 1 and st["buffers"]["put_count"] == 2
    json.dumps(server.health())


def test_server_cancel_queued_request(warm_server):
    server, (feats, labs, vx, vy) = warm_server
    blockers = [server.submit("tune", features=feats, labels=labs, val_x=vx, val_y=vy,
                              space=SPACE, max_budget=9) for _ in range(2)]
    victim = server.submit("train", features=feats, labels=labs, test_x=vx, test_y=vy)
    assert server.cancel(victim)
    with pytest.raises(TimeoutError, match="cancelled"):
        server.result(victim, timeout=300)
    assert server.poll(victim)["status"] == CANCELLED
    for rid in blockers:
        server.result(rid, timeout=300)
    assert not server.cancel(victim), "terminal requests cannot be cancelled"


def test_server_deadline_expires_queued_request(warm_server):
    server, (feats, labs, vx, vy) = warm_server
    blockers = [server.submit("tune", features=feats, labels=labs, val_x=vx, val_y=vy,
                              space=SPACE, max_budget=9) for _ in range(2)]
    doomed = server.submit("train", features=feats, labels=labs, test_x=vx, test_y=vy,
                           deadline=0.0)
    with pytest.raises(TimeoutError, match="expired"):
        server.result(doomed, timeout=300)
    assert server.poll(doomed)["status"] == EXPIRED
    for rid in blockers:
        server.result(rid, timeout=300)


def test_server_tune_should_stop_at_rung_boundary(warm_server):
    server, (feats, labs, vx, vy) = warm_server
    rid = server.submit("tune", features=feats, labels=labs, val_x=vx, val_y=vy,
                        space=SPACE, max_budget=9, deadline=1e-3)
    with pytest.raises(TimeoutError):
        server.result(rid, timeout=300)
    req = server._request(rid)
    assert req.status in (EXPIRED, CANCELLED)
    assert req.result is None or req.result.stopped


def test_server_error_requests_reraise_and_unknown_kinds(warm_server):
    server, (feats, labs, vx, vy) = warm_server
    rid = server.submit("tune", features=feats, labels=labs, val_x=vx, val_y=vy,
                        space={"bogus": ("log", 1e-3, 1.0)})
    with pytest.raises(ValueError, match="bogus"):
        server.result(rid, timeout=300)
    assert server.poll(rid)["status"] == ERROR
    with pytest.raises(ValueError, match="unknown request kind"):
        server.submit("frobnicate", features=feats, labels=labs)
    with pytest.raises(KeyError, match="unknown request id"):
        server.poll("nope")


def test_server_refuses_work_before_start():
    feats, labs, _, _ = _dataset()
    server = MiloServer(_config(), device=CPU)
    with pytest.raises(RuntimeError, match="not started"):
        server.submit("preprocess", features=feats, labels=labs)
    with pytest.raises(ValueError, match="max_queue"):
        MiloServer(_config(), device=CPU, max_queue=0)


def test_server_overrides_change_the_key_not_the_base(warm_server):
    server, (feats, labs, _, _) = warm_server
    out = MiloClient(server, tenant="o", overrides={"subset_fraction": 0.1}).preprocess(
        feats, labs)
    base = server.store.key_for(server.data_fingerprint(feats),
                                artifact_request_config(server.config))
    assert out["artifact_key"] != base and out["source"] == "built"
    assert server.config.subset_fraction == 0.2


def test_tune_through_the_server_equals_the_session(warm_server):
    """The server adds no arithmetic: its tune is the session's."""
    server, (feats, labs, vx, vy) = warm_server
    res = MiloClient(server).tune(feats, labs, vx, vy, SPACE, max_budget=9, seed=5)
    direct = MiloSession(_config(), device=CPU)
    direct.preprocess(feats, labs)
    ref = direct.tune(feats, labs, vx, vy, SPACE, max_budget=9, seed=5)
    assert res.trials == ref.trials and res.best_config == ref.best_config
    assert res.best_score == ref.best_score


# ---------------------------------------------------------------------------
# hardening: bounded queue, breaker-gated builds, health()
# ---------------------------------------------------------------------------

def _serve_config(**kw):
    return MiloSessionConfig(**{**dict(subset_fraction=0.2, n_sge_subsets=2, gram_free=True,
                                       total_epochs=4, sub_steps=2), **kw})


def test_server_overload_fast_fails_at_submit(monkeypatch):
    feats, labs, _, _ = _dataset(n=80)
    entered, release = threading.Event(), threading.Event()

    def blocking_build(self, *a, **kw):
        entered.set()
        release.wait(60)
        raise RuntimeError("never built")

    monkeypatch.setattr(MiloSession, "build_metadata", blocking_build)
    try:
        with MiloServer(_serve_config(), device=CPU, num_workers=1, max_queue=2) as srv:
            r1 = srv.submit("preprocess", features=feats, labels=labs)
            assert entered.wait(30)
            srv.submit("preprocess", features=feats, labels=labs)
            srv.submit("preprocess", features=feats, labels=labs)
            with pytest.raises(ServerOverloadedError, match="queue full"):
                srv.submit("preprocess", features=feats, labels=labs)
            h = srv.health()
            assert h["status"] == "degraded" and h["queue"] == {"depth": 2, "limit": 2}
            release.set()
            with pytest.raises(RuntimeError, match="never built"):
                srv.result(r1, timeout=60)
    finally:
        release.set()


def test_server_breaker_trips_on_deterministic_build_failure(monkeypatch):
    feats, labs, _, _ = _dataset(n=80)
    calls = [0]

    def always_broken(self, *a, **kw):
        calls[0] += 1
        raise ValueError("poisoned ground set")

    monkeypatch.setattr(MiloSession, "build_metadata", always_broken)
    br = CircuitBreaker(threshold=2, cooldown=1e9)
    with MiloServer(_serve_config(), device=CPU, num_workers=1, breaker=br) as srv:
        for _ in range(2):
            rid = srv.submit("preprocess", features=feats, labels=labs)
            with pytest.raises(ValueError, match="poisoned"):
                srv.result(rid, timeout=60)
        rid = srv.submit("preprocess", features=feats, labels=labs)
        with pytest.raises(CircuitOpenError):
            srv.result(rid, timeout=60)
        assert calls[0] == 2
        h = srv.health()
        assert h["status"] == "degraded" and len(h["tripped_keys"]) == 1
        assert h["store"]["build_failures"] == 3
        key = srv.store.key_for(srv.data_fingerprint(feats), artifact_request_config(srv.config))
        assert srv.store.failures_for(key) >= 2
        assert srv.store.failures_for(("no", "such")) == 0


def test_server_breaker_cached_key_serves_and_recovers(tmp_path, monkeypatch):
    """While a key's circuit is open its cached artifact still serves; after
    the cooldown one probe build closes it and ``health()`` reads ok."""
    feats, labs, _, _ = _dataset(n=80)
    now = [0.0]
    br = CircuitBreaker(threshold=1, cooldown=10.0, clock=lambda: now[0])
    with MiloServer(_serve_config(), device=CPU, num_workers=1, breaker=br,
                    store_root=str(tmp_path / "s")) as srv:
        c = MiloClient(srv)
        assert c.preprocess(feats, labs)["source"] == "built"
        orig = MiloSession.build_metadata
        monkeypatch.setattr(MiloSession, "build_metadata",
                            lambda self, *a, **k: (_ for _ in ()).throw(ValueError("bad")))
        with pytest.raises(ValueError, match="bad"):
            c.preprocess(feats, labs, force=True)
        assert srv.health()["status"] == "degraded"
        with pytest.raises(CircuitOpenError):
            c.preprocess(feats, labs, force=True)
        assert c.preprocess(feats, labs)["source"] == "memory"
        monkeypatch.setattr(MiloSession, "build_metadata", orig)
        now[0] = 10.0
        assert srv.health()["tripped_keys"]                 # half-open still counts
        out = c.preprocess(feats, labs, force=True)
        assert out["source"] == "built" and out["version"] == 2
        assert srv.health()["status"] == "ok"


def test_server_health_ok_heartbeats_and_stop(tmp_path):
    feats, labs, _, _ = _dataset(n=80)
    hb = str(tmp_path / "hb")
    t = [100.0]
    HeartbeatWriter(hb, 0, clock=lambda: t[0]).beat(step=3)
    HeartbeatWriter(hb, 1, clock=lambda: t[0] - 90.0).beat()
    mon = HeartbeatMonitor(hb, timeout=60.0, expected=2, clock=lambda: t[0])
    with MiloServer(_serve_config(), device=CPU, store_root=str(tmp_path / "store"),
                    num_workers=1) as srv:
        h = srv.health()
        assert h["status"] == "ok" and h["breakers"] == {} and "hosts" not in h
        assert srv.result(srv.submit("preprocess", features=feats, labels=labs),
                          timeout=120)["source"] == "built"
        h = srv.health()
        assert h["status"] == "ok" and h["failures"] == 0 and h["queue"]["depth"] == 0
        json.dumps(h)
    assert srv.health()["status"] == "stopped"
    with MiloServer(_serve_config(), device=CPU, heartbeat_monitor=mon) as srv:
        h = srv.health()
        assert h["status"] == "degraded" and h["hosts"]["stale"] == [1]
        assert h["hosts"]["ages"] == {"0": 0.0, "1": 90.0}
    with MiloServer(_serve_config(), device=CPU, heartbeat_dir=hb,
                    heartbeat_timeout=1e12) as srv:
        assert srv.health()["status"] == "ok"


def test_server_retries_transient_build_failure(tmp_path, monkeypatch):
    feats, labs, _, _ = _dataset(n=80)
    monkeypatch.setattr(MiloSession, "build_metadata",
                        fail_nth_calls(MiloSession.build_metadata, fail_on={1}))
    with MiloServer(_serve_config(), device=CPU, store_root=str(tmp_path / "store"),
                    num_workers=1,
                    retry_policy=RetryPolicy(base_delay=0.01, retry_on=(TransientFault,))
                    ) as server:
        rid = server.submit("preprocess", features=feats, labels=labs)
        assert server.result(rid, timeout=120)["source"] == "built"
        snap = server.poll(rid)
        assert snap["status"] == DONE and snap["attempts"] == 2 and snap["error"] is None
        st = server.stats()
        assert st["retries"] == 1 and st["failures"] == 0
        assert st["store"]["build_failures"] == 1


def test_server_permanent_error_fails_fast_and_stays_healthy(tmp_path, monkeypatch):
    feats, labs, _, _ = _dataset(n=80)
    monkeypatch.setattr(MiloSession, "build_metadata", fail_nth_calls(
        MiloSession.build_metadata, fail_on={1},
        exc=lambda msg: ValueError("permanently malformed request")))
    with MiloServer(_serve_config(), device=CPU, store_root=str(tmp_path / "store"),
                    num_workers=1) as server:
        rid = server.submit("preprocess", features=feats, labels=labs)
        with pytest.raises(ValueError, match="permanently malformed"):
            server.result(rid, timeout=120)
        snap = server.poll(rid)
        assert snap["status"] == ERROR and snap["attempts"] == 1
        assert server.result(server.submit("preprocess", features=feats, labels=labs),
                             timeout=120)["source"] == "built"
        st = server.stats()
        assert st["failures"] == 1 and st["retries"] == 0
        assert st["store"]["build_failures"] == 1 and st["store"]["builds"] == 1


@pytest.mark.parametrize("fault", [
    _build.KernelBuildError("nvcc failed on similarity.cu"),
    _build.KernelError("similarity kernel launch: CUDA error 700"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
])
def test_server_never_retries_a_kernel_fault(tmp_path, monkeypatch, fault):
    """A build or CUDA error is permanent even when ``retry_on`` would match
    it (or it claims to be transient); the breaker counts it."""
    feats, labs, _, _ = _dataset(n=80)
    fault.transient = True

    def broken(self, *a, **kw):
        raise fault

    monkeypatch.setattr(MiloSession, "build_metadata", broken)
    br = CircuitBreaker(threshold=1, cooldown=1e9)
    with MiloServer(_serve_config(), device=CPU, num_workers=1, breaker=br,
                    retry_policy=RetryPolicy(base_delay=0.0, retry_on=(RuntimeError,))) as srv:
        rid = srv.submit("preprocess", features=feats, labels=labs)
        with pytest.raises(RuntimeError):
            srv.result(rid, timeout=60)
        assert srv.poll(rid)["attempts"] == 1 and srv.stats()["retries"] == 0
        assert len(srv.health()["tripped_keys"]) == 1


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

def test_retry_policy_delays_match_reference():
    for kw in (dict(), dict(base_delay=0.1, max_delay=1.0, jitter=0.25),
               dict(base_delay=0.02, max_delay=0.5, jitter=0.0)):
        pt, pj = RetryPolicy(**kw), JS.RetryPolicy(**kw)
        for rid in ("r000000", "r000001", "r123456"):
            for attempt in range(1, 12):
                assert pt.delay(rid, attempt) == pj.delay(rid, attempt)
    p = RetryPolicy()
    assert p.is_transient(TransientServeError("x")) and p.is_transient(TransientFault("x"))
    assert p.is_transient(ConnectionError()) and not p.is_transient(ValueError("x"))
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)


# ---------------------------------------------------------------------------
# the server's tune against the reference server's trial stream
# ---------------------------------------------------------------------------

EXAMPLE = dict(subset_fraction=0.1, n_sge_subsets=4, total_epochs=30, eval_every_epochs=10)
TUNE_SPACE = {"lr": ("log", 3e-3, 0.3), "hidden": ("choice", [32, 64, 128])}
ACC_BOUND = 1 / 120     # one validation row (tests/test_torch_tune.py)


def test_server_tune_replays_the_reference_servers_trials(tmp_path, monkeypatch):
    """One store root: the reference server builds the artifact, the port's
    server loads it from disk; with the reference's initial parameters and
    WRE draws carried in, the port's sweep samples the same configs at the
    same budgets and scores each within one validation row."""
    ds = GaussianMixtureDataset(n=1200, n_classes=6, dim=24, seed=0)
    tr, va, _ = ds.split()
    feats, labs, vx, vy = ds.features()[tr], ds.y[tr], ds.x[va], ds.y[va]
    root = str(tmp_path / "store")
    kw = dict(selector="milo", max_budget=3, eta=3, seed=0)
    with JS.MiloServer(jsel.MiloSessionConfig(**EXAMPLE), store_root=root,
                       num_workers=1) as jsrv:
        rid = jsrv.submit("tune", features=feats, labels=labs, val_x=vx, val_y=vy,
                          space=TUNE_SPACE, **kw)
        ref = jsrv.result(rid, timeout=600)
        assert jsrv.poll(rid)["artifact_source"] == "built"

    def reference_init(gen, d_in, n_classes, hidden, *, device):
        p = jinit_mlp(jax.random.PRNGKey(0), d_in, n_classes, hidden)
        return params_from_jax({k: np.asarray(v) for k, v in p.items()}, device)

    monkeypatch.setattr(tsession, "init_mlp", reference_init)
    wre = lambda window: np.asarray(jax.random.gumbel(  # noqa: E731
        jax.random.fold_in(jax.random.PRNGKey(0), window), (len(feats),)))
    with MiloServer(MiloSessionConfig(**EXAMPLE), device=CPU, store_root=root,
                    num_workers=1) as srv:
        rid = srv.submit("tune", features=feats, labels=labs, val_x=vx, val_y=vy,
                         space=TUNE_SPACE, wre_noise=wre, **kw)
        res = srv.result(rid, timeout=600)
        assert srv.poll(rid)["artifact_source"] == "disk"
        assert srv.store.builds == 0
    assert [(t["config"], t["budget"]) for t in res.trials] == \
           [(t["config"], t["budget"]) for t in ref.trials]
    gaps = [abs(a["score"] - b["score"]) for a, b in zip(res.trials, ref.trials)]
    assert max(gaps) <= ACC_BOUND, gaps
    assert res.total_epochs == ref.total_epochs


def test_lm_engine_shim_reexports():
    from repro_torch.serve import engine as shim
    from repro_torch.serve import lm_engine

    assert shim.ServeEngine is lm_engine.ServeEngine and shim.Request is lm_engine.Request
