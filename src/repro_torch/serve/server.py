"""Selection-as-a-service: the persistent multi-tenant ``MiloServer`` (port
of ``repro.serve.server``).

MILO's central economic claim is that the model-agnostic preprocessing pass
is paid ONCE per (dataset, config) and amortised across every downstream
training and tuning trial.  ``MiloServer`` makes that a property of a
long-lived process that N tenants submit train/tune requests to, where

  * the **artifact store** (``serve.store.ArtifactStore``) resolves each
    request's ``(data_fingerprint, config_hash)`` key against memory →
    disk → a single-flight preprocessing build, so concurrent identical
    requests trigger exactly one preprocessing run;
  * the **warm pool** readies everything a request needs before it
    arrives: ``MiloPreprocessor.warmup`` replays the selection engines per
    class geometry (loading the kernel library), and one throwaway tune
    per (dataset, eval shape) captures the fused engine's CUDA graphs.  A
    warm repeat request captures no graph (``train.engine.captures``) and
    builds or loads no kernel library (``kernels._build.builds`` /
    ``loads``);
  * the **buffer registry** (``serve.buffers.BufferRegistry``) places each
    dataset column on the device once, shared by every session, so the
    fused engine keeps its graphs from tenant to tenant;
  * the **request lifecycle** layer runs submissions on worker threads with
    per-request deadlines and cancellation (polled between Hyperband rungs
    via ``should_stop``), classifies failures transient-vs-permanent and
    retries transient ones under ``RetryPolicy`` (exponential backoff with
    deterministic jitter, interruptible by cancel), and appends one
    structured row per request — including its attempt count — to the
    request log.  A fault of the kernel layer or the card (a failed build,
    a CUDA error, a wrapper's refusal: ``kernels._build.is_kernel_fault``)
    is permanent: never retried, and counted by the breaker;
  * the **hardening layer** bounds the queue — ``submit`` raises
    ``ServerOverloadedError`` synchronously at ``max_queue`` pending
    requests — and puts a per-key ``health.CircuitBreaker`` around artifact
    builds, so a key whose build fails deterministically fast-fails
    (``CircuitOpenError``) after ``threshold`` consecutive failures while
    cached artifacts keep serving; ``health()`` reports ok/degraded with the
    evidence.

``MiloClient`` is the thin synchronous facade a tenant holds; the transport
is in-process (function calls + queues).  The server runs its sessions on
``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import queue
import threading
import time
import weakref
from typing import Any, Callable

import numpy as np

import torch

from repro_torch.core.metadata import MiloMetadata, config_hash
from repro_torch.device import resolve_device
from repro_torch.distributed.multihost import HeartbeatMonitor
from repro_torch.health.breaker import CircuitBreaker, CircuitOpenError
from repro_torch.kernels._build import is_kernel_fault
from repro_torch.selection.session import (
    MiloSession,
    MiloSessionConfig,
    _data_fingerprint,
)
from repro_torch.serve.buffers import BufferRegistry
from repro_torch.serve.store import ArtifactKey, ArtifactStore


def _with_overrides(
    cfg: MiloSessionConfig, overrides: dict[str, Any] | None
) -> MiloSessionConfig:
    """Per-request config = base config + overrides, with persistence kept
    under the store's control whatever the overrides say."""
    if not overrides:
        return cfg
    ov = dict(overrides)
    ov["metadata_path"] = None
    return dataclasses.replace(cfg, **ov)

class ServerOverloadedError(RuntimeError):
    """Fast-fail at admission: the submit queue is at ``max_queue``.

    Raised synchronously from :meth:`MiloServer.submit` — the request is
    never enqueued, so the caller can shed load or back off on its own
    schedule instead of silently deepening an unbounded queue.  Deliberately
    not transient: retrying into a full queue is the problem, not the fix.
    """


class TransientServeError(RuntimeError):
    """An error the server should retry: the failure is a property of the
    attempt (a flaky artifact build, a contended resource), not of the
    request.  Raise it — or any exception carrying a truthy ``transient``
    attribute — from a handler to opt into the retry policy."""

    transient = True


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic jitter for transient failures.

    Attempt ``k`` (1-indexed) that fails transiently sleeps
    ``min(max_delay, base_delay * 2**(k-1)) * (1 + jitter * u)`` before the
    next try, where ``u ∈ [0, 1)`` is derived by hashing
    ``(request_id, attempt)`` — jittered like production backoff (no
    thundering herd of identical schedules) yet bit-reproducible across
    runs, which is what lets the fault suite assert exact retry behavior.
    The backoff sleep waits on the request's cancel event, so cancellation
    interrupts it immediately.

    ``retry_on`` lists the exception types classified transient; any
    exception with a truthy ``transient`` attribute also qualifies (the
    duck-typed escape hatch for errors the server does not know by type).
    Everything else is permanent and fails the request on first raise, and
    so is a fault of the kernel layer or the card whatever ``retry_on``
    says: a build, a launch or the card that failed once fails again.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.25
    retry_on: tuple = (TransientServeError, ConnectionError, TimeoutError)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")

    def is_transient(self, exc: BaseException) -> bool:
        if is_kernel_fault(exc):
            return False
        return isinstance(exc, self.retry_on) or bool(
            getattr(exc, "transient", False))

    def delay(self, request_id: str, attempt: int) -> float:
        """Backoff before attempt ``attempt + 1``; deterministic per
        (request, attempt)."""
        base = min(self.max_delay, self.base_delay * (2 ** (attempt - 1)))
        if self.jitter <= 0:
            return base
        digest = hashlib.sha256(f"{request_id}:{attempt}".encode()).digest()
        u = int.from_bytes(digest[:8], "little") / 2.0 ** 64
        return base * (1.0 + self.jitter * u)


#: request lifecycle states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
ERROR = "error"
CANCELLED = "cancelled"
EXPIRED = "expired"

_TERMINAL = frozenset({DONE, ERROR, CANCELLED, EXPIRED})


@dataclasses.dataclass
class ServeRequest:
    """One submitted unit of work and its full lifecycle record."""

    request_id: str
    kind: str                       # "preprocess" | "train" | "tune"
    tenant: str
    payload: dict[str, Any]
    config: MiloSessionConfig
    deadline: float | None = None   # absolute wall-clock time, None = none
    pin: bool = False
    status: str = QUEUED
    result: Any = None
    error: BaseException | None = None
    artifact_key: ArtifactKey | None = None
    artifact_version: int | None = None
    artifact_source: str | None = None   # "memory" | "disk" | "built"
    submitted: float = 0.0
    started: float | None = None
    finished: float | None = None
    attempts: int = 0               # handler invocations (1 + retries)
    cancel_event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    done_event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)

    def snapshot(self) -> dict[str, Any]:
        """Structured view for poll() and the request log (no live objects)."""
        return {
            "request_id": self.request_id,
            "kind": self.kind,
            "tenant": self.tenant,
            "status": self.status,
            "artifact_key": self.artifact_key,
            "artifact_version": self.artifact_version,
            "artifact_source": self.artifact_source,
            "submitted": self.submitted,
            "started": self.started,
            "finished": self.finished,
            "attempts": self.attempts,
            "error": repr(self.error) if self.error is not None else None,
        }


def artifact_request_config(cfg: MiloSessionConfig) -> dict[str, Any]:
    """The config view an artifact is keyed and verified on: the base
    reuse-guard keys plus every knob that changes the selection trajectories
    the artifact holds.  Deliberately excludes mesh/runtime knobs
    (``shard_selection``, ``gram_block``, ...) — artifacts are portable
    across those, exactly as ``MiloSession._load_artifact`` tolerates."""
    req = cfg.expected_artifact_config()
    req.update(
        gram_free=cfg.gram_free,
        bucket_classes=cfg.bucket_classes,
        lazy_gains=cfg.lazy_gains,
        exact_sge_candidates=cfg.exact_sge_candidates,
        prep_seed=cfg.resolved_prep_seed(),
    )
    if cfg.lazy_gains:
        req["lazy_threshold"] = cfg.lazy_threshold
    return req


class MiloServer:
    """Persistent multi-tenant selection server (in-process).

    ::

        server = MiloServer(MiloSessionConfig(...), store_root="artifacts")
        server.start()
        server.warm(features, labels, val_x=vx, val_y=vy, space=SPACE)
        rid = server.submit("tune", features=..., labels=..., val_x=...,
                            val_y=..., space=SPACE, deadline=30.0)
        best = server.result(rid)          # HyperbandResult
        server.shutdown()

    Also usable as a context manager (``with MiloServer(...) as s:``).
    """

    KINDS = ("preprocess", "train", "tune")

    def __init__(
        self,
        config: MiloSessionConfig | None = None,
        *,
        device: str | torch.device = "cuda",
        store_root: str | None = None,
        store_capacity: int = 8,
        num_workers: int = 2,
        retry_policy: RetryPolicy | None = None,
        max_queue: int = 256,
        breaker: CircuitBreaker | None = None,
        heartbeat_dir: str | None = None,
        heartbeat_timeout: float = 60.0,
        heartbeat_monitor: Any | None = None,
        **config_overrides: Any,
    ):
        cfg = config if config is not None else MiloSessionConfig()
        if config_overrides:
            cfg = dataclasses.replace(cfg, **config_overrides)
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.device = resolve_device(device)
        # the store owns persistence; a session-level metadata_path would
        # write a second, unversioned copy outside the server's control
        self.config = dataclasses.replace(cfg, metadata_path=None)
        self.store = ArtifactStore(store_root, capacity=store_capacity)
        self.buffers = BufferRegistry(self.device)
        self.num_workers = max(1, int(num_workers))
        self.retry_policy = (retry_policy if retry_policy is not None
                             else RetryPolicy())
        self.max_queue = int(max_queue)
        # per-artifact-key circuit breaker around store builds: a key whose
        # build fails deterministically stops burning worker time after
        # `threshold` consecutive failures (fast CircuitOpenError instead),
        # while cached artifacts for that key keep serving
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        # host liveness (multi-host deployments): health() folds per-host
        # heartbeat ages into its verdict — any stale peer ⇒ "degraded".
        # Pass heartbeat_monitor directly for a custom clock/expected-set;
        # otherwise heartbeat_dir builds one over the shared beacon dir.
        if heartbeat_monitor is not None:
            self.liveness: HeartbeatMonitor | None = heartbeat_monitor
        elif heartbeat_dir is not None:
            self.liveness = HeartbeatMonitor(
                heartbeat_dir, timeout=heartbeat_timeout)
        else:
            self.liveness = None
        self._queued = 0          # admission-controlled queue depth
        self._retries = 0         # transient failures that were retried
        self._failures = 0        # requests that terminated in ERROR
        self._sessions: dict[tuple, MiloSession] = {}
        self._requests: dict[str, ServeRequest] = {}
        self._log: list[dict[str, Any]] = []
        self._warmed: set[tuple] = set()
        self._fp_memo: dict[int, tuple[weakref.ref, str]] = {}
        self._lock = threading.RLock()
        self._queue: "queue.Queue[ServeRequest | None]" = queue.Queue()
        self._ids = itertools.count()
        self._workers: list[threading.Thread] = []
        self._started = False

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "MiloServer":
        with self._lock:
            if self._started:
                return self
            self._started = True
            for i in range(self.num_workers):
                t = threading.Thread(
                    target=self._worker_loop, daemon=True,
                    name=f"milo-serve-worker-{i}",
                )
                t.start()
                self._workers.append(t)
        return self

    def shutdown(self, *, wait: bool = True) -> None:
        """Stop the workers.  Queued requests still drain (each worker exits
        on its sentinel, which sits behind them in the queue)."""
        with self._lock:
            if not self._started:
                return
            self._started = False
            workers, self._workers = self._workers, []
        for _ in workers:
            self._queue.put(None)
        if wait:
            for t in workers:
                t.join()

    def __enter__(self) -> "MiloServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.shutdown()

    # -- submission ---------------------------------------------------------

    def submit(
        self,
        kind: str,
        *,
        features: np.ndarray,
        labels: np.ndarray | None = None,
        tenant: str = "default",
        deadline: float | None = None,
        pin: bool = False,
        overrides: dict[str, Any] | None = None,
        **payload: Any,
    ) -> str:
        """Enqueue a request; returns its id immediately.

        ``deadline`` is RELATIVE seconds from submission (converted to an
        absolute wall time here); an expired request never starts, and a
        running tune stops at the next hyperband rung boundary.
        ``overrides`` are per-tenant ``MiloSessionConfig`` field overrides on
        the server's base config — preprocessing-affecting overrides change
        the artifact key, so tenants can never poison each other's cache.
        """
        if kind not in self.KINDS:
            raise ValueError(f"unknown request kind {kind!r}; one of {self.KINDS}")
        if not self._started:
            raise RuntimeError("server not started: call start() first")
        cfg = _with_overrides(self.config, overrides)
        req = ServeRequest(
            request_id=f"r{next(self._ids):06d}",
            kind=kind,
            tenant=tenant,
            payload={"features": features, "labels": labels, **payload},
            config=cfg,
            deadline=(time.time() + deadline) if deadline is not None else None,
            pin=pin,
            submitted=time.time(),
        )
        with self._lock:
            # bounded admission: fail fast at submit time rather than
            # accepting work the workers are hopelessly behind on
            if self._queued >= self.max_queue:
                raise ServerOverloadedError(
                    f"queue full ({self._queued}/{self.max_queue} requests "
                    f"pending); retry later or raise max_queue")
            self._queued += 1
            self._requests[req.request_id] = req
        self._queue.put(req)
        return req.request_id

    def poll(self, request_id: str) -> dict[str, Any]:
        """Non-blocking status snapshot."""
        return self._request(request_id).snapshot()

    def result(self, request_id: str, *, timeout: float | None = None) -> Any:
        """Block until the request reaches a terminal state; return its
        result.  Re-raises the worker's exception for ERROR requests and
        raises ``TimeoutError`` for cancelled/expired ones (the result a
        stopped tune did compute is still on ``poll()``'s ``status`` +
        ``ServeRequest.result``)."""
        req = self._request(request_id)
        if not req.done_event.wait(timeout):
            raise TimeoutError(f"{request_id} still {req.status} after {timeout}s")
        if req.status == ERROR:
            raise req.error
        if req.status in (CANCELLED, EXPIRED):
            raise TimeoutError(f"{request_id} was {req.status}")
        return req.result

    def cancel(self, request_id: str) -> bool:
        """Request cancellation.  Queued requests never start; running tunes
        stop at the next rung boundary.  Returns False once terminal."""
        req = self._request(request_id)
        if req.status in _TERMINAL:
            return False
        req.cancel_event.set()
        return True

    def request_log(self) -> list[dict[str, Any]]:
        """One structured row per COMPLETED request, in completion order."""
        with self._lock:
            return [dict(row) for row in self._log]

    def stats(self) -> dict[str, Any]:
        with self._lock:
            statuses: dict[str, int] = {}
            for r in self._requests.values():
                statuses[r.status] = statuses.get(r.status, 0) + 1
            retries, failures = self._retries, self._failures
        return {
            "requests": statuses,
            "retries": retries,
            "failures": failures,
            "store": self.store.stats(),
            "buffers": self.buffers.stats(),
            "sessions": len(self._sessions),
            "warmed": len(self._warmed),
        }

    def health(self) -> dict[str, Any]:
        """Operational health snapshot (JSON-safe).

        ``status`` is ``"ok"`` when the server is accepting work with every
        circuit closed, ``"degraded"`` when any artifact key's breaker is
        open/half-open, the queue is at capacity, or (when a heartbeat
        monitor is attached) any expected host's beacon is stale, and
        ``"stopped"`` after shutdown.  The rest is the evidence: queue
        depth vs. limit, the per-key breaker snapshot, per-host heartbeat
        ages, store/retry/failure counters.
        """
        with self._lock:
            started = self._started
            queued = self._queued
            retries, failures = self._retries, self._failures
        breakers = self.breaker.snapshot()
        tripped = sorted(
            k for k, st in breakers.items() if st["state"] != "closed")
        hosts = self.liveness.snapshot() if self.liveness is not None else None
        stale_hosts = hosts["stale"] if hosts is not None else []
        if not started:
            status = "stopped"
        elif tripped or stale_hosts or queued >= self.max_queue:
            status = "degraded"
        else:
            status = "ok"
        out = {
            "status": status,
            "queue": {"depth": queued, "limit": self.max_queue},
            "breakers": breakers,
            "tripped_keys": tripped,
            "retries": retries,
            "failures": failures,
            "store": self.store.stats(),
        }
        if hosts is not None:
            out["hosts"] = hosts
        return out

    # -- warm pool ----------------------------------------------------------

    def warm(
        self,
        features: np.ndarray,
        labels: np.ndarray | None = None,
        *,
        val_x: np.ndarray | None = None,
        val_y: np.ndarray | None = None,
        space: dict | None = None,
        pin: bool = True,
        overrides: dict[str, Any] | None = None,
    ) -> dict[str, Any]:
        """Pre-build the artifact and ready everything tune/train requests
        over this dataset will touch.

        Three layers, mirroring what a request touches:
          1. the artifact itself (store build, pinned against eviction),
          2. ``MiloPreprocessor.warmup`` over the dataset's true class
             geometry — covers a future ``force=True`` rebuild,
          3. when ``val_x``/``val_y``/``space`` are given, ONE throwaway tune
             replay with the same shapes — captures the fused engine's
             graphs (lr lives in the state's tensors, so any lr the search
             samples later replays them; a width the replay did not sample
             is captured by the first request that does).

        Synchronous and idempotent per (artifact, eval-shape) signature;
        call before accepting traffic.  After it, repeat requests capture
        no CUDA graph and build or load no kernel library.
        """
        cfg = _with_overrides(self.config, overrides)
        md, key, session, _ = self._ensure_artifact(
            cfg, features, labels, pin=pin)
        sig = (key, None if val_x is None else np.shape(val_x),
               None if space is None else tuple(sorted(space)))
        with self._lock:
            already = sig in self._warmed
        if already:
            return {"artifact_key": key, "warmed_geometries": 0,
                    "tune_replayed": False}
        from repro_torch.core.partition import proportional_budgets

        labs = (np.zeros(len(features), np.int64) if labels is None
                else np.asarray(labels))
        pre = cfg.preprocessor(self.device)
        # replay the preprocessor's own decomposition (strategy-aware, so
        # hierarchical geometries warm the same per-partition + refine
        # paths a rebuild would run)
        parts = pre.partition_strategy().partition(
            labs if cfg.classwise else None, len(features))
        if len(parts) > 1:
            buckets = [(len(p.indices), b)
                       for p, b in zip(parts, proportional_budgets(parts, md.k))]
        else:
            buckets = [(len(features), md.k)]
        warmed = pre.warmup(buckets, d=int(np.shape(features)[1]))
        replayed = False
        if val_x is not None and val_y is not None and space is not None:
            session.tune(features, labels, val_x, val_y, space,
                         max_budget=3, eta=3)
            replayed = True
        with self._lock:
            self._warmed.add(sig)
        return {"artifact_key": key, "warmed_geometries": warmed,
                "tune_replayed": replayed}

    # -- internals ----------------------------------------------------------

    def _request(self, request_id: str) -> ServeRequest:
        with self._lock:
            req = self._requests.get(request_id)
        if req is None:
            raise KeyError(f"unknown request id {request_id!r}")
        return req

    def data_fingerprint(self, features: np.ndarray) -> str:
        """``selection.session._data_fingerprint`` with an identity memo, so
        N requests carrying the same host matrix hash it once."""
        features = np.asarray(features)
        with self._lock:
            cached = self._fp_memo.get(id(features))
            if cached is not None:
                ref, fp = cached
                if ref() is features:
                    return fp
                del self._fp_memo[id(features)]
        fp = _data_fingerprint(features)
        with self._lock:
            try:
                self._fp_memo[id(features)] = (weakref.ref(features), fp)
            except TypeError:  # pragma: no cover — non-weakref-able input
                pass
        return fp

    def _ensure_artifact(
        self,
        cfg: MiloSessionConfig,
        features: np.ndarray,
        labels: np.ndarray | None,
        *,
        pin: bool = False,
        force: bool = False,
    ) -> tuple[MiloMetadata, ArtifactKey, MiloSession, tuple[int, str]]:
        """Resolve (or single-flight build) the request's artifact and the
        session that serves it; returns (md, key, session, (version, source))."""
        req_config = artifact_request_config(cfg)
        fp = self.data_fingerprint(features)
        key = self.store.key_for(fp, req_config)
        session = self._session_for(key, cfg)

        def guarded_build() -> MiloMetadata:
            # the breaker gates BUILDS only — memory/disk hits for the key
            # keep serving while its circuit is open (a cached artifact is
            # fine; re-paying a deterministically-failing build is not)
            self.breaker.check(key)
            try:
                md = session.build_metadata(features, labels, fingerprint=fp)
            except CircuitOpenError:
                raise
            except BaseException:
                self.breaker.record_failure(key)
                raise
            self.breaker.record_success(key)
            return md

        md, entry, source = self.store.get_or_build(
            key, req_config, guarded_build, pin=pin, force=force,
        )
        if session.metadata is not md:
            session.adopt_metadata(md, loaded=source != "built")
        return md, key, session, (entry.version, source)

    def _session_for(self, key: ArtifactKey, cfg: MiloSessionConfig) -> MiloSession:
        """One session per (artifact, downstream-config): its step functions
        (and so the fused engine's graphs) and adopted metadata persist
        across requests.  Sessions share the
        server's buffer registry, so their Trainers share device columns."""
        skey = (key, config_hash(dataclasses.asdict(cfg)))
        with self._lock:
            sess = self._sessions.get(skey)
            if sess is None:
                sess = MiloSession(cfg, device=self.device, buffer_registry=self.buffers)
                self._sessions[skey] = sess
            return sess

    def _worker_loop(self) -> None:
        while True:
            req = self._queue.get()
            if req is None:
                return
            with self._lock:
                self._queued -= 1
            self._execute(req)

    def _finish(self, req: ServeRequest, status: str) -> None:
        req.status = status
        req.finished = time.time()
        req.done_event.set()
        with self._lock:
            self._log.append(req.snapshot())

    def _should_retry(self, req: ServeRequest, exc: BaseException) -> bool:
        """Retry iff the error is transient, attempts remain, and the
        request is still live (not cancelled, deadline not passed)."""
        policy = self.retry_policy
        if not policy.is_transient(exc):
            return False
        if req.attempts >= policy.max_attempts:
            return False
        if req.cancel_event.is_set():
            return False
        if req.deadline is not None and time.time() > req.deadline:
            return False
        return True

    def _execute(self, req: ServeRequest) -> None:
        if req.cancel_event.is_set():
            self._finish(req, CANCELLED)
            return
        if req.deadline is not None and time.time() > req.deadline:
            self._finish(req, EXPIRED)
            return
        req.status = RUNNING
        req.started = time.time()
        handler: Callable[[ServeRequest], Any] = getattr(self, f"_run_{req.kind}")
        while True:
            req.attempts += 1
            try:
                req.result = handler(req)
            except BaseException as e:  # noqa: BLE001 — re-raised in result()
                req.error = e
                if not self._should_retry(req, e):
                    with self._lock:
                        self._failures += 1
                    self._finish(req, ERROR)
                    return
                with self._lock:
                    self._retries += 1
                # backoff on the cancel event: a cancel() mid-backoff wakes
                # the wait immediately instead of sleeping the delay out
                if req.cancel_event.wait(
                        self.retry_policy.delay(req.request_id, req.attempts)):
                    self._finish(req, CANCELLED)
                    return
                continue
            # a retried-then-succeeded request is a success, not an error
            req.error = None
            break
        stopped = bool(getattr(req.result, "stopped", False))
        if req.cancel_event.is_set():
            self._finish(req, CANCELLED)
        elif stopped or (req.deadline is not None and time.time() > req.deadline):
            # a tune that should_stop ended early, or a train that ran past
            # its deadline (trains have no mid-run poll point)
            self._finish(req, EXPIRED)
        else:
            self._finish(req, DONE)

    def _resolve(self, req: ServeRequest, *, pin: bool = False,
                 force: bool = False) -> tuple[MiloMetadata, MiloSession]:
        p = req.payload
        md, key, session, (version, source) = self._ensure_artifact(
            req.config, p["features"], p["labels"],
            pin=pin or req.pin, force=force,
        )
        req.artifact_key = key
        req.artifact_version = version
        req.artifact_source = source
        return md, session

    # -- request handlers ---------------------------------------------------

    def _run_preprocess(self, req: ServeRequest) -> dict[str, Any]:
        _, _ = self._resolve(req, force=bool(req.payload.get("force", False)))
        return {
            "artifact_key": req.artifact_key,
            "version": req.artifact_version,
            "source": req.artifact_source,
        }

    def _run_train(self, req: ServeRequest):
        _, session = self._resolve(req)
        p = dict(req.payload)
        features, labels = p.pop("features"), p.pop("labels")
        p.pop("force", None)
        return session.train(features, labels, **p)

    def _run_tune(self, req: ServeRequest):
        _, session = self._resolve(req)
        p = dict(req.payload)
        features, labels = p.pop("features"), p.pop("labels")
        p.pop("force", None)

        def should_stop() -> bool:
            return req.cancel_event.is_set() or (
                req.deadline is not None and time.time() > req.deadline
            )

        return session.tune(features, labels, should_stop=should_stop, **p)


class MiloClient:
    """Thin synchronous tenant facade over one ``MiloServer``."""

    def __init__(self, server: MiloServer, *, tenant: str = "default",
                 overrides: dict[str, Any] | None = None):
        self.server = server
        self.tenant = tenant
        self.overrides = dict(overrides) if overrides else None

    def _submit(self, kind: str, **kw: Any) -> str:
        return self.server.submit(
            kind, tenant=self.tenant, overrides=self.overrides, **kw)

    def preprocess(self, features, labels=None, *, pin: bool = False,
                   force: bool = False, deadline: float | None = None):
        rid = self._submit("preprocess", features=features, labels=labels,
                           pin=pin, force=force, deadline=deadline)
        return self.server.result(rid)

    def train(self, features, labels, *, test_x, test_y,
              deadline: float | None = None, **kw: Any):
        rid = self._submit("train", features=features, labels=labels,
                           test_x=test_x, test_y=test_y, deadline=deadline, **kw)
        return self.server.result(rid)

    def tune(self, features, labels, val_x, val_y, space, *,
             deadline: float | None = None, **kw: Any):
        rid = self._submit("tune", features=features, labels=labels,
                           val_x=val_x, val_y=val_y, space=space,
                           deadline=deadline, **kw)
        return self.server.result(rid)

    # async variants: submit now, collect with server.poll/result later
    def submit_tune(self, features, labels, val_x, val_y, space, *,
                    deadline: float | None = None, **kw: Any) -> str:
        return self._submit("tune", features=features, labels=labels,
                            val_x=val_x, val_y=val_y, space=space,
                            deadline=deadline, **kw)

    def submit_train(self, features, labels, *, test_x, test_y,
                     deadline: float | None = None, **kw: Any) -> str:
        return self._submit("train", features=features, labels=labels,
                            test_x=test_x, test_y=test_y, deadline=deadline,
                            **kw)
