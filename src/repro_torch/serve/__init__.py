"""repro_torch.serve — selection as a service, and the LM engine (port of
``repro.serve``).

* ``MiloServer`` / ``MiloClient`` — persistent multi-tenant selection
  server: versioned artifact store, warm pool, shared device buffers,
  worker-thread request lifecycle (submit/poll/result/cancel, deadlines,
  transient-failure retry under ``RetryPolicy``, structured request log,
  bounded-queue admission raising ``ServerOverloadedError``, per-key
  ``CircuitBreaker`` around artifact builds, ``health()`` endpoint).
* ``ArtifactStore`` — (data_fingerprint, config_hash)-keyed two-tier
  (memory LRU + disk) ``MiloMetadata`` store with single-flight builds,
  pinning, and per-key versions.
* ``BufferRegistry`` — device-resident column dedup: N concurrent
  sessions over one dataset share one device copy per column.
* ``ServeEngine`` (``serve.lm_engine``) — the batched LM decode engine;
  unrelated workload, same package.
"""
from repro_torch.health.breaker import CircuitBreaker, CircuitOpenError
from repro_torch.serve.buffers import BufferRegistry, array_fingerprint
from repro_torch.serve.server import (
    CANCELLED,
    DONE,
    ERROR,
    EXPIRED,
    QUEUED,
    RUNNING,
    MiloClient,
    MiloServer,
    RetryPolicy,
    ServeRequest,
    ServerOverloadedError,
    TransientServeError,
    artifact_request_config,
)
from repro_torch.serve.store import ArtifactEntry, ArtifactKey, ArtifactStore

__all__ = [
    "ArtifactEntry",
    "ArtifactKey",
    "ArtifactStore",
    "BufferRegistry",
    "CircuitBreaker",
    "CircuitOpenError",
    "MiloClient",
    "MiloServer",
    "RetryPolicy",
    "ServeRequest",
    "ServerOverloadedError",
    "TransientServeError",
    "array_fingerprint",
    "artifact_request_config",
    "QUEUED",
    "RUNNING",
    "DONE",
    "ERROR",
    "CANCELLED",
    "EXPIRED",
]
