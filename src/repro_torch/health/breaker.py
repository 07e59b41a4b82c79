"""Per-key circuit breaker for deterministically-failing builds (a copy of
``repro.health.breaker``: threads and a clock, nothing else).

The retry layer assumes failures are *transient*: it re-runs the build
with deterministic backoff.  When the failure is deterministic (poisoned
features, an impossible config), every retry re-pays the full build cost
and every queued request behind it does too.  The breaker records
consecutive failures per artifact key and, once ``threshold`` is reached,
fails subsequent attempts fast with :class:`CircuitOpenError` until
``cooldown`` seconds pass — after which exactly one probe request is let
through (half-open): success closes the circuit, failure re-opens it.

The clock is injectable (``clock=time.monotonic`` by default) so state
transitions are exactly testable without sleeping.  All methods are
thread-safe; keys are anything hashable (``MiloServer`` uses its artifact
store keys).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Hashable


class CircuitOpenError(RuntimeError):
    """Fast-fail: the circuit for this key is open.

    Deliberately *not* transient (no ``.transient`` attribute): the retry
    layer must not retry through an open breaker — that would defeat it.
    """


class _KeyState:
    __slots__ = ("failures", "opened_at", "probing")

    def __init__(self):
        self.failures = 0
        self.opened_at: float | None = None
        self.probing = False


class CircuitBreaker:
    """Keyed closed → open → half-open breaker over consecutive failures."""

    def __init__(self, *, threshold: int = 3, cooldown: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        if threshold < 1:
            raise ValueError("threshold must be >= 1")
        self.threshold = int(threshold)
        self.cooldown = float(cooldown)
        self.clock = clock
        self._lock = threading.Lock()
        self._keys: dict[Hashable, _KeyState] = {}

    def _state(self, key: Hashable) -> _KeyState:
        st = self._keys.get(key)
        if st is None:
            st = self._keys[key] = _KeyState()
        return st

    def check(self, key: Hashable) -> None:
        """Gate an attempt: no-op when closed, raises when open.

        When the cooldown has elapsed the first caller through becomes the
        half-open probe; concurrent callers still fail fast until the
        probe reports success or failure.
        """
        with self._lock:
            st = self._keys.get(key)
            if st is None or st.opened_at is None:
                return
            elapsed = self.clock() - st.opened_at
            if elapsed < self.cooldown:
                raise CircuitOpenError(
                    f"circuit open for {key!r}: {st.failures} consecutive "
                    f"build failures; fast-failing for another "
                    f"{self.cooldown - elapsed:.1f}s")
            if st.probing:
                raise CircuitOpenError(
                    f"circuit half-open for {key!r}: probe already in flight")
            st.probing = True

    def record_success(self, key: Hashable) -> None:
        with self._lock:
            self._keys.pop(key, None)

    def record_failure(self, key: Hashable) -> None:
        with self._lock:
            st = self._state(key)
            st.failures += 1
            st.probing = False
            if st.failures >= self.threshold:
                st.opened_at = self.clock()   # (re-)open, restart cooldown

    def state(self, key: Hashable) -> str:
        """'closed' | 'open' | 'half_open' for diagnostics."""
        with self._lock:
            st = self._keys.get(key)
            if st is None or st.opened_at is None:
                return "closed"
            if self.clock() - st.opened_at < self.cooldown:
                return "open"
            return "half_open"

    def snapshot(self) -> dict[str, dict[str, Any]]:
        """JSON-safe per-key view for ``health()`` endpoints."""
        with self._lock:
            keys = list(self._keys.items())
        out: dict[str, dict[str, Any]] = {}
        for key, st in keys:
            out[str(key)] = {
                "state": self.state(key),
                "failures": st.failures,
            }
        return out
