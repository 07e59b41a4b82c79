"""Host liveness beacons (the single-process part of
``repro.distributed.multihost``: ``HeartbeatWriter`` and
``HeartbeatMonitor``).

Each host writes ``<dir>/host_<i>.json`` (its index and the time, atomic
temp file + rename); a monitor reads every beacon and names the hosts whose
last beat is older than its timeout.  ``serve.MiloServer.health()`` folds
the monitor's snapshot into its verdict.  The file format is the
reference's, so either package's monitor reads the other's beacons.  The
rest of the reference's module (process-group start-up, barriers, global
placement) waits for multi-host execution (ROADMAP A11).
"""
from __future__ import annotations

import json
import os
import re
import time
from typing import Any, Callable

from repro_torch.distributed.fault_tolerance import HostLossError

_HOST_RE = re.compile(r"^host_(\d+)\.json$")


class HeartbeatWriter:
    """Writes this host's liveness beacon: ``<dir>/host_<i>.json``.

    Atomic (temp file + rename) so a monitor never parses a torn beat; NOT
    fsync'd — a heartbeat is a freshness signal, not durable state, and an
    fsync per training step would be a straggler generator.
    """

    def __init__(
        self,
        directory: str,
        proc_index: int = 0,
        *,
        clock: Callable[[], float] = time.time,
    ):
        self.directory = directory
        self.index = int(proc_index)
        self.clock = clock
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, f"host_{self.index}.json")

    def beat(self, step: int | None = None) -> None:
        payload = {"process_index": self.index, "time": self.clock()}
        if step is not None:
            payload["step"] = int(step)
        tmp = f"{self.path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)


class HeartbeatMonitor:
    """Reads every host's beacon and flags the stale/missing ones.

    ``expected`` hosts with no beacon file at all count as stale from the
    monitor's construction (age = now - created) — a host that never wrote a
    beat is indistinguishable from one that died before its first.  The
    injectable ``clock`` makes staleness a pure function of test inputs.
    """

    def __init__(
        self,
        directory: str,
        *,
        timeout: float = 60.0,
        expected: int | None = None,
        clock: Callable[[], float] = time.time,
    ):
        self.directory = directory
        self.timeout = float(timeout)
        self.expected = expected
        self.clock = clock
        self._created = clock()

    def _beats(self) -> dict[int, dict[str, Any]]:
        out: dict[int, dict[str, Any]] = {}
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return out
        for fn in names:
            m = _HOST_RE.match(fn)
            if not m:
                continue
            try:
                with open(os.path.join(self.directory, fn)) as f:
                    out[int(m.group(1))] = json.load(f)
            except (json.JSONDecodeError, OSError):
                continue  # mid-replace read: treat as absent this poll
        return out

    def ages(self) -> dict[int, float]:
        """Seconds since each known/expected host's last beat."""
        now = self.clock()
        beats = self._beats()
        hosts = set(beats)
        if self.expected is not None:
            hosts |= set(range(self.expected))
        return {
            i: (now - beats[i]["time"]) if i in beats else (now - self._created)
            for i in sorted(hosts)
        }

    def stale_hosts(self) -> list[int]:
        return [i for i, age in self.ages().items() if age > self.timeout]

    def check(self) -> None:
        """Raise ``HostLossError`` naming every stale host."""
        stale = self.stale_hosts()
        if stale:
            ages = self.ages()
            detail = ", ".join(f"host {i}: {ages[i]:.1f}s" for i in stale)
            raise HostLossError(
                f"host(s) {stale} stale past the {self.timeout}s heartbeat "
                f"timeout ({detail}) — re-mesh via elastic_plan and resume "
                "from the last globally-valid checkpoint",
                hosts=stale,
            )

    def snapshot(self) -> dict[str, Any]:
        """JSON-safe liveness summary for ``MiloServer.health()``."""
        ages = self.ages()
        stale = [i for i, age in ages.items() if age > self.timeout]
        return {
            "expected": self.expected,
            "timeout": self.timeout,
            "ages": {str(i): round(age, 3) for i, age in ages.items()},
            "stale": stale,
        }
