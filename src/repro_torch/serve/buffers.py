"""Shared device-resident feature buffers (``BufferRegistry``; port of
``repro.serve.buffers``).

The fused training path needs its pipeline's column store (``{"x": feats,
"y": labs}``) on the device.  Without sharing, N concurrent train/tune
requests against one dataset pay N host-to-device copies and hold N copies
of an O(n·d) feature matrix.  The registry places a column once and hands
every consumer the SAME tensor (the fused engine only reads the columns, so
sharing is safe).  Handing out the same tensor is also what keeps the fused
engine's CUDA graphs alive from one tenant to the next: an engine drops the
graphs captured over other buffers (``train.engine``).

Keying is two-tier, per column:

  * **identity fast path** — ``id(array)`` (guarded by a weakref so a
    recycled id can never alias a dead array) maps straight to the placed
    buffer; repeat requests with the same host array never rehash it.
  * **content fingerprint** — otherwise the column is hashed (sha256 of
    bytes + shape + dtype, the reference's scheme), so two *equal* arrays
    owned by different clients still share one device buffer.

``put_count`` counts actual device placements and ``hits`` counts reuses.
"""
from __future__ import annotations

import hashlib
import threading
import weakref

import numpy as np
import torch

from repro_torch.device import resolve_device


def array_fingerprint(arr: np.ndarray) -> str:
    """Content identity of one host column (dtype/shape-qualified)."""
    a = np.ascontiguousarray(arr)
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]


class BufferRegistry:
    """Device-resident column cache keyed on array identity/fingerprint,
    placing on ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self._buffers: dict[str, torch.Tensor] = {}              # fingerprint -> tensor
        self._id_cache: dict[int, tuple[weakref.ref, str]] = {}  # id -> (ref, fp)
        self.put_count = 0
        self.hits = 0

    # -- fingerprinting -----------------------------------------------------

    def fingerprint(self, arr: np.ndarray) -> str:
        """``array_fingerprint`` with an identity memo: the same host array
        object is hashed once, however many requests carry it."""
        arr = np.asarray(arr)
        with self._lock:
            cached = self._id_cache.get(id(arr))
            if cached is not None:
                ref, fp = cached
                if ref() is arr:
                    return fp
                del self._id_cache[id(arr)]  # id was recycled
        fp = array_fingerprint(arr)
        with self._lock:
            try:
                self._id_cache[id(arr)] = (weakref.ref(arr), fp)
            except TypeError:  # pragma: no cover — non-weakref-able view
                pass
        return fp

    # -- placement ----------------------------------------------------------

    def column(self, arr: np.ndarray) -> torch.Tensor:
        """The shared device tensor for one host column (placed on first
        request, reused afterwards)."""
        arr = np.asarray(arr)
        fp = self.fingerprint(arr)
        with self._lock:
            buf = self._buffers.get(fp)
            if buf is not None:
                self.hits += 1
                return buf
        placed = torch.as_tensor(arr, device=self.device)
        with self._lock:
            # lost a race: keep the first placement so identity stays stable
            buf = self._buffers.get(fp)
            if buf is not None:
                self.hits += 1
                return buf
            self._buffers[fp] = placed
            self.put_count += 1
            return placed

    def get(self, arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """Shared device tensors for a pipeline column store."""
        return {k: self.column(v) for k, v in arrays.items()}

    # -- lifecycle ----------------------------------------------------------

    def release(self, arr_or_fp) -> bool:
        """Drop one column (by host array or fingerprint) from the registry.
        Existing consumers keep their references; only future sharing stops."""
        fp = arr_or_fp if isinstance(arr_or_fp, str) else self.fingerprint(arr_or_fp)
        with self._lock:
            return self._buffers.pop(fp, None) is not None

    def clear(self) -> None:
        with self._lock:
            self._buffers.clear()
            self._id_cache.clear()

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "resident_columns": len(self._buffers),
                "put_count": self.put_count,
                "hits": self.hits,
            }
