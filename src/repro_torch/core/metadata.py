"""Persisted MILO metadata (paper Alg. 1 ``storemetadata``/``loadmetadata``).

A copy of ``repro.core.metadata`` (numpy only): the same npz layout, JSON
header and canonical-JSON ``config_hash``, so an artifact written by either
package loads in the other.

The whole point of model-agnostic selection is that this artifact is computed
once per (dataset, subset-size) and shared across every downstream model and
tuning trial.  Stored as a single ``.npz`` whose ``header`` field is a JSON
document carrying a format version and a content hash of the preprocessing
config, so a consumer can verify it is loading the artifact it expects
(``load(..., expected_config=...)`` / ``expected_hash=...``) before training
a second model from it at zero selection cost.  Writes are atomic (temp file
+ rename) so a crashed preprocessing job can never leave a half-written
artifact behind.  Version-1 artifacts (bare ``config`` field, no header) are
still readable.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Any

import numpy as np

ARTIFACT_FORMAT = "milo-metadata"
ARTIFACT_VERSION = 2


class MetadataMismatchError(ValueError):
    """Loaded artifact does not match the expected preprocessing config."""


def config_hash(config: dict[str, Any]) -> str:
    """Stable short hash of a preprocessing config (canonical-JSON sha256)."""
    blob = json.dumps(config, sort_keys=True, separators=(",", ":"), default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _json_to_npz_field(obj: Any) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def _npz_field_to_json(arr: np.ndarray) -> Any:
    return json.loads(bytes(arr.tobytes()).decode())


@dataclasses.dataclass
class MiloMetadata:
    """Pre-processing output for one (dataset, k) pair."""

    sge_subsets: np.ndarray      # (n_subsets, k) int64 global indices
    wre_probs: np.ndarray        # (m,) float32, sums to 1
    wre_importance: np.ndarray   # (m,) float32 raw greedy gains
    class_labels: np.ndarray     # (m,) int64 (zeros if unlabeled)
    class_budgets: np.ndarray    # (c,) int64 per-class budget (== [k] if global)
    config: dict[str, Any]       # provenance: set fns, eps, fraction, encoder id

    @property
    def k(self) -> int:
        return int(self.sge_subsets.shape[1])

    @property
    def m(self) -> int:
        return int(self.wre_probs.shape[0])

    def config_hash(self) -> str:
        return config_hash(self.config)

    def header(self) -> dict[str, Any]:
        """The JSON header persisted alongside the arrays."""
        return {
            "format": ARTIFACT_FORMAT,
            "version": ARTIFACT_VERSION,
            "config": self.config,
            "config_hash": self.config_hash(),
            "k": self.k,
            "m": self.m,
            "n_sge_subsets": int(self.sge_subsets.shape[0]),
        }

    def save(self, path: str) -> None:
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(
                    f,
                    sge_subsets=self.sge_subsets,
                    wre_probs=self.wre_probs,
                    wre_importance=self.wre_importance,
                    class_labels=self.class_labels,
                    class_budgets=self.class_budgets,
                    header=_json_to_npz_field(self.header()),
                )
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @classmethod
    def load(
        cls,
        path: str,
        *,
        expected_config: dict[str, Any] | None = None,
        expected_hash: str | None = None,
    ) -> "MiloMetadata":
        """Load an artifact, optionally verifying its preprocessing config.

        ``expected_config`` uses partial-dict semantics: every (key, value)
        pair given must match the stored config.  ``expected_hash`` must equal
        the stored config's hash exactly.  A mismatch raises
        ``MetadataMismatchError`` — the guard that stops a training run from
        silently consuming subsets produced under different settings.
        """
        with np.load(path) as z:
            if "header" in z:
                hdr = _npz_field_to_json(z["header"])
                if hdr.get("format") != ARTIFACT_FORMAT:
                    raise MetadataMismatchError(
                        f"{path}: not a {ARTIFACT_FORMAT} artifact"
                    )
                if int(hdr.get("version", 0)) > ARTIFACT_VERSION:
                    raise MetadataMismatchError(
                        f"{path}: artifact version {hdr['version']} is newer "
                        f"than supported version {ARTIFACT_VERSION}"
                    )
                cfg = hdr["config"]
                stored_hash = hdr.get("config_hash")
                if stored_hash and stored_hash != config_hash(cfg):
                    raise MetadataMismatchError(
                        f"{path}: header config_hash {stored_hash} does not match "
                        "its config — artifact corrupted or tampered"
                    )
            else:  # version-1 artifact: bare config field, no header
                cfg = _npz_field_to_json(z["config"])
            h = config_hash(cfg)
            if expected_hash is not None and expected_hash != h:
                raise MetadataMismatchError(
                    f"{path}: config hash {h} != expected {expected_hash}"
                )
            if expected_config is not None:
                bad = {
                    key: (cfg.get(key), val)
                    for key, val in expected_config.items()
                    if cfg.get(key) != val
                }
                if bad:
                    raise MetadataMismatchError(
                        f"{path}: config mismatch on {bad} (stored, expected)"
                    )
            return cls(
                sge_subsets=z["sge_subsets"],
                wre_probs=z["wre_probs"],
                wre_importance=z["wre_importance"],
                class_labels=z["class_labels"],
                class_budgets=z["class_budgets"],
                config=cfg,
            )


def is_preprocessed(path: str) -> bool:
    return os.path.exists(path)
