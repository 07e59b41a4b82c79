"""Input firewall: screen the selection ground set before any math runs
(a copy of ``repro.health.firewall``: host numpy, so both packages screen
and report alike).

MILO's economics make a bad artifact *amortized damage*: the metadata is
computed once and reused by every downstream training and tuning trial, so
a NaN row or a zero-norm embedding that slips into preprocessing poisons
every consumer.  The similarity kernels are silently tolerant — a zero-norm
row survives ``normalize_rows`` as an exact zero vector and then scores a
constant 0.5 against everything under the rescaled cosine, a phantom
mid-similarity that distorts facility-location gains without ever raising.

``validate_features`` runs host-side on the raw ground set and detects:

* **non-finite rows** — any NaN/inf entry;
* **zero-norm rows** — L2 norm <= eps (the rows ``normalize_rows`` would
  flatten; see :func:`repro_torch.core.similarity.zero_norm_rows`), excluding
  rows already flagged non-finite;
* **duplicate rows** — byte-identical repeats of an earlier row
  (facility location gains collapse to zero between duplicates);
* **constant features** — columns with a single value (dead dimensions);
* **class geometry** — empty classes (label gaps), singleton classes, and
  over-budget classes whose proportional budget equals the class size
  (a ``k >= n_c`` request: selection degenerates to "take everything").

Row anomalies (non-finite + zero-norm) are *actionable* via the policy
knob; structural anomalies (duplicates, constants, class geometry) are
recorded in the report but never mutate data — the selection engines
handle them deterministically and the report is the paper trail.

Policies
--------
``raise``
    Refuse the ground set: raise :class:`DataHealthError` listing every
    anomaly class with counts and example indices.
``repair``
    Deterministic in-place treatment: non-finite entries become 0.0; rows
    that are still zero-norm afterwards become the unit basis vector
    ``e_{i mod d}`` (a pure function of the row index — two repair passes
    over the same data are bit-identical).
``quarantine``
    Leave the data untouched but mark the bad rows for exclusion from the
    ground set; callers (``MiloPreprocessor.preprocess``) drop them from
    selection and record the indices in artifact provenance.

The report's :meth:`DataHealthReport.to_dict` form is JSON-safe and sized
for artifact headers: anomaly index lists are truncated to
``MAX_RECORDED_INDICES`` examples (full counts always kept), except the
``repaired_rows`` / ``quarantined_rows`` lists, which are stored in full
because they change what the artifact *is*.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from repro_torch.core.partition import (
    PartitionStrategy,
    partition_by_class,
    proportional_budgets,
)

#: Accepted values for the ``policy`` knob (``None`` = report-only).
FIREWALL_POLICIES = ("raise", "repair", "quarantine")

#: Cap on per-anomaly example indices recorded in ``to_dict`` provenance.
MAX_RECORDED_INDICES = 32


class DataHealthError(ValueError):
    """The ground set failed validation under ``policy='raise'``."""


def _as_int_list(idx: Sequence[int] | np.ndarray) -> list[int]:
    return [int(i) for i in idx]


@dataclasses.dataclass
class DataHealthReport:
    """Structured outcome of one ``validate_features`` pass."""

    n_rows: int
    n_features: int
    policy: str | None
    eps: float
    nonfinite_rows: list[int] = dataclasses.field(default_factory=list)
    zero_norm_rows: list[int] = dataclasses.field(default_factory=list)
    duplicate_rows: list[int] = dataclasses.field(default_factory=list)
    constant_features: list[int] = dataclasses.field(default_factory=list)
    empty_classes: list[int] = dataclasses.field(default_factory=list)
    singleton_classes: list[int] = dataclasses.field(default_factory=list)
    overbudget_classes: list[int] = dataclasses.field(default_factory=list)
    repaired_rows: list[int] = dataclasses.field(default_factory=list)
    quarantined_rows: list[int] = dataclasses.field(default_factory=list)

    @property
    def bad_rows(self) -> list[int]:
        """Rows the policy acts on: non-finite union zero-norm, sorted."""
        return sorted(set(self.nonfinite_rows) | set(self.zero_norm_rows))

    @property
    def clean(self) -> bool:
        """True when no anomaly of any class was detected."""
        return not (
            self.nonfinite_rows or self.zero_norm_rows or self.duplicate_rows
            or self.constant_features or self.empty_classes
            or self.singleton_classes or self.overbudget_classes
        )

    def summary(self) -> str:
        parts = []
        for name in ("nonfinite_rows", "zero_norm_rows", "duplicate_rows",
                     "constant_features", "empty_classes", "singleton_classes",
                     "overbudget_classes"):
            vals = getattr(self, name)
            if vals:
                shown = vals[:MAX_RECORDED_INDICES]
                parts.append(f"{name}={len(vals)} (e.g. {shown})")
        if not parts:
            return f"clean ground set ({self.n_rows}x{self.n_features})"
        return (f"ground set {self.n_rows}x{self.n_features} failed health "
                f"checks: " + "; ".join(parts))

    def to_dict(self) -> dict[str, Any]:
        """JSON-safe provenance form (truncated examples + full counts)."""
        out: dict[str, Any] = {
            "n_rows": int(self.n_rows),
            "n_features": int(self.n_features),
            "policy": self.policy,
            "eps": float(self.eps),
            "clean": self.clean,
        }
        for name in ("nonfinite_rows", "zero_norm_rows", "duplicate_rows",
                     "constant_features", "empty_classes", "singleton_classes",
                     "overbudget_classes"):
            vals = getattr(self, name)
            out[name] = {
                "count": len(vals),
                "indices": _as_int_list(vals[:MAX_RECORDED_INDICES]),
            }
        # full lists: these define which rows the artifact was built from
        out["repaired_rows"] = _as_int_list(self.repaired_rows)
        out["quarantined_rows"] = _as_int_list(self.quarantined_rows)
        return out


def _duplicate_rows(feats: np.ndarray) -> list[int]:
    """Indices of rows byte-identical to an earlier row (later copy wins)."""
    seen: dict[bytes, int] = {}
    dups: list[int] = []
    for i in range(feats.shape[0]):
        key = feats[i].tobytes()
        if key in seen:
            dups.append(i)
        else:
            seen[key] = i
    return dups


def _class_geometry(
    labs: np.ndarray,
    m: int,
    subset_fraction: float | None,
    strategy: PartitionStrategy | None = None,
) -> tuple[list[int], list[int], list[int]]:
    """(empty, singleton, overbudget) class labels for the ground set.

    ``strategy`` makes the overbudget check mirror the decomposition the
    preprocessor will actually apply (block strategies can split a class
    into several partitions, changing which budgets saturate); the empty /
    singleton checks stay label-based — they describe the data, not the
    decomposition.  Partition labels deduplicate through the set: a class
    split into multiple saturated blocks is reported once.
    """
    if labs.size == 0:
        return [], [], []
    counts = np.bincount(labs, minlength=int(labs.max()) + 1)
    empty = _as_int_list(np.where(counts == 0)[0])
    singleton = _as_int_list(np.where(counts == 1)[0])
    overbudget: list[int] = []
    if subset_fraction is not None and m > 0:
        k = max(1, round(subset_fraction * m))
        parts = (partition_by_class(labs) if strategy is None
                 else strategy.partition(labs, m))
        budgets = proportional_budgets(parts, k)
        overbudget = sorted({int(p.label) for p, b in zip(parts, budgets)
                             if b >= len(p.indices)})
    return empty, singleton, overbudget


def validate_features(
    features: np.ndarray,
    labels: np.ndarray | None = None,
    *,
    policy: str | None = "raise",
    subset_fraction: float | None = None,
    eps: float = 1e-8,
    strategy: PartitionStrategy | None = None,
) -> tuple[np.ndarray, DataHealthReport]:
    """Screen a ground set; return ``(features_out, report)``.

    ``features_out`` is the input array untouched except under
    ``policy='repair'``, where a copy with deterministic row repairs is
    returned.  Under ``policy='quarantine'`` the report's
    ``quarantined_rows`` names the rows the caller must exclude; under
    ``policy='raise'`` any bad row raises :class:`DataHealthError`.
    ``policy=None`` only reports.
    """
    if policy is not None and policy not in FIREWALL_POLICIES:
        raise ValueError(
            f"firewall policy must be one of {FIREWALL_POLICIES} or None, "
            f"got {policy!r}")
    feats = np.asarray(features)
    if feats.ndim != 2:
        raise ValueError(f"features must be 2-D (rows x dims), got shape "
                         f"{feats.shape}")
    m, d = feats.shape

    finite = np.isfinite(feats)
    nonfinite = np.where(~finite.all(axis=1))[0]
    masked = np.where(finite, feats, 0.0)
    norms = np.linalg.norm(masked.astype(np.float64), axis=1)
    zero_norm = np.setdiff1d(np.where(norms <= eps)[0], nonfinite)

    report = DataHealthReport(
        n_rows=m, n_features=d, policy=policy, eps=eps,
        nonfinite_rows=_as_int_list(nonfinite),
        zero_norm_rows=_as_int_list(zero_norm),
        duplicate_rows=_duplicate_rows(feats),
        constant_features=(
            _as_int_list(np.where((feats == feats[0:1]).all(axis=0))[0])
            if m > 1 else []),
    )
    if labels is not None:
        labs = np.asarray(labels, np.int64).ravel()
        if labs.shape[0] != m:
            raise ValueError(f"labels length {labs.shape[0]} != rows {m}")
        empty, singleton, overbudget = _class_geometry(
            labs, m, subset_fraction, strategy)
        report.empty_classes = empty
        report.singleton_classes = singleton
        report.overbudget_classes = overbudget

    bad = report.bad_rows
    if policy == "raise" and bad:
        raise DataHealthError(report.summary())
    if policy == "repair" and bad:
        out = np.array(masked, dtype=feats.dtype, copy=True)
        still_zero = np.linalg.norm(
            out.astype(np.float64), axis=1) <= eps
        for i in bad:
            if still_zero[i]:
                out[i] = 0.0
                out[i, i % d] = 1.0   # e_{i mod d}: pure function of the row
        report.repaired_rows = list(bad)
        return out, report
    if policy == "quarantine" and bad:
        report.quarantined_rows = list(bad)
    return feats, report
