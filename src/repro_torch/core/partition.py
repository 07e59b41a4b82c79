"""Level-0 ground-set decomposition (port of the by-class part of
``repro.core.partition``; numpy only, copied rather than imported).

The paper partitions the dataset by class label (§3.2), selects within each
class and merges; budgets are apportioned proportionally to partition sizes
(largest-remainder rounding so the total is exactly k).  The block
strategies (``random_blocks``, ``balanced_blocks``) are not ported yet
(ROADMAP A8).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np


class Partition(NamedTuple):
    """One ground-set shard: global indices of its members."""

    label: int
    indices: np.ndarray  # (n_c,) int64 global indices


def partition_by_class(labels: np.ndarray) -> list[Partition]:
    labels = np.asarray(labels)
    return [Partition(int(lab), np.nonzero(labels == lab)[0]) for lab in np.unique(labels)]


class PartitionStrategy:
    """How to decompose a ground set into disjoint level-0 partitions."""

    name: str = ""

    def partition(self, labels: np.ndarray | None, m: int) -> list[Partition]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ByClass(PartitionStrategy):
    """The paper's class-wise split; one catch-all partition without labels."""

    name = "by_class"

    def partition(self, labels: np.ndarray | None, m: int) -> list[Partition]:
        if labels is None:
            return [Partition(0, np.arange(m, dtype=np.int64))]
        return partition_by_class(np.asarray(labels, np.int64))


def make_partition_strategy(name: str) -> PartitionStrategy:
    if name == "by_class":
        return ByClass()
    raise NotImplementedError(
        f"partition strategy {name!r} is not ported yet (ROADMAP A8); "
        "the port runs the flat by_class path"
    )


def proportional_budgets(parts: Sequence[Partition], k: int) -> list[int]:
    """Largest-remainder apportionment of budget k across partitions.

    Guarantees: sum == k, each budget <= partition size, budget >= 1 for any
    non-empty partition when k >= len(parts).
    """
    sizes = np.array([len(p.indices) for p in parts], dtype=np.float64)
    m = sizes.sum()
    if m == 0:
        return [0] * len(parts)
    k = min(k, int(m))
    quotas = sizes * (k / m)
    floors = np.floor(quotas).astype(np.int64)
    floors = np.minimum(floors, sizes.astype(np.int64))
    remainder = k - int(floors.sum())
    # distribute leftovers by largest fractional part, respecting capacity
    frac = quotas - np.floor(quotas)
    order = np.argsort(-frac)
    budgets = floors.copy()
    for idx in order:
        if remainder <= 0:
            break
        if budgets[idx] < sizes[idx]:
            budgets[idx] += 1
            remainder -= 1
    # capacity-limited partitions blocked some leftovers: spill anywhere
    i = 0
    while remainder > 0 and i < len(parts):
        room = int(sizes[i]) - int(budgets[i])
        take = min(room, remainder)
        budgets[i] += take
        remainder -= take
        i += 1
    # floor of 1: largest-remainder alone can starve tiny partitions next to
    # a dominant one; move single units from the largest budgets to them
    nonempty = sizes > 0
    if k >= int(nonempty.sum()):
        for idx in np.nonzero(nonempty & (budgets == 0))[0]:
            donor = int(np.argmax(np.where(budgets >= 2, budgets, -1)))
            budgets[donor] -= 1
            budgets[idx] += 1
    return [int(b) for b in budgets]


def merge_class_selections(
    parts: Sequence[Partition], local_selections: Sequence[np.ndarray]
) -> np.ndarray:
    """Map per-partition local indices back to global dataset indices."""
    out = [np.asarray(p.indices)[np.asarray(sel)] for p, sel in zip(parts, local_selections)]
    return np.concatenate(out) if out else np.zeros((0,), np.int64)
