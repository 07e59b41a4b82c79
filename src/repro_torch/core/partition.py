"""Level-0 ground-set decomposition for two-level (partition-then-refine)
selection (port of ``repro.core.partition``; numpy only, copied rather than
imported).

The paper partitions the dataset by class label (§3.2), selects within each
class and merges; budgets are apportioned proportionally to partition sizes
(largest-remainder rounding so the total is exactly k).  A
:class:`PartitionStrategy` maps the ground set to disjoint partitions:

``by_class``
    The paper's split (default); one catch-all partition without labels.
``random_blocks``
    A seeded random permutation (numpy's ``default_rng(seed)``) chopped
    into near-equal blocks of at most ``block_size`` rows, each sorted.
    Label-free; pair it with ``refine_factor > 1`` so the level-1 refine
    can trade winners across block boundaries.
``balanced_blocks``
    Class-wise first, then every class above ``block_size`` rows is split
    into near-equal sub-blocks that keep the class label.

Partitions equal the reference's index for index.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Sequence

import numpy as np


class Partition(NamedTuple):
    """One ground-set shard: global indices of its members."""

    label: int
    indices: np.ndarray  # (n_c,) int64 global indices


def partition_by_class(labels: np.ndarray) -> list[Partition]:
    labels = np.asarray(labels)
    return [Partition(int(lab), np.nonzero(labels == lab)[0]) for lab in np.unique(labels)]


class PartitionStrategy:
    """How to decompose a ground set into disjoint level-0 partitions.

    ``config()`` is the provenance stamped into hierarchical artifacts: only
    the keys the strategy depends on.
    """

    name: str = ""

    def partition(self, labels: np.ndarray | None, m: int) -> list[Partition]:
        raise NotImplementedError

    def config(self) -> dict[str, Any]:
        return {"partition": self.name}


@dataclasses.dataclass(frozen=True)
class ByClass(PartitionStrategy):
    """The paper's class-wise split; one catch-all partition without labels."""

    name = "by_class"

    def partition(self, labels: np.ndarray | None, m: int) -> list[Partition]:
        if labels is None:
            return [Partition(0, np.arange(m, dtype=np.int64))]
        return partition_by_class(np.asarray(labels, np.int64))


@dataclasses.dataclass(frozen=True)
class RandomBlocks(PartitionStrategy):
    """Seeded random near-equal blocks of at most ``block_size`` rows."""

    block_size: int = 4096
    seed: int = 0

    name = "random_blocks"

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")

    def partition(self, labels: np.ndarray | None, m: int) -> list[Partition]:
        if m <= 0:
            return []
        perm = np.random.default_rng(self.seed).permutation(m).astype(np.int64)
        n_blocks = max(1, math.ceil(m / self.block_size))
        # sorted within each block: ascending gathers read the rows in order
        return [Partition(b, np.sort(chunk))
                for b, chunk in enumerate(np.array_split(perm, n_blocks))]

    def config(self) -> dict[str, Any]:
        return {"partition": self.name, "partition_block": self.block_size,
                "partition_seed": self.seed}


@dataclasses.dataclass(frozen=True)
class BalancedBlocks(PartitionStrategy):
    """Class-wise split, then classes above ``block_size`` rows are chopped
    into near-equal sub-blocks that keep the class label."""

    block_size: int = 4096

    name = "balanced_blocks"

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")

    def partition(self, labels: np.ndarray | None, m: int) -> list[Partition]:
        out: list[Partition] = []
        for p in ByClass().partition(labels, m):
            n_p = len(p.indices)
            if n_p <= self.block_size:
                out.append(p)
                continue
            n_blocks = math.ceil(n_p / self.block_size)
            out.extend(Partition(p.label, chunk)
                       for chunk in np.array_split(p.indices, n_blocks))
        return out

    def config(self) -> dict[str, Any]:
        return {"partition": self.name, "partition_block": self.block_size}


#: strategy names ``make_partition_strategy`` accepts
PARTITION_STRATEGIES = ("by_class", "random_blocks", "balanced_blocks")


def make_partition_strategy(
    name: str, *, block_size: int = 4096, seed: int = 0
) -> PartitionStrategy:
    """Build a strategy from its config-string form; ``block_size`` and
    ``seed`` are ignored by the strategies that do not use them."""
    if name == "by_class":
        return ByClass()
    if name == "random_blocks":
        return RandomBlocks(block_size=block_size, seed=seed)
    if name == "balanced_blocks":
        return BalancedBlocks(block_size=block_size)
    raise ValueError(
        f"unknown partition strategy {name!r}; available: {PARTITION_STRATEGIES}"
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
