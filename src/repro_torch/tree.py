"""Trees of tensors: the port's stand-in for ``jax.tree``.

A tree is a tensor, a dict, a list or tuple (NamedTuples included) of trees,
or ``None`` (an empty subtree).  Leaves come in the reference's order: dict
keys sorted, sequences in order — so a global gradient norm sums its leaves
in the order ``jax.tree.leaves`` gives the reference.

``Stacked`` marks one leaf of the reference that is stacked over the model's
layer groups (the vmapped ``n_groups`` axis of ``params["groups"]``): the
port holds the groups' tensors side by side, so each layer reads its own
tensor without slicing, and a checkpoint stacks them back into the
reference's one array.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


class Stacked(list):
    """One reference leaf over the model's groups: a list of same-shaped
    tensors, group ``g`` at index ``g``."""


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of ``tree`` in the reference's leaf order."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in leaves(v)]
    raise TypeError(f"a tree holds tensors only, not {type(tree).__name__}")


def map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:  # noqa: A001
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); the result has ``tree``'s."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    raise TypeError(f"a tree holds tensors only, not {type(tree).__name__}")


def unflatten(tree: Any, new_leaves: list) -> Any:
    """``tree``'s structure with ``new_leaves`` (in ``leaves`` order)."""
    flat = list(new_leaves)
    n = len(leaves(tree))
    if len(flat) != n:
        raise ValueError(f"{len(flat)} leaves for a tree of {n}")
    return _rebuild(tree, flat, iter(range(n)))


def _rebuild(tree: Any, flat: list, pos) -> Any:
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return flat[next(pos)]
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], flat, pos) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, flat, pos) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, flat, pos) for v in tree)
    raise TypeError(f"a tree holds tensors only, not {type(tree).__name__}")
