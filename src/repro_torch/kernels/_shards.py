"""Kernels on DTensor shards: the layout helpers the wrappers of B5
(``flash_attention.ops``) and B6 (``ssd_chunk.ops``) share.

A hand kernel runs on each rank's local shard.  It can take a shard only
along a dim it computes independently (attention's batch and heads, the SSD
scan's batch and heads); every other split, and every pending partial sum,
is redistributed first, so the kernel sees each of those dims whole.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def as_dtensor(t: torch.Tensor, mesh) -> DTensor:
    """``t`` as a DTensor on ``mesh``: a plain tensor is replicated (every
    rank made the same one, as the models' constants are)."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def keep(pls, dims) -> list:
    """``pls`` with every placement other than a shard of one of ``dims``
    replaced by ``Replicate()``."""
    return [p if isinstance(p, Shard) and p.dim in dims else Replicate() for p in pls]


def follow(lead, mapping: dict[int, int]) -> list:
    """Placements that split, on each mesh dim, the dim ``mapping`` gives
    for the dim ``lead`` splits there (and replicate elsewhere)."""
    return [Shard(mapping[p.dim]) if isinstance(p, Shard) and p.dim in mapping else Replicate()
            for p in lead]


def partial_where_split(pls, lead, dim: int) -> list:
    """The gradient layout of an input laid out by ``pls`` that every one of
    ``lead``'s shards along ``dim`` reads whole: a pending sum (``Partial``)
    on each mesh dim that splits ``lead`` along ``dim`` but not the input,
    ``pls`` elsewhere."""
    return [Partial() if p == Replicate() and q == Shard(dim) else p for p, q in zip(pls, lead)]


def offset(mesh, pls, dim: int, size: int) -> int:
    """The global index of this rank's first element along ``dim`` (of
    global length ``size``) under ``pls``: the mesh dims that split it in
    order, major to minor.  Raises for a split that is not even."""
    coord = mesh.get_coordinate()
    off, span = 0, size
    for i, p in enumerate(pls):
        if isinstance(p, Shard) and p.dim == dim:
            n = mesh.size(i)
            if span % n:
                raise ValueError(f"dim {dim} of size {size} does not split evenly over {pls}")
            span //= n
            off += coord[i] * span
    return off


def to_global(local: torch.Tensor, mesh, pls) -> DTensor:
    """A rank's ``local`` shard (of an even split) as its global DTensor."""
    return DTensor.from_local(local, mesh, pls, run_check=False)
