"""Device meshes (port of ``repro.launch.mesh``).

Functions, never module-level meshes: building one needs an initialised
process group (``torch.distributed``), and importing this module must not
start one.

The production meshes keep the reference's chip counts, 256 and 512, but
lay them out for H100 nodes of 8 cards joined by NVLink: the ``model`` axis
(tensor and expert parallelism, whose collectives run every layer) spans
one node's 8 cards, and ``data`` and ``pod`` span the nodes over
InfiniBand.  The reference's (16, 16) is a TPU v5e torus, where every axis
is ICI; on H100 a model axis of 16 would put every tensor-parallel
collective on InfiniBand.
"""
from __future__ import annotations

from typing import Sequence

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: cards an H100 node joins by NVLink: the production ``model`` axis
NODE_CARDS = 8


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device_type: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    default process group's ranks (row-major: the last axis is the
    innermost, neighbouring ranks)."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in length")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def production_layout(*, multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...], str]:
    """(shape, axes, label) of a production mesh: 32 nodes × 8 cards (256)
    as ("data", "model"), or two pods of them (512) as ("pod", "data",
    "model")."""
    if multi_pod:
        return (2, 32, NODE_CARDS), ("pod", "data", "model"), "2x32x8"
    return (32, NODE_CARDS), ("data", "model"), "32x8"


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The 32x8 (256 cards) or 2x32x8 (512 cards) mesh."""
    shape, axes, _ = production_layout(multi_pod=multi_pod)
    return make_mesh(shape, axes, device_type=device_type)


def make_debug_mesh(n_data: int = 1, n_model: int = 1, *,
                    device_type: str = "cuda") -> DeviceMesh:
    """A small ("data", "model") mesh of any shape (the tests use (4, 2))."""
    return make_mesh((n_data, n_model), ("data", "model"), device_type=device_type)
