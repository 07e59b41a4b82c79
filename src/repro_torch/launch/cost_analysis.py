"""Per-device cost of one step: the counterpart of ``repro.launch.hlo_analysis``.

The reference compiles the step and reads XLA's optimized HLO: the SPMD
module is one device's program, so its dots, its traffic and its
collectives are per device.  The port has no HLO.  It runs one rank's step
eagerly, under ``FakeTensorMode`` and a fake process group (the dry run),
and ``CostMode``, a ``TorchDispatchMode``, counts every op that reaches the
rank's local tensors:

  * **FLOPs** of matrix products, from ``torch.utils.flop_counter``'s
    formulas (``mm``, ``bmm``, ``addmm``, convolutions, SDPA ...) and the
    kernels' own (B5's and B6's meta forms register theirs); elementwise
    FLOPs are bandwidth-bound and go to the bytes, as in the reference;
  * **bytes**: each op's tensor operands and its result, once each.  This
    is an eager traffic model with no fusion (every op reads its inputs
    from and writes its output to device memory), so it is an upper bound
    of what a fused program moves; views and allocations move nothing;
  * **collectives**: the bytes of each collective's operand (the
    reference's measure), and their count, by kind (``all_gather``,
    ``all_reduce``, ``reduce_scatter``, ``all_to_all``) and by mesh axis,
    read off the process group each one names;
  * **memory**: the step's arguments (exact: the bytes of the local shards
    it is given) and a peak, from a live-storage count: every storage an op
    creates counts from its creation until the last tensor on it dies.
    Storages the step's autograd graph keeps alive count as live, so the
    peak includes the saved activations.

**Per device, not global.**  A DTensor op reaches this mode twice in
spirit: as the DTensor op at global shapes, and as the op DTensor runs on
the local shards.  The mode declines every op that has a DTensor among its
types (``NotImplemented``: DTensor handles it and then runs the local op,
which comes back here), and skips ops on meta tensors (where sharding
propagation computes global output shapes), so each product is counted
once, at its local shapes.  A loop of n layers runs n times, so it counts n
times (the reference needed trip counts for that).
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from collections import defaultdict
from typing import Any

import torch
from torch._subclasses.fake_tensor import is_fake, unset_fake_temporarily
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

_COLLECTIVES = {
    "all_gather_into_tensor": "all_gather",
    "all_gather_into_tensor_coalesced": "all_gather",
    "all_reduce": "all_reduce",
    "all_reduce_coalesced": "all_reduce",
    "reduce_scatter_tensor": "reduce_scatter",
    "reduce_scatter_tensor_coalesced": "reduce_scatter",
    "all_to_all_single": "all_to_all",
    "broadcast": "broadcast",
}
# ops that move no data: views, allocations without a write, metadata
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach",
         "alias", "lift_fresh", "lift_fresh_copy", "wait_tensor", "_local_scalar_dense",
         "device", "layout", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "is_contiguous", "is_same_size", "_to_copy_meta"}


# frames of the dispatch machinery between an op's caller and this mode
_MACHINERY = ("torch/_ops.py", "torch/utils/_python_dispatch", "torch/_subclasses/",
              "torch/_compile.py", "torch/_dynamo/", "torch/utils/_stats.py", "torch/_tensor.py",
              "torch/overrides.py", __file__)


# where sharding propagation makes its stand-ins and runs the op on them
_STAND_INS = ("_op_schema.py", "_sharding_prop.py")


def _caller() -> tuple[str, bool]:
    """(the file of the op's caller, whether DTensor's sharding propagation
    is on the stack).  Propagation runs ops on fake or meta stand-ins at
    global shapes, only to learn an output's shape
    (``torch/distributed/tensor/_sharding_prop.py``)."""
    f = sys._getframe(2)
    caller = None
    while f is not None:
        name = f.f_code.co_filename
        if caller is None and not any(m in name for m in _MACHINERY):
            caller = name
        if "sharding_prop" in name:
            return caller or name, True
        f = f.f_back
    return caller or "", False


def _fake_mode_below() -> bool:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    return any(isinstance(m, FakeTensorMode) for m in _get_current_dispatch_mode_stack())


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_bytes(tree: Any) -> int:
    """Bytes of the local shards of every tensor of ``tree`` (dicts, lists,
    tuples, NamedTuples and dataclasses such as ``KVCache``): what one
    device holds of it."""
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return sum(local_bytes(getattr(tree, f.name)) for f in dataclasses.fields(tree))
    return 0


class CostMode(TorchDispatchMode):
    """Counts one rank's FLOPs, bytes, collectives and live storage (module
    docstring).  ``axis_of`` maps a process group's name to its mesh axis
    (``axes_by_group``); ``base_bytes`` counts as live from the start (the
    step's arguments)."""

    def __init__(self, axis_of: dict[str, str] | None = None, base_bytes: int = 0):
        super().__init__()
        self.axis_of = dict(axis_of or {})
        self.flops = 0
        self.flops_by_op: dict[str, int] = defaultdict(int)
        self.bytes = 0
        self.collective_bytes: dict[str, int] = defaultdict(int)
        self.collective_counts: dict[str, int] = defaultdict(int)
        self.collective_bytes_by_axis: dict[str, int] = defaultdict(int)
        self.ops = 0
        self.live = base_bytes
        self.peak = base_bytes
        self._refs: dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        ins = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        caller, propagating = _caller()
        if ("torch/distributed" in caller and not caller.endswith(_STAND_INS)
                and not any(is_fake(a) for a in ins) and _fake_mode_below()):
            # DTensor's own bookkeeping on small index tensors (shard sizes
            # and offsets: ``arange``, ``tolist``): real values, which a fake
            # tensor cannot give, and no part of the step
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if propagating or any(a.is_meta for a in ins):
            return out
        name = func._schema.name.split("::")[-1]
        if name in _FREE or func.is_view:
            return out
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        self.ops += 1
        self.bytes += sum(_nbytes(a) for a in ins) + sum(_nbytes(o) for o in outs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            n = int(formula(*args, out_val=out, **kwargs))
            self.flops += n
            self.flops_by_op[str(func._overloadpacket)] += n
        kind = _COLLECTIVES.get(name) if func.namespace == "_c10d_functional" else None
        if kind is not None:
            group = next((a for a in args if isinstance(a, str) and a in self.axis_of), None)
            moved = sum(_nbytes(a) for a in ins)
            self.collective_bytes[kind] += moved
            self.collective_counts[kind] += 1
            self.collective_bytes_by_axis[self.axis_of.get(group, "?")] += moved
        for o in outs:
            self._track(o)
        return out

    def _track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until the last tensor on it that
        this mode saw dies."""
        st = t.untyped_storage()
        key = st._cdata
        if key not in self._refs:
            self._refs[key] = 0
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key, st.nbytes())

    def _release(self, key: int, nbytes: int) -> None:
        self._refs[key] -= 1
        if self._refs[key] == 0:
            del self._refs[key]
            self.live -= nbytes

    def totals(self) -> dict[str, Any]:
        """The counts in the dry run record's ``cost`` form."""
        return {
            "flops": float(self.flops),
            "bytes": float(self.bytes),
            "ops": self.ops,
            "flops_by_op": dict(self.flops_by_op),
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "collective_bytes_by_axis": dict(self.collective_bytes_by_axis),
            "collective_total_bytes": float(sum(self.collective_bytes.values())),
            "peak_bytes": self.peak,
        }


def axes_by_group(mesh) -> dict[str, str]:
    """Process-group name -> mesh axis name, for every axis of ``mesh``."""
    return {mesh.get_group(i).group_name: name for i, name in enumerate(mesh.mesh_dim_names)}
