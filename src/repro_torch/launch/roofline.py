"""Roofline terms of a dry run cell on H100 nodes (port of
``repro.launch.roofline``).

The peaks are NVIDIA's spec-sheet figures for one H100 SXM (80 GB HBM3) at
its full 700 W power limit, dense rates without sparsity — analytic bounds,
not measurements:

    compute    = FLOPs / 989e12 FLOP/s (bf16 tensor cores)
    memory     = bytes / 3.35e12 B/s (HBM3)
    collective = Σ over mesh axes of the axis's bytes / its link's rate:
                 ``model`` (the 8 cards of a node) on NVLink, 450 GB/s a
                 direction a card; ``data`` and ``pod`` across nodes on
                 InfiniBand NDR, 50 GB/s (400 Gb/s) a card.

All three are per device: ``cost_analysis`` counts one rank's step, and
every rank runs the same one.  ``model_flops`` is the reference's analytic
6·N·tokens (training) or 2·N·tokens (inference) over the active parameters.
"""
from __future__ import annotations

from typing import Any

PEAK_FLOPS = 989e12       # bf16 dense, per card
HBM_BW = 3.35e12          # bytes/s per card
NVLINK_BW = 450e9         # bytes/s a direction per card, within a node
IB_BW = 50e9              # bytes/s per card (one 400 Gb/s NDR port), across nodes

#: the link each mesh axis runs its collectives on
AXIS_BW = {"model": NVLINK_BW, "data": IB_BW, "pod": IB_BW}


def memory_summary(mem: dict | None) -> dict[str, Any]:
    """The dry run's memory numbers (``argument_size_in_bytes``: the local
    shards the step is given; ``output_size_in_bytes``: those it returns;
    ``peak_memory_in_bytes``: the live-storage peak) in the reference's
    ``memory`` form."""
    if mem is None:
        return {"available": False}
    out: dict[str, Any] = {"available": True}
    for key in ("argument_size_in_bytes", "output_size_in_bytes", "peak_memory_in_bytes"):
        if mem.get(key) is not None:
            out[key] = int(mem[key])
    return out


def model_flops(cfg, shape) -> float:
    """6 · N_active · tokens (the standard training-FLOPs model); 2 · N per
    token for inference steps."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one new token per request


def roofline_terms(cfg, shape, cost: dict, *, chips: int) -> dict[str, Any]:
    """The three terms, the bound and the reference's derived ratios from a
    cell's per-device ``cost`` (``cost_analysis.CostMode.totals``)."""
    flops_dev = float(cost.get("flops") or 0.0)
    bytes_dev = float(cost.get("bytes") or 0.0)
    by_axis = cost.get("collective_bytes_by_axis") or {}
    coll_dev = float(sum(by_axis.values()))
    unknown = set(by_axis) - set(AXIS_BW)
    if unknown:
        raise ValueError(f"collectives on axes {sorted(unknown)} with no link rate")
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = sum(b / AXIS_BW[ax] for ax, b in by_axis.items())
    mf = model_flops(cfg, shape)
    flops_global = flops_dev * chips
    terms = {
        "chips": chips,
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        "collective_bytes_per_device": coll_dev,
        "collective_s_by_axis": {ax: b / AXIS_BW[ax] for ax, b in by_axis.items()},
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "model_flops": mf,
        "useful_flops_ratio": mf / flops_global if flops_global else 0.0,
        "bound": max(("compute", compute_s), ("memory", memory_s),
                     ("collective", collective_s), key=lambda kv: kv[1])[0],
    }
    dom = max(compute_s, memory_s, collective_s)
    terms["step_time_lower_bound_s"] = dom
    terms["roofline_fraction"] = (mf / (chips * PEAK_FLOPS)) / dom if dom > 0 else 0.0
    return terms
