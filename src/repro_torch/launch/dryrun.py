"""Dry run of the production meshes: one rank's step of every (arch x shape
x mesh) cell, on a fake process group, with fake tensors (port of
``repro.launch.dryrun``).

Proves the distribution is coherent without hardware and measures what it
costs a device.  The reference lowers and compiles each cell's step for 512
placeholder devices and reads XLA's memory and cost analyses.  Here
``run_cell`` starts a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``: collectives that move
nothing; an internal torch module, imported only here and only when a cell
runs), builds the production mesh (``launch.mesh``: 32x8 or 2x32x8), and
runs rank 0's step eagerly under ``FakeTensorMode`` on the abstract inputs
of ``launch.specs``, with the ambient mesh entered (the models' ``constrain``
calls lay the activations out) and ``cost_analysis.CostMode`` counting.
Nothing is allocated and CUDA is never initialised: the mesh and the fake
tensors are on the CPU device.

Train cells run the attention the port trains with, ``chunked``: the
hand-written flash kernel (B5) has no backward.  Prefill and decode cells
run B5 and the SSD chunk kernel (B6) through their meta forms (their custom
ops' fake implementations and FLOP formulas).  A cell that fails is
recorded as ``error`` with its traceback, and the CLI exits 1; nothing falls
back to a plain version.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

TRAIN_ATTENTION = "chunked"   # B5 raises under autograd: the port trains on chunked attention
SERVE_KERNELS = "pallas"      # prefill and decode: B5 and B6 (meta forms)


def fake_world(world_size: int) -> None:
    """Make the default process group a fake one of ``world_size`` ranks
    (this process is rank 0): reuse one of that size, replace a fake one of
    another size, and refuse to replace a real one."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is running: the dry run needs its own "
                               "fake one (run it in a process of its own)")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def cell_config(cfg, shape, attention_impl: str | None = None):
    """The cell's config: the port's training attention for train cells,
    the kernels for prefill and decode, or ``attention_impl`` if given."""
    if shape.kind == "train":
        return dataclasses.replace(cfg, attention_impl=attention_impl or TRAIN_ATTENTION)
    return dataclasses.replace(cfg, attention_impl=attention_impl or SERVE_KERNELS,
                               ssm_impl=SERVE_KERNELS)


def analyze(cfg, shape, mesh, *, chips: int | None = None) -> dict:
    """Rank 0's step of ``cfg`` at ``shape`` on ``mesh`` under
    ``FakeTensorMode``: the record's ``memory``, ``cost``, ``roofline`` and
    ``seconds``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import cost_analysis, roofline, specs
    from repro_torch.optim.optimizers import adamw
    from repro_torch.train import train_state as ts

    opt = adamw()
    t0 = time.perf_counter()
    with FakeTensorMode(allow_non_fake_inputs=True), shd.use_mesh(mesh), torch.no_grad():
        args = specs.input_specs(cfg, mesh, shape, opt)
        if shape.kind == "train":
            step = ts.make_train_step(cfg, opt, lambda s: 1e-4)
        elif shape.kind == "prefill":
            step = ts.make_prefill_step(cfg)
        else:
            step = ts.make_serve_step(cfg)
        arg_bytes = cost_analysis.local_bytes(args)
        with cost_analysis.CostMode(cost_analysis.axes_by_group(mesh), base_bytes=arg_bytes) as cm:
            out = step(*args)
        out_bytes = cost_analysis.local_bytes(out)
    seconds = time.perf_counter() - t0
    cost = cm.totals()
    mem = {"argument_size_in_bytes": arg_bytes, "output_size_in_bytes": out_bytes,
           "peak_memory_in_bytes": cost.pop("peak_bytes")}
    n = chips if chips is not None else mesh.size()
    return {"seconds": seconds, "memory": roofline.memory_summary(mem), "cost": cost,
            "roofline": roofline.roofline_terms(cfg, shape, cost, chips=n)}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool, out_dir: str | None = None,
             attention_impl: str | None = None, overrides: dict | None = None) -> dict:
    """One cell on its production mesh; the record (written to ``out_dir``
    as ``<arch>_<shape>_<sp|mp>.json`` when given)."""
    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES, shape_applies
    from repro_torch.launch.mesh import make_production_mesh, production_layout

    cfg = registry.get(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    dims, _, label = production_layout(multi_pod=multi_pod)
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": label,
                 "params": cfg.param_count(), "active_params": cfg.active_param_count()}
    ok, why = shape_applies(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
    else:
        cfg = cell_config(cfg, shape, attention_impl)
        rec.update(attention_impl=cfg.attention_impl, ssm_impl=cfg.ssm_impl)
        if shape.kind == "train" and attention_impl is None:
            rec["note"] = ("train cells run chunked attention: the flash kernel (B5) has no "
                           "backward")
        fake_world(math.prod(dims))
        try:
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            rec.update(status="ok", **analyze(cfg, shape, mesh))
        except Exception as e:  # noqa: BLE001 — a cell's failure is its record
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}_{shape_name}_{'mp' if multi_pod else 'sp'}.json"
        with open(os.path.join(out_dir, tag), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--attention-impl", default=None)
    args = ap.parse_args(argv)

    from repro_torch.configs import registry
    from repro_torch.configs.base import SHAPES

    if args.all:
        cells = [(a, s, mp) for a in registry.ARCHS for s in SHAPES for mp in (False, True)]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape, args.multi_pod)]
    else:
        ap.error("give --arch and --shape, or --all")
    failed = 0
    for arch, shape, mp in cells:
        rec = run_cell(arch, shape, multi_pod=mp, out_dir=args.out,
                       attention_impl=args.attention_impl)
        status = rec["status"]
        extra = ""
        if status == "ok":
            rl = rec["roofline"]
            extra = (f" {rec['seconds']:.1f}s bound={rl['bound']}"
                     f" frac={rl['roofline_fraction']:.3f}"
                     f" useful={rl['useful_flops_ratio']:.2f}")
        elif status == "error":
            extra = " " + rec["error"][:200]
            failed += 1
        print(f"[{status:7s}] {arch} x {shape} ({rec['mesh']}){extra}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
