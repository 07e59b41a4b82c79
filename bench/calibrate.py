"""Readings the limits of ``correct`` are set from, at a cell's own size.

    python3 bench/calibrate.py --workload <cell> --seeds 11,12,... \
        [--control-seeds 21,22,23] [--fault half_batch --fault-seeds 31,32,33]

For each seed of ``--seeds`` the program's timed entry runs once at the
cell's size and is judged (the lower readings); for each of
``--control-seeds`` the control runs in the program's place (the upper
readings); for ``--fault`` the program runs with that fault planted
(training cells: ``half_batch``, ``state_unchanged``).  One JSON line per
reading on standard output.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _seeds(s: str) -> list[int]:
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    from bench import harness as H

    import torch

    manifest = H.load_manifest(ROOT)
    cell = H.cell(manifest, args.workload)
    config = H.load_config(manifest, cell, ROOT)
    traffic = H.load_traffic(cell, ROOT)
    driver = H.load_driver(traffic, ROOT)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    runs = [("program", s, None) for s in _seeds(args.seeds)]
    runs += [("control", s, None) for s in _seeds(args.control_seeds)]
    runs += [("fault", s, args.fault) for s in _seeds(args.fault_seeds)]
    for kind, seed, fault in runs:
        t0 = time.perf_counter()
        if kind == "control":
            numbers = driver.control(config, traffic, seed=seed, device=dev)
        elif traffic["driver"] == "lm_train":
            numbers = driver.program_steps(config, traffic, seed=seed, device=dev, fault=fault)
        else:
            numbers = driver.program_unit(config, traffic, seed=seed, device=dev)
        print(json.dumps({"cell": cell["name"], "kind": kind, "fault": fault, "seed": seed,
                          "seconds": time.perf_counter() - t0, "numbers": numbers}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
