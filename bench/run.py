"""Run one cell of the benchmark and print its result as the last line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many NVIDIA cards as the
cell asks for.  ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics, the profiled window's device time and a
breakdown.  Both judge what the window produced against the plain
reference and print each compared number beside its limit, as the last
lines of standard error and under ``checks`` in the result.  Without the
cards, or with the JAX package or JAX loaded once the window has closed,
the run prints no result and exits with another code than 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program under test and the benchmark's own package, never the JAX one
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
# caches of anything that builds stay inside the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "bench" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "bench" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
# one process with few threads: the host work the units wait on is one
# Python thread, and idle pool threads would only compete with it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cell(manifest: dict, cell: dict, config: dict, traffic: dict, limits: dict, *,
             seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """The cell's run and its result object (``harness.result_line``'s
    fields), without the look for a card."""
    from bench import harness as H

    driver = H.load_driver(traffic, ROOT)
    res = driver.run(config, traffic, seed=seed, seconds=seconds, trace=trace, device=device,
                     t_start=t_start)
    correct, checks = H.judge(res["numbers"], limits)
    metrics: dict = {}
    breakdown = None
    if trace:
        tr = dict(res["trace"], memory_peak_bytes=res["memory_peak_bytes"])
        for m in H.per_layer_for(manifest, cell["name"]):
            value = H.load_reader(m["name"], ROOT).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        breakdown = tr["breakdown"]
    else:
        for m in H.end_to_end_for(manifest, cell["name"]):
            metrics[m["name"]] = {"value": float(res["end_to_end"][m["name"]]),
                                  "unit": m["unit"]}
    return {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "unit_s": res.get("unit_s", []),
            "metrics": metrics, "checks": checks, "breakdown": breakdown,
            "memory_peak_bytes": int(res["memory_peak_bytes"]),
            "busy_s": res.get("trace", {}).get("busy_s"),
            "window_s": res.get("trace", {}).get("window_s")}


def main(argv=None) -> int:
    args = parse(argv)
    from bench import harness as H

    manifest = H.load_manifest(ROOT)
    cell = H.cell(manifest, args.workload)
    config = H.load_config(manifest, cell, ROOT)
    traffic = H.load_traffic(cell, ROOT)
    limits = H.load_limits(cell["name"], ROOT)

    import torch

    if not torch.cuda.is_available():
        print("bench: no CUDA device: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"bench: the cell needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(1)
    out = run_cell(manifest, cell, config, traffic, limits, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace), device=device,
                   t_start=T_START)
    bad = H.forbidden_loaded()
    if bad:
        print(f"bench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        dev["busy_s"], dev["window_s"] = out["busy_s"], out["window_s"]
    from repro_torch.kernels import _build

    print(f"card: {power_limit()}; kernel libraries built {_build.builds}, loaded "
          f"{_build.loads}", file=sys.stderr)
    print("unit seconds: " + " ".join(f"{t:.4f}" for t in out["unit_s"]), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(H.result_line(correct=out["correct"], attempted=out["attempted"],
                        failed=out["failed"], metrics=out["metrics"], device=dev,
                        checks=out["checks"], breakdown=out["breakdown"]))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
