"""Aggregate the dry run's per-cell JSON records into roofline tables (port
of ``repro.launch.report``).

The terms are analytic bounds from the H100 spec sheet (``launch.roofline``)
over the dry run's per-device counts (``launch.cost_analysis``), not
measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.report --dir results/dryrun
"""
from __future__ import annotations

import argparse
import json
import math
import os

from repro_torch.launch.mesh import production_layout

_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def load_all(out_dir: str) -> list[dict]:
    recs = []
    for fn in sorted(os.listdir(out_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(out_dir, fn)) as f:
                recs.append(json.load(f))
    return recs


def fmt_table(recs: list[dict], mesh: str) -> str:
    rows = [
        "| arch | shape | status | compute s | memory s | collective s | bound "
        "| MODEL_FLOPs | useful ratio | roofline frac | bytes/dev |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: (r["arch"], _ORDER.get(r["shape"], 9))):
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | skipped — {r['reason'][:46]} "
                        "| | | | | | | | |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | | | |")
            continue
        t = r["roofline"]
        mem_dev = r.get("memory", {}).get("argument_size_in_bytes", 0)
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok | {t['compute_s']:.3g} "
            f"| {t['memory_s']:.3g} | {t['collective_s']:.3g} | **{t['bound']}** "
            f"| {t['model_flops']:.3g} | {t['useful_flops_ratio']:.2f} "
            f"| {t['roofline_fraction']:.4f} | {mem_dev / 1e9:.2f} GB |"
        )
    return "\n".join(rows)


def fmt_summary(recs: list[dict]) -> str:
    ok = sum(1 for r in recs if r["status"] == "ok")
    sk = sum(1 for r in recs if r["status"] == "skipped")
    er = sum(1 for r in recs if r["status"] not in ("ok", "skipped"))
    return f"{ok} ok, {sk} skipped (documented), {er} errors of {len(recs)} cells"


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    args = ap.parse_args(argv)
    recs = load_all(args.dir)
    print("## Summary:", fmt_summary(recs))
    for multi_pod in (False, True):
        shape, _, label = production_layout(multi_pod=multi_pod)
        n = math.prod(shape)
        kind = "Multi-pod" if multi_pod else "Single-pod"
        print(f"\n### {kind} ({label} = {n} H100s; analytic bounds, H100 SXM spec sheet)\n")
        print(fmt_table(recs, label))


if __name__ == "__main__":
    main()
