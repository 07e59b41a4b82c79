"""The benchmark's manifest, its files found by name, and the result line.

``BENCHMARK.json`` at the root of the checkout names the configurations,
the cells and the metrics.  Everything that belongs to one of them sits in
a file of its own, found by the name the manifest gives it:

- ``bench/configs/<config>.json``: the configuration as it is run (the
  manifest's ``file``);
- ``bench/traffic/<traffic>.json``: a traffic mix, the parameters that its
  driver reads (``driver`` names ``bench/drivers/<driver>.py``);
- ``bench/limits/<cell>.json``: the limit of each number that decides the
  cell's ``correct``;
- ``bench/metrics/<metric>.py``: the reader of one per-layer metric, a
  ``read(trace)`` that returns a number or ``None``.

So a later change adds a configuration, a traffic mix, a cell or a metric
by adding files and manifest entries, and edits no file that is here.
"""
from __future__ import annotations

import importlib.util
import json
import math
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Any

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
# top-level modules that nothing the benchmark runs may load: the JAX
# package, its benchmarks, and JAX itself (compared by the whole name before
# the first dot: ``repro_torch`` is not ``repro``)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")


class BenchError(RuntimeError):
    """The benchmark cannot run here (no card, a missing file, a bad name)."""


def load_manifest(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.exists():
        raise BenchError(f"no manifest at {path}")
    return json.loads(path.read_text())


def _by_name(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise BenchError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(manifest: dict, name: str) -> dict:
    return _by_name(manifest["workloads"], name, "workload")


def config_entry(manifest: dict, name: str) -> dict:
    return _by_name(manifest["configs"], name, "config")


def read_json(path: Path) -> dict:
    if not path.exists():
        raise BenchError(f"missing file {path}")
    return json.loads(path.read_text())


def load_config(manifest: dict, cell_entry: dict, root: Path = ROOT) -> dict:
    return read_json(root / config_entry(manifest, cell_entry["config"])["file"])


def load_traffic(cell_entry: dict, root: Path = ROOT) -> dict:
    return read_json(root / "bench" / "traffic" / f"{cell_entry['traffic']}.json")


def load_limits(cell_name: str, root: Path = ROOT) -> dict:
    return read_json(root / "bench" / "limits" / f"{cell_name}.json")


def load_module(path: Path, name: str) -> ModuleType:
    """A Python file of the benchmark by its path (metric readers carry dots
    in their names, so they are loaded by path, not imported)."""
    if not path.exists():
        raise BenchError(f"missing file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_driver(traffic: dict, root: Path = ROOT) -> ModuleType:
    return load_module(root / "bench" / "drivers" / f"{traffic['driver']}.py",
                       f"bench_driver_{traffic['driver']}")


def load_reader(metric: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / "bench" / "metrics" / f"{metric}.py",
                       "bench_metric_" + re.sub(r"\W", "_", metric))


def _reports(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end_for(manifest: dict, cell_name: str) -> list[dict]:
    """The end-to-end metrics this cell reports."""
    return [m for m in manifest["end_to_end"] if _reports(m, cell_name)]


def per_layer_for(manifest: dict, cell_name: str) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose ``moves`` metric the cell reports."""
    e2e = {m["name"] for m in end_to_end_for(manifest, cell_name)}
    out = []
    for m in manifest["per_layer"]:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out


def forbidden_loaded(modules=None) -> list[str]:
    """Names in ``sys.modules`` whose top-level package is forbidden."""
    mods = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in mods}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def check_names(manifest: dict) -> list[str]:
    """Every name, unit and cross-reference that the manifest's rules fix;
    returns the faults found (an empty list when the manifest is sound)."""
    faults = []

    def name_ok(what, s):
        if not isinstance(s, str) or not NAME_RE.match(s):
            faults.append(f"{what}: bad name {s!r}")

    seen = set()
    for c in manifest["configs"]:
        name_ok("config", c["name"])
        for k in c["reduced"]:
            name_ok("reduced key", k)
    for w in manifest["workloads"]:
        for key in ("name", "config", "traffic"):
            name_ok(f"workload {key}", w[key])
        if w["chips"] not in (1, 4):
            faults.append(f"workload {w['name']}: chips {w['chips']}")
        pair = (w["config"], w["traffic"])
        if pair in seen:
            faults.append(f"workload {w['name']}: config and traffic repeated")
        seen.add(pair)
    names = set()
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        name_ok("metric", m["name"])
        if m["name"] in names:
            faults.append(f"metric {m['name']} twice")
        names.add(m["name"])
        if not UNIT_RE.match(m["unit"]):
            faults.append(f"metric {m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            faults.append(f"metric {m['name']}: better {m['better']!r}")
    e2e = {m["name"] for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    for m in manifest["per_layer"]:
        if m["moves"] not in e2e:
            faults.append(f"metric {m['name']} moves unknown {m['moves']!r}")
        for c in m.get("workloads", []):
            if c not in cells:
                faults.append(f"metric {m['name']} lists unknown cell {c!r}")
            elif m["moves"] not in {x["name"] for x in end_to_end_for(manifest, c)}:
                faults.append(f"metric {m['name']}: cell {c} does not report {m['moves']}")
    return faults


def finite(x: Any) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def result_line(*, correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown: dict | None = None) -> str:
    """The run's last line of standard output: one JSON object, the checks'
    numbers and limits under the last key."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each limited number against its limit: correct when every number is
    finite and at most its limit (a number the run did not produce fails)."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = finite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value if finite(value) else str(value), "limit": limit}
    return ok, checks
