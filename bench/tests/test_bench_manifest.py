"""The manifest, its files found by name, and the rules its names keep."""
from __future__ import annotations

import json
import re
import shutil
import time


from bench import harness as H
from conftest import CPU, load_run_module, tiny

WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|latent|state|proj|head|expan|per_tok)", re.I)


def test_every_file_is_found_by_name(manifest):
    assert H.check_names(manifest) == []
    for entry in manifest["configs"]:
        assert (H.ROOT / entry["file"]).is_file()
        assert entry["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
    for cell in manifest["workloads"]:
        H.load_config(manifest, cell)
        traffic = H.load_traffic(cell)
        H.load_driver(traffic)
        assert H.load_limits(cell["name"])
    for m in manifest["per_layer"]:
        assert callable(H.load_reader(m["name"]).read)


def test_names_units_and_contract_shape(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["command"][:2] == ["python3", "bench/run.py"]
    assert 1 <= manifest["run_seconds"] <= 51
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert H.NAME_RE.match(m["name"]) and H.UNIT_RE.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in manifest["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for entry in manifest["configs"]:
        assert not any(WIDTH.search(k) for k in entry["reduced"])
    assert len(json.dumps(manifest)) < 64 * 1024


def test_each_cell_reports_what_its_metrics_move(manifest):
    for cell in manifest["workloads"]:
        e2e = {m["name"] for m in H.end_to_end_for(manifest, cell["name"])}
        layer = H.per_layer_for(manifest, cell["name"])
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)


def test_a_new_cell_metric_and_config_come_from_new_files_alone(tmp_path, manifest):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a metric by new files and new manifest entries; the harness finds and
    runs them, and no file that was there changes."""
    root = tmp_path / "checkout"
    shutil.copytree(H.ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    cell, config, traffic, limits = tiny(manifest, "select.cifar10_vitb16.dense")
    config["name"] = "tiny_mixture"
    (root / "bench/configs/tiny_mixture.json").write_text(json.dumps(config))
    traffic["session"]["n_sge_subsets"] = 4
    (root / "bench/traffic/select.dense4.json").write_text(json.dumps(traffic))
    (root / "bench/limits/select.tiny_mixture.dense4.json").write_text(json.dumps(limits))
    (root / "bench/metrics/unit_count.select.py").write_text(
        "def read(trace):\n    return trace.get('classes_profiled')\n")
    m = json.loads(json.dumps(manifest))
    m["configs"].append({"name": "tiny_mixture", "source": "https://arxiv.org/abs/2301.13287",
                         "file": "bench/configs/tiny_mixture.json", "reduced": [],
                         "why": "a test's"})
    m["workloads"].append({"name": "select.tiny_mixture.dense4", "config": "tiny_mixture",
                           "traffic": "select.dense4", "chips": 1, "why": "a test's"})
    m["end_to_end"].append({"name": "select_rows_per_s", "unit": "rows/s", "better": "higher",
                            "bound": 0.25, "source": "host_clock",
                            "workloads": ["select.tiny_mixture.dense4"]})
    m["per_layer"].append({"name": "unit_count.select", "unit": "classes", "better": "higher",
                           "source": "program_counter", "layer": "device, selection",
                           "moves": "select_rows_per_s",
                           "workloads": ["select.tiny_mixture.dense4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    run = load_run_module()
    run.ROOT = root
    new = H.load_manifest(root)
    assert H.check_names(new) == []
    c = H.cell(new, "select.tiny_mixture.dense4")
    out = run.run_cell(new, c, H.load_config(new, c, root), H.load_traffic(c, root),
                       H.load_limits(c["name"], root), seed=2**31 + 3, seconds=0.2,
                       trace=True, device=CPU, t_start=time.perf_counter())
    assert out["correct"]
    assert out["metrics"]["unit_count.select"]["value"] >= 1
    after = {p.relative_to(root): p.read_bytes() for p in (root / "bench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)
