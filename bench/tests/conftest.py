"""Shared pieces of the benchmark's CPU tests: tiny stand-ins of each
configuration, and the cell runner without the look for a card."""
from __future__ import annotations

import importlib.util
import time

import pytest
import torch

from bench import harness as H

TINY_DATA = {"n_train": 600, "n_classes": 3, "feature_dim": 32}
TINY_MODEL = {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
              "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 256}
TINY_TRAFFIC = {"n_docs": 64, "seq_len": 32}
CPU = torch.device("cpu")


# cells whose files are here and whose manifest entries wait (PERF.md,
# Open questions): their judges and their kernels' plain paths stay tested
WAITING = {name: {"name": name, "config": "cifar10_vitb16", "traffic": traffic, "chips": 1}
           for name, traffic in (("select.cifar10_vitb16.dense", "select.dense"),
                                 ("select.cifar10_vitb16.gramfree_lazy",
                                  "select.gramfree_lazy"))}
WAITING_CONFIG = {"name": "cifar10_vitb16", "source": "https://arxiv.org/abs/2301.13287",
                  "file": "bench/configs/cifar10_vitb16.json", "reduced": [],
                  "why": "CIFAR-10's training split at ViT-B/16's width"}


def tiny(manifest: dict, cell_name: str) -> tuple[dict, dict, dict, dict]:
    """(cell, config, traffic, limits) of a cell, its sizes cut to a CPU
    test's; the limits are the cell's own."""
    if cell_name in WAITING:
        cell = WAITING[cell_name]
        config = H.read_json(H.ROOT / WAITING_CONFIG["file"])
    else:
        cell = H.cell(manifest, cell_name)
        config = H.load_config(manifest, cell)
    traffic = H.load_traffic(cell)
    if "data" in config:
        config["data"].update(TINY_DATA)
    else:
        config["model"].update(TINY_MODEL)
        traffic.update(TINY_TRAFFIC)
    return cell, config, traffic, H.load_limits(cell_name)


def load_run_module():
    spec = importlib.util.spec_from_file_location("bench_run", H.BENCH / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="session")
def manifest() -> dict:
    return H.load_manifest()


@pytest.fixture(scope="session")
def run_module():
    return load_run_module()


def run_tiny(run_module, manifest: dict, cell_name: str, *, trace: bool = False,
             seed: int = 2**31 + 11, seconds: float = 0.3) -> dict:
    cell, config, traffic, limits = tiny(manifest, cell_name)
    return run_module.run_cell(manifest, cell, config, traffic, limits, seed=seed,
                               seconds=seconds, trace=trace, device=CPU,
                               t_start=time.perf_counter())
