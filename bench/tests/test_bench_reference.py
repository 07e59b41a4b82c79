"""The plain references against the port at a tiny size, and the controls
(the references in the precision below, in the program's place) failing the
cells' own limits."""
from __future__ import annotations


import numpy as np
import pytest
import torch

from bench import data, harness as H
from bench.reference import lm as ref_lm, selection as ref_sel
from conftest import CPU, tiny

SELECT = ["select.cifar10_vitb16.dense", "select.cifar10_vitb16.gramfree_lazy"]
LM = "lm_train.internlm2_1_8b.seq4096"


@pytest.mark.parametrize("cell", SELECT)
def test_selection_reference_agrees_with_the_port(manifest, cell):
    _, config, traffic, limits = tiny(manifest, cell)
    driver = H.load_driver(traffic)
    numbers = driver.program_unit(config, traffic, seed=2**31 + 21, device=CPU)
    ok, checks = H.judge(numbers, limits)
    assert ok, checks
    assert numbers["faults"] == 0 and numbers["sge_gap"] < 1e-6


@pytest.mark.parametrize("cell", SELECT)
@pytest.mark.parametrize("seed", [2**31 + 31, 7])
def test_selection_control_fails_the_limits(manifest, cell, seed):
    _, config, traffic, limits = tiny(manifest, cell)
    numbers = H.load_driver(traffic).control(config, traffic, seed=seed, device=CPU)
    assert not H.judge(numbers, limits)[0], numbers


def test_gram_reference_matches_the_port():
    from repro_torch.core.similarity import gram_matrix_blocked

    z = torch.randn(300, 24, generator=torch.Generator().manual_seed(0))
    port = gram_matrix_blocked(z, use_pallas=True)
    assert torch.allclose(port.double(), ref_sel.gram64(z), atol=1e-6)


def test_lm_reference_loss_matches_the_port_in_f32(manifest):
    """The reference's loss against the port's ``lm.loss_fn`` on the same
    weights, both in float32."""
    from repro_torch.models import lm
    from bench.drivers.lm_train import model_config, param_tree

    _, config, traffic, _ = tiny(manifest, LM)
    config["model"]["torch_dtype"] = "float32"
    cfg = model_config(config)
    w = data.lm_weights(config["model"], 5, CPU, dtype=torch.float32)
    corpus = data.TokenCorpus(8, 32, config["model"]["vocab_size"], 5)
    batch = corpus.batch(np.arange(2))
    batch["weights"] = np.array([1.0, 0.5], np.float32)
    port, _ = lm.loss_fn(param_tree(w, config["model"]["num_hidden_layers"]), cfg,
                         {k: torch.as_tensor(v) for k, v in batch.items()})
    ref = ref_lm.loss_fn(w, batch, config["model"])
    assert float(port) == pytest.approx(float(ref), rel=1e-5)


def test_lm_reference_agrees_with_the_port(manifest):
    _, config, traffic, limits = tiny(manifest, LM)
    numbers = H.load_driver(traffic).program_steps(config, traffic, seed=2**31 + 41, device=CPU)
    ok, checks = H.judge(numbers, limits)
    assert ok, checks


@pytest.mark.parametrize("seed", [2**31 + 51, 9])
def test_lm_control_fails_the_limits(manifest, seed):
    _, config, traffic, limits = tiny(manifest, LM)
    numbers = H.load_driver(traffic).control(config, traffic, seed=seed, device=CPU)
    assert not H.judge(numbers, limits)[0], numbers
