"""The LFM2-8B-A1B cell at a CPU test's size: its plain reference against
the port, its judge on a sound run, and three planted faults (a state left
unchanged, half of the batch left out, the expert bias ignored in routing),
each of which makes ``correct`` come out false.  The runs go through
``run_cell``, the whole run without the look for a card, with the cell's
own limits."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from bench import harness as H
from bench.reference import lfm2 as ref
from conftest import CPU

CELL = "lm_train.lfm2_8b_a1b.seq8192"
TINY_LFM2 = {"hidden_size": 128, "intermediate_size": 256, "moe_intermediate_size": 96,
             "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 256,
             "num_hidden_layers": 6, "num_dense_layers": 2, "router_experts": 32,
             "num_experts": 4, "expert_offset": 2,
             "layer_types": ["conv", "conv", "full_attention", "conv", "full_attention",
                             "conv"]}


def tiny(manifest: dict):
    cell = H.cell(manifest, CELL)
    config = H.load_config(manifest, cell)
    config.update(TINY_LFM2)
    traffic = H.load_traffic(cell)
    traffic.update({"n_docs": 64, "seq_len": 64})
    return cell, config, traffic, H.load_limits(CELL)


def run_tiny(run_module, manifest, *, trace=False, seed=2**31 + 13):
    """The cell's run (a traced one profiles its first step, so that a slow
    host still reaches the profiler)."""
    cell, config, traffic, limits = tiny(manifest)
    if trace:
        traffic.update({"profile_after": 0, "profile_steps": 1})
    return run_module.run_cell(manifest, cell, config, traffic, limits, seed=seed,
                               seconds=1.5 if trace else 0.3, trace=trace, device=CPU,
                               t_start=time.perf_counter())


def test_reference_loss_and_gradients_match_the_port_in_f32(manifest):
    """The benchmark's reference copy against the port's ``lm.loss_fn`` on
    the same weights and the same choices, both in float32."""
    from repro_torch import tree as T
    from repro_torch.models import lm
    from bench.drivers import lm_train_hybrid as drv

    _, config, _, _ = tiny(manifest)
    config["torch_dtype"] = "float32"
    cfg = drv.model_config(config)
    w = ref.weights(config, 5, CPU, dtype=torch.float32)
    tree = drv.param_tree(w, config)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 256, size=(2, 65))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "weights": np.array([1.0, 0.5], np.float32)}
    rec = drv._RouteRecorder(len(ref.moe_layers(config)), None)
    leaves = [p.detach().requires_grad_(True) for p in T.leaves(tree)]
    rec.install()
    try:
        port, _ = lm.loss_fn(T.unflatten(tree, leaves), cfg,
                             {k: torch.as_tensor(v) for k, v in batch.items()})
    finally:
        rec.remove()
    rec.end_step()
    names = [s[0] for s in ref.leaf_specs(config)]
    params = {n: w[n].float().clone().requires_grad_(True) for n in names}
    routes = ref._Routes(rec.steps[0])
    want = ref.loss_fn(params, batch, config, routes,
                       {i: b for i, b in ref.bias(config).items()})
    assert float(port.detach()) == pytest.approx(float(want.detach()), rel=1e-5)
    assert routes.route_err < 1e-6
    got = dict(zip(names, torch.autograd.grad(port, [drv.leaf(T.unflatten(tree, leaves), n)
                                                      for n in names])))
    exp = dict(zip(names, torch.autograd.grad(want, list(params.values()))))
    for n in names:
        np.testing.assert_allclose(got[n].numpy(), exp[n].numpy(), rtol=1e-4, atol=2e-5,
                                   err_msg=n)


def test_the_expert_bias_is_uneven_and_fixed(manifest):
    _, config, _, _ = tiny(manifest)
    full = H.load_config(manifest, H.cell(manifest, CELL))
    b = ref.bias(full)
    assert len(b) == 22 and all(t.shape == (32,) for t in b.values())
    assert float(max(t.abs().max() for t in b.values())) == pytest.approx(0.05 * 2.154, rel=1e-3)
    assert torch.equal(b[2], ref.bias(full)[2]) and not torch.equal(b[2], b[3])


def test_a_sound_run_is_correct(run_module, manifest):
    out = run_tiny(run_module, manifest, trace=True)
    assert out["correct"], out["checks"]
    assert "train_tokens_per_s" not in out["metrics"]           # a traced run
    assert "peak_mem_gib.lm_train" in out["metrics"]


def _broken_step(kind):
    from repro_torch.train import train_state

    make = train_state.make_train_step

    def factory(*a, **kw):
        step = make(*a, **kw)

        def broken(state, batch):
            if kind == "half_batch":
                batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
                return step(state, batch)
            _, metrics = step(state, batch)
            return state, metrics

        return broken

    return factory


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch"])
def test_training_faults_are_not_correct(run_module, manifest, monkeypatch, kind):
    from repro_torch.train import train_state

    monkeypatch.setattr(train_state, "make_train_step", _broken_step(kind))
    assert not run_tiny(run_module, manifest)["correct"]


def test_routing_that_ignores_the_bias_is_not_correct(run_module, manifest, monkeypatch):
    from repro_torch.models import moe
    from repro_torch.tree import Buffer

    inner = moe._sigmoid_router

    def unbiased(params, x, top_k, scale=1.0):
        zero = Buffer(torch.zeros_like(params["expert_bias"].value))
        return inner(dict(params, expert_bias=zero), x, top_k, scale)

    monkeypatch.setattr(moe, "_sigmoid_router", unbiased)
    out = run_tiny(run_module, manifest)
    assert not out["correct"]
    assert out["checks"]["route_err"]["value"] > out["checks"]["route_err"]["limit"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "bias_ignored"])
def test_the_drivers_planted_faults_fail_the_limits(manifest, fault):
    _, config, traffic, limits = tiny(manifest)
    numbers = H.load_driver(traffic).program_unit(config, traffic, seed=2**31 + 61, device=CPU,
                                                 fault=fault)
    assert not H.judge(numbers, limits)[0], numbers


@pytest.mark.parametrize("seed", [2**31 + 51, 9])
def test_the_control_fails_the_limits(manifest, seed):
    _, config, traffic, limits = tiny(manifest)
    numbers = H.load_driver(traffic).control(config, traffic, seed=seed, device=CPU)
    assert not H.judge(numbers, limits)[0], numbers


def test_model_flops_of_the_cell(manifest):
    from bench.counts import lfm2 as counts

    m = H.load_config(manifest, H.cell(manifest, CELL))
    assert counts.matmul_params(m) == pytest.approx(0.831e9, rel=1e-3)
    assert counts.train_flops_per_token(m, 8192) == pytest.approx(6.19e9, rel=1e-3)
    assert counts.train_flops_per_step(m, 4, 8192) == pytest.approx(2.03e14, rel=1e-3)
    assert counts.expert_flops_per_row(m) == 18 * 2048 * 1792
