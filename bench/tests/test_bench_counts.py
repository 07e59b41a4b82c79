"""The operation and byte counts against PERF.md's kernel table, and the
model FLOPs of the LM cell."""
from __future__ import annotations

import pytest

from bench import harness as H
from bench.counts import kernels as kc, model


def test_b1_bound_at_the_table_shape():
    assert kc.bound_s(*kc.b1(2048, 5000, 768)) * 1e3 == pytest.approx(0.2348, abs=5e-5)


def test_b2_bound_all_rows_and_live_rows():
    assert kc.bound_s(*kc.b2(8192, 8192, 8192, 768)) * 1e3 == pytest.approx(1.5425, abs=5e-5)
    assert kc.bound_s(*kc.b2(4496, 8192, 8192, 768)) * 1e3 == pytest.approx(0.8466, abs=5e-5)


def test_b3_bound_is_the_bytes_at_small_b():
    ops, nbytes = kc.b3(8, 8, 8192, 768)
    assert kc.bound_s(ops, nbytes) == pytest.approx(nbytes / 3.35e12)
    assert kc.bound_s(ops, nbytes) * 1e3 == pytest.approx(0.0075, abs=5e-5)


def test_palm_flops_of_the_lm_cell():
    m = H.load_config(H.load_manifest(), {"config": "internlm2_1_8b"})["model"]
    assert model.matmul_params(m) == pytest.approx(1.70e9, rel=5e-3)
    assert model.train_flops_per_token(m, 4096) == pytest.approx(1.26e10, rel=5e-3)
    assert model.train_flops_per_step(m, 2, 4096) == pytest.approx(1.03e14, rel=5e-3)
