"""The plain versions of the facility-location gain kernels (``repro_torch.
kernels.fl_gains``) against the JAX reference's plain versions and its Pallas
kernels in interpret mode, at odd shapes with ``+inf`` padding rows, and the
order properties the CUDA kernels share with them.

Tolerance against the reference: rtol 1e-5, atol 1e-4 — the reference's own
kernel-against-oracle tolerance (``tests/test_selection_engine.py``
``test_gram_free_kernel_vs_ref_odd_shapes``).  The two sum the same fp32
terms in different orders (XLA's fp32 reduction against a float64 running
sum), over at most 256 rows of terms ≤ 1.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fl_gains import ops as jops
from repro.kernels.fl_gains import ref as jref
from repro_torch.kernels.fl_gains import fl_gains as tkern
from repro_torch.kernels.fl_gains import ops as tops
from repro_torch.kernels.fl_gains import ref as tref

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-4)
# (n ground rows, n_cand candidates, d): singletons, odd widths, n past one
# 64-row tile and past a 256-row chunk of the CUDA kernels
SHAPES = [(128, 128, 16), (200, 61, 24), (65, 130, 7), (1, 1, 8), (256, 1, 5), (257, 33, 32)]


def _unit_rows(rng, m, d):
    z = rng.normal(size=(m, d)).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


def _inputs(n, n_cand, d, seed):
    """Normalised rows, candidates, and covers with ~1/5 of the rows at +inf
    (the bucketed padding rows of the gram-free engines)."""
    rng = np.random.default_rng(seed)
    z, zc = _unit_rows(rng, n, d), _unit_rows(rng, n_cand, d)
    c = rng.uniform(size=(n,)).astype(np.float32)
    c[rng.random(n) < 0.2] = np.inf
    c_new = np.maximum(c, rng.uniform(size=(n,)).astype(np.float32))
    return z, zc, c, c_new


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n,n_cand,d", SHAPES)
def test_gram_free_matches_reference_and_interpret_kernel(n, n_cand, d):
    z, zc, c, _ = _inputs(n, n_cand, d, n + n_cand)
    out = tops.fl_gains_gram_free(*_t(z, zc, c)).numpy()
    ref = np.asarray(jref.fl_gains_gram_free_ref(jnp.asarray(z), jnp.asarray(zc), jnp.asarray(c)))
    pallas = np.asarray(jops.fl_gains_gram_free(jnp.asarray(z), jnp.asarray(zc), jnp.asarray(c),
                                                block_i=64, block_j=128, interpret=True))
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pallas, **TOL)
    assert np.isfinite(out).all() and (out >= 0).all()


@pytest.mark.parametrize("n,n_cand,d", SHAPES)
def test_delta_matches_reference_and_interpret_kernel(n, n_cand, d):
    z, zc, c_old, c_new = _inputs(n, n_cand, d, 7 * n + n_cand)
    out = tops.fl_gains_gram_free_delta(*_t(z, zc, c_old, c_new)).numpy()
    args = [jnp.asarray(a) for a in (z, zc, c_old, c_new)]
    ref = np.asarray(jref.fl_gains_gram_free_delta_ref(*args))
    pallas = np.asarray(jops.fl_gains_gram_free_delta(*args, block_i=64, block_j=128,
                                                      interpret=True))
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pallas, **TOL)
    assert np.isfinite(out).all() and (out <= 0).all(), "covers only grow"


@pytest.mark.parametrize("n,n_cand,d", SHAPES)
def test_dense_matches_reference_and_interpret_kernel(n, n_cand, d):
    z, zc, c, _ = _inputs(n, n_cand, d, 3 * n + n_cand)
    K = (0.5 + 0.5 * z @ zc.T).astype(np.float32)
    out = tops.fl_gains(*_t(K, c)).numpy()
    ref = np.asarray(jref.fl_gains_ref(jnp.asarray(K), jnp.asarray(c)))
    pallas = np.asarray(jops.fl_gains(jnp.asarray(K), jnp.asarray(c), block_i=64, block_j=128,
                                      interpret=True))
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, pallas, **TOL)


def test_inf_rows_are_exact_zeros():
    """A row at +inf cover adds exactly nothing: the result with such rows
    equals the result without them bit for bit (gains and delta)."""
    z, zc, c, c_new = _inputs(150, 40, 12, 0)
    live = np.isfinite(c)
    tz, tzc, tc, tcn = _t(z, zc, c, c_new)
    full = tref.fl_gains_gram_free_ref(tz, tzc, tc)
    only = tref.fl_gains_gram_free_ref(*_t(z[live], zc, c[live]))
    assert torch.equal(full, only)
    # the delta's padding slots: both covers +inf, anywhere in the block
    c_o = np.where(live, c, np.inf).astype(np.float32)
    c_n = np.where(live, c_new, np.inf).astype(np.float32)
    d_full = tref.fl_gains_gram_free_delta_ref(*_t(z, zc, c_o, c_n))
    d_live = tref.fl_gains_gram_free_delta_ref(*_t(z[live], zc, c_o[live], c_n[live]))
    assert torch.equal(d_full, d_live)
    assert not torch.isnan(d_full).any()


@pytest.mark.parametrize("width", [1, 2, 5, 64])
def test_trailing_padding_rows_leave_sums_bit_identical(width):
    """The lazy engine's two-level gathers: the same touched rows followed
    by any number of +inf padding slots give the same delta, bit for bit."""
    z, zc, c_old, c_new = _inputs(width, 90, 16, width)
    base = tref.fl_gains_gram_free_delta_ref(*_t(z, zc, c_old, c_new))
    for extra in (1, 3, 64):
        zp = np.concatenate([z, np.zeros((extra, 16), np.float32)])
        inf = np.full((extra,), np.inf, np.float32)
        out = tref.fl_gains_gram_free_delta_ref(*_t(zp, zc, np.concatenate([c_old, inf]),
                                                    np.concatenate([c_new, inf])))
        assert torch.equal(out, base), extra


def test_candidate_subsets_are_bit_equal_to_the_full_call():
    """gains_at == gathered gains, and the delta on a candidate slice == the
    slice of the full call, bit for bit."""
    z, _, c, c_new = _inputs(230, 1, 24, 5)
    tz, tc, tcn = _t(z, c, c_new)
    full = tref.fl_gains_gram_free_ref(tz, tz, tc)
    cand = torch.tensor([0, 229, 17, 17, 100, 3])
    assert torch.equal(tref.fl_gains_gram_free_ref(tz, tz[cand], tc), full[cand])
    assert torch.equal(tref.fl_gains_gram_free_ref(tz, tz[5:6], tc), full[5:6])
    rows = torch.arange(0, 230, 7)
    d_full = tref.fl_gains_gram_free_delta_ref(tz[rows], tz, tc[rows], tcn[rows])
    d_slice = tref.fl_gains_gram_free_delta_ref(tz[rows], tz[40:97], tc[rows], tcn[rows])
    assert torch.equal(d_slice, d_full[40:97])
    K = tref._sim(tz, tz)
    dense = tref.fl_gains_ref(K, tc)
    assert torch.equal(tref.fl_gains_ref(K[:, cand], tc), dense[cand])


def test_batched_covers_equal_one_call_per_run():
    z, _, c, c_new = _inputs(120, 1, 10, 9)
    tz, tc, tcn = _t(z, c, c_new)
    covers = torch.stack([tc, tcn, torch.zeros_like(tc)])
    cand = torch.tensor([[1, 2, 3], [50, 4, 4], [119, 0, 60]])
    batched = tops.fl_gains_gram_free(tz, tz[cand], covers)
    shared = tops.fl_gains_gram_free(tz, tz, covers)
    for b in range(3):
        assert torch.equal(batched[b], tops.fl_gains_gram_free(tz, tz[cand[b]], covers[b]))
        assert torch.equal(shared[b], tops.fl_gains_gram_free(tz, tz, covers[b]))
    K = tref._sim(tz, tz)
    assert torch.equal(tops.fl_gains(K, covers)[1], tops.fl_gains(K, covers[1]))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_cpu_tensors_take_the_plain_versions(use_pallas):
    z, zc, c, c_new = _inputs(40, 30, 8, 2)
    tz, tzc, tc, tcn = _t(z, zc, c, c_new)
    assert torch.equal(tops.fl_gains_gram_free(tz, tzc, tc, use_pallas=use_pallas),
                       tref.fl_gains_gram_free_ref(tz, tzc, tc))
    assert torch.equal(tops.fl_gains_gram_free_delta(tz, tzc, tc, tcn, use_pallas=use_pallas),
                       tref.fl_gains_gram_free_delta_ref(tz, tzc, tc, tcn))


def test_kernel_wrappers_refuse_cpu_tensors():
    """No silent fallback: a wrapper handed a CPU tensor raises instead of
    computing the plain version itself, and launches nothing."""
    z, zc, c, c_new = _t(*_inputs(16, 8, 4, 1))
    before = dict(tkern.launches)
    with pytest.raises(ValueError, match="CUDA"):
        tkern.fl_gains_gram_free_cuda(z, zc, c)
    with pytest.raises(ValueError, match="CUDA"):
        tkern.fl_gains_gram_free_delta_cuda(z, zc, c, c_new)
    with pytest.raises(ValueError, match="CUDA"):
        tkern.fl_gains_cuda(torch.zeros((16, 8)), c)
    assert tkern.launches == before


def test_the_kernels_source_entry_points_match_the_bindings():
    """Every ctypes binding names a C entry point of ``csrc/fl_gains.cu``
    with as many parameters as it declares, and every entry point there is
    a binding or the small-b launch's shared-memory report."""
    import re
    from pathlib import Path

    src = (Path(tkern.__file__).parents[2] / "csrc" / "fl_gains.cu").read_text()
    entries = {name: [p for p in params.split(",") if p.strip()]
               for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    for name, argtypes in tkern._ARGTYPES.items():
        assert name in entries, name
        assert len(entries[name]) == len(argtypes), name
    assert set(entries) == set(tkern._ARGTYPES) | {"fl_gains_gram_free_delta_small_b_smem_bytes"}
    assert importlib.import_module("repro_torch.kernels.fl_gains.ops") is tops


# ---------------------------------------------------------------------------
# the delta kernels' fixed summation order (``ref.delta_order_sum``), which
# both CUDA instances follow bit for bit (tests/test_torch_cuda.py holds them
# to it on the card)
# ---------------------------------------------------------------------------

def _delta_terms(z, zc, c_old, c_new):
    """The kernels' row terms relu(K - c_new) - relu(K - c_old) in fp32."""
    K = tref._sim(z, zc)
    return torch.relu(K - c_new[:, None]) - torch.relu(K - c_old[:, None])


@pytest.mark.parametrize("b", [1, 2, 5, 16])
def test_order_sum_is_the_sequential_sum_for_few_rows(b):
    """Up to 16 rows every partial holds one row, so the order is the
    sequential fp32 sum from row 0."""
    terms = _delta_terms(*_t(*_inputs(b, 70, 12, 40 + b)))
    seq = torch.zeros(70)
    for row in terms:
        seq = seq + row
    assert torch.equal(tref.delta_order_sum(terms), seq)


@pytest.mark.parametrize("level", [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024])
def test_order_sum_ignores_trailing_inf_rows(level):
    """The lazy engine's gather levels: b touched rows padded with +inf
    rows (exact-zero terms) to this level and to the 1024 budget keep the
    sum of the b rows, bit for bit."""
    b = max(1, (3 * level) // 4)
    z, zc, c_old, c_new = _t(*_inputs(b, 50, 8, level))
    base = tref.delta_order_sum(_delta_terms(z, zc, c_old, c_new))
    for size in (level, 1024):
        pad = size - b
        zp = torch.cat([z, torch.zeros((pad, 8))])
        inf = torch.full((pad,), float("inf"))
        terms = _delta_terms(zp, zc, torch.cat([c_old, inf]), torch.cat([c_new, inf]))
        assert torch.equal(tref.delta_order_sum(terms), base), size


@pytest.mark.parametrize("b", [1, 7, 64, 300, 1024])
def test_order_sum_agrees_with_the_delta_ref(b):
    """The fixed fp32 order against the plain version's float64 running sum:
    within the smoke's fl_tol (rtol 1e-4, atol 2^-20 per row, at least 1e-5)."""
    z, zc, c_old, c_new = _t(*_inputs(b, 90, 16, b))
    out = tref.delta_order_sum(_delta_terms(z, zc, c_old, c_new))
    ref = tref.fl_gains_gram_free_delta_ref(z, zc, c_old, c_new)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4, atol=max(1e-5, b * 2.0**-20))


def test_small_b_instance_edge_is_a_gather_level():
    """The small-b instance's largest b (``SMALL_B`` of ``csrc/fl_gains.cu``,
    where the entry point alone picks the instance) is a level of the
    two-level gathers at the budgets the engines use, and the entry point's
    comment and the wrapper's docstring state the same edge."""
    import re
    from pathlib import Path

    from repro_torch.core import greedy

    src = (Path(tkern.__file__).parents[2] / "csrc" / "fl_gains.cu").read_text()
    edge = int(re.search(r"constexpr int SMALL_B = (\d+);", src).group(1))
    for budget in (128, 1024):
        assert edge in greedy._gather_levels(budget)
    assert f"instance for b <= {edge}, d % 4 == 0" in src
    assert f"b ≤ {edge} touched rows" in tkern.__doc__
