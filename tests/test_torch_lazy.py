"""Port parity of the lazy-gain engine (``repro_torch.core.greedy.lazy_greedy``)
and of the kernel-backed facility location (``make_facility_location_pallas``)
against the JAX reference, on the reference's own fixtures
(``tests/test_selection_engine.py``, lazy-gain section).

What is demanded is what the reference demands of itself: the cached gains
drift from recomputed ones by a few ulps, and the port's drift is not the
reference's, so picks are index-exact within the shortlist horizon
(k = n/4), a full pass selects the same set with the same gains, two-level
gathers are bit-identical to single-level ones, and ``verify_argmax`` pins
the indices to eager ``greedy``.  ``rows_evaluated`` must equal the
reference's exactly.  Gains: rtol 1e-5 / atol 1e-6 within the horizon
(reduction-order ulps of gains ≤ n/2), rtol 1e-4 / atol 1e-5 over a full
pass (the reference's own tolerances).
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.similarity import gram_matrix, normalize_rows
from repro_torch.core import gram_free as tgf
from repro_torch.core import greedy as tg
from repro_torch.core import submodular as ts

torch.set_num_threads(1)

jg = importlib.import_module("repro.core.greedy")
jgf = importlib.import_module("repro.core.gram_free")
js = importlib.import_module("repro.core.submodular")


def _fixture(n: int, d: int = 16, seed: int = 20):
    """The reference's ``_fl_fixtures``: numpy features through the
    reference's normalisation and Gram, handed to both packages."""
    z = jnp.asarray(np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32))
    return np.asarray(normalize_rows(z)), np.asarray(gram_matrix(z))


def _variant(name: str, n: int):
    zn, K = _fixture(n)
    if name == "gram":
        return js.facility_location, ts.facility_location, K
    if name == "gram_pallas":
        return (js.make_facility_location_pallas(interpret=True, block_i=64, block_j=64),
                ts.make_facility_location_pallas(), K)
    return (jgf.make_gram_free_facility_location(use_pallas=True, interpret=True,
                                                 block_i=64, block_j=64),
            tgf.make_gram_free_facility_location(use_pallas=True), zn)


@pytest.mark.parametrize("variant", ["gram", "gram_pallas", "gram_free"])
@pytest.mark.parametrize("n", [192, 256])
def test_lazy_trajectory_matches_reference_within_horizon(variant, n):
    fj, ft, A = _variant(variant, n)
    k, budget = n // 4, n // 8
    ref = jg.lazy_greedy(fj, jnp.asarray(A), k, budget=budget)
    out = tg.lazy_greedy(ft, torch.from_numpy(A), k, budget=budget)
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_array_equal(out.rows_evaluated.numpy(), np.asarray(ref.rows_evaluated))
    np.testing.assert_allclose(out.gains.numpy(), np.asarray(ref.gains), rtol=1e-5, atol=1e-6)
    eager = tg.greedy(ft, torch.from_numpy(A), k)
    np.testing.assert_array_equal(out.indices.numpy(), eager.indices.numpy())


def test_counter_reduction_and_rows_match_reference():
    """A full pass: the counter shows >= 3x fewer row contractions than the
    eager engine's n per step, and equals the reference's step by step."""
    _, ft, zn = _variant("gram_free", 256)
    n = 256
    res = tg.lazy_greedy(ft, torch.from_numpy(zn), n, budget=n // 8)
    rows = res.rows_evaluated.numpy()
    assert set(rows.tolist()) <= {n // 8, n}
    assert n * n / (n + rows.sum()) >= 3.0
    assert rows[0] == n and rows[-1] == n // 8
    ref = jg.lazy_greedy(jgf.make_gram_free_facility_location(), jnp.asarray(zn), n, budget=n // 8)
    np.testing.assert_array_equal(rows, np.asarray(ref.rows_evaluated))


def test_full_pass_selects_the_same_set_with_the_same_gains():
    fj, ft, zn = _variant("gram_free", 160)
    zt = torch.from_numpy(zn)
    a = tg.greedy(ft, zt, 160)
    b = tg.lazy_greedy(ft, zt, 160, budget=20)
    assert set(a.indices.tolist()) == set(b.indices.tolist()) == set(range(160))
    np.testing.assert_allclose(a.gains.numpy(), b.gains.numpy(), rtol=1e-4, atol=1e-5)
    ia = tg.greedy_importance(ft, zt).numpy()
    ib = tg.greedy_importance(ft, zt, lazy_budget=20).numpy()
    ref = np.asarray(jg.greedy_importance(fj, jnp.asarray(zn), lazy_budget=20))
    np.testing.assert_allclose(np.sort(ia), np.sort(ib), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.sort(ib), np.sort(ref), rtol=1e-4, atol=1e-5)


def test_bucketed_padding():
    """Padded rows are never touched (infinite cover), padded elements never
    selected, and their importance is 0."""
    _, ft, zn = _variant("gram_free", 128)
    zp = np.zeros((160, zn.shape[1]), np.float32)
    zp[:128] = zn
    valid = torch.arange(160) < 128
    res = tg.lazy_greedy(ft, torch.from_numpy(zp), 160, budget=16, valid=valid)
    assert (res.indices[128:] == 0).all() and (res.gains[128:] == tg._NEG).all()
    assert (res.rows_evaluated[128:] == 0).all() and (res.indices[:128] < 128).all()
    g = tg.greedy_importance(ft, torch.from_numpy(zp), valid=valid, lazy_budget=16).numpy()
    assert not g[128:].any()
    ref = tg.greedy_importance(ft, torch.from_numpy(zn), lazy_budget=16).numpy()
    np.testing.assert_allclose(np.sort(g[:128]), np.sort(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_two_level_gather_bit_identical(masked):
    _, ft, zn = _variant("gram_free", 192)
    n, budget = 192, 24
    zt = torch.from_numpy(zn)
    valid = torch.arange(n) < 160 if masked else None
    a = tg.lazy_greedy(ft, zt, n, budget=budget, valid=valid)
    b = tg.lazy_greedy(ft, zt, n, budget=budget, valid=valid, two_level=True)
    assert torch.equal(a.indices, b.indices) and torch.equal(a.gains, b.gains)
    ra, rb = a.rows_evaluated.numpy(), b.rows_evaluated.numpy()
    np.testing.assert_array_equal(ra == n, rb == n)
    lazy_a, lazy_b = ra[(ra > 0) & (ra < n)], rb[(rb > 0) & (rb < n)]
    assert np.all(lazy_a == budget)
    assert set(lazy_b.tolist()) <= set(tg._gather_levels(budget))
    assert lazy_b.sum() < lazy_a.sum()
    ref = jg.lazy_greedy(jgf.make_gram_free_facility_location(), jnp.asarray(zn), n,
                         budget=budget, valid=None if valid is None else jnp.asarray(valid.numpy()),
                         two_level=True)
    # the recorded level sizes are the reference's wherever the picks agree
    agree = np.cumprod(np.asarray(ref.indices) == b.indices.numpy()).astype(bool)
    np.testing.assert_array_equal(rb[agree], np.asarray(ref.rows_evaluated)[agree])
    assert agree[: (160 if masked else n) // 4].all(), "within the horizon: n_valid / 4"


@pytest.mark.parametrize("budget", [1, 3, 7, 8, 64, 96, 100])
def test_gather_levels_match_reference(budget):
    assert tg._gather_levels(budget) == jg._gather_levels(budget)


def test_verify_argmax_restores_exact_near_ties():
    """The reference's CELF fixture: rows 12 and 40 are duplicates, a
    drifting delta hook bumps 40's cached gain by ~2 ulps per lazy step so
    the plain cached engine picks 40 first; verification restores eager
    greedy's trajectory exactly."""
    n, d, k = 64, 8, 40
    z = np.random.default_rng(11).normal(size=(n, d)).astype(np.float32)
    z[40] = z[12]
    K = torch.from_numpy(np.asarray(gram_matrix(jnp.asarray(z))))
    bump = (torch.arange(n) == 40).float() * 1e-6

    def drifting_delta(Km, rows, c_old, c_new):
        return ts._fl_delta_gains(Km, rows, c_old, c_new) + bump

    fn_drift = dataclasses.replace(
        ts.facility_location, name="fl_drifting",
        lazy=ts.LazyHooks(cover=lambda s: s["c"], delta_gains=drifting_delta))
    a = tg.greedy(ts.facility_location, K, k)
    assert 12 in a.indices.tolist()
    plain = tg.lazy_greedy(fn_drift, K, k, budget=n)
    assert plain.indices.tolist() != a.indices.tolist(), "the drift flips the near-tie"
    ver = tg.lazy_greedy(fn_drift, K, k, budget=n, verify_argmax=True)
    assert torch.equal(ver.indices, a.indices)
    np.testing.assert_allclose(ver.gains.numpy(), a.gains.numpy(), rtol=3e-7, atol=1e-9)
    ver2 = tg.lazy_greedy(ts.facility_location, K, k, budget=n // 4, verify_argmax=True)
    assert torch.equal(ver2.indices, a.indices)
    # the gram-free route, kernel route on the CPU: verified picks are eager greedy's
    zn = torch.from_numpy(np.asarray(normalize_rows(jnp.asarray(z))))
    fgf = tgf.make_gram_free_facility_location(use_pallas=True)
    ver3 = tg.lazy_greedy(fgf, zn, n, budget=8, two_level=True, verify_argmax=True, verify_top=4)
    assert torch.equal(ver3.indices, tg.greedy(fgf, zn, n).indices)


def test_requires_lazy_hooks_and_checks_arguments():
    K = torch.from_numpy(_fixture(32)[1])
    with pytest.raises(ValueError, match="lazy hooks"):
        tg.lazy_greedy(ts.graph_cut, K, 4, budget=8)
    with pytest.raises(ValueError, match="budget"):
        tg.lazy_greedy(ts.facility_location, K, 4, budget=0)
    with pytest.raises(ValueError, match="verify_top"):
        tg.lazy_greedy(ts.facility_location, K, 4, budget=4, verify_argmax=True, verify_top=0)
    # greedy_importance ignores the budget where there are no hooks
    a = tg.greedy_importance(ts.disparity_min, K).numpy()
    b = tg.greedy_importance(ts.disparity_min, K, lazy_budget=8).numpy()
    np.testing.assert_array_equal(a, b)


def test_facility_location_pallas_matches_dense_and_reference():
    """``make_facility_location_pallas`` (the kernel's plain version on the
    CPU) against the dense facility location and the reference's factory
    (its Pallas kernel in interpret mode)."""
    fj, ft, K = _variant("gram_pallas", 96)
    Kt = torch.from_numpy(K)
    a = tg.greedy(ft, Kt, 24)
    b = tg.greedy(ts.facility_location, Kt, 24)
    ref = jg.greedy(fj, jnp.asarray(K), 24)
    assert torch.equal(a.indices, b.indices) and torch.equal(a.gains, b.gains)
    np.testing.assert_array_equal(a.indices.numpy(), np.asarray(ref.indices))
    state = ft.init(Kt, 3)
    for j in ([5, 6, 7], [50, 60, 70]):
        ft.update(state, Kt, torch.tensor(j))
    cand = torch.tensor([[0, 95, 5], [1, 1, 2], [90, 40, 7]])
    assert torch.equal(ts.gains_at(ft, state, Kt, cand), ft.gains(state, Kt).gather(1, cand))
    assert ft.lazy is ts.facility_location.lazy
