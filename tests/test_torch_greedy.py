"""Port parity: set functions, greedy engines and WRE sampling of
``repro_torch`` against the JAX reference.

Both engines get the reference's own Gram (as numpy), so ulps of two Gram
builds cannot decide a near-tie; the stochastic engines get the reference's
exact JAX draws through the port's ``noise=`` seam.  Trajectories must then
agree index for index.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.similarity import gram_matrix
from repro_torch.core import exploration as tex
from repro_torch.core import greedy as tg
from repro_torch.core import submodular as ts

# the suite runs in parallel workers beside wall-clock-sensitive tests:
# keep this file's PyTorch CPU work on one thread per worker
torch.set_num_threads(1)

# repro.core re-exports functions named like its modules; take the modules
jg = importlib.import_module("repro.core.greedy")
js = importlib.import_module("repro.core.submodular")
jex = importlib.import_module("repro.core.exploration")

FNS = ["facility_location", "graph_cut", "disparity_sum", "disparity_min"]


def _gram(n: int, d: int = 32, seed: int = 0) -> np.ndarray:
    z = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return np.asarray(gram_matrix(jnp.asarray(z)))


def _padded(K: np.ndarray, n_pad: int) -> tuple[np.ndarray, np.ndarray]:
    n = K.shape[0]
    Kp = np.zeros((n_pad, n_pad), np.float32)
    Kp[:n, :n] = K
    return Kp, np.arange(n_pad) < n


def sge_draws(key, n_subsets: int, k: int, n: int) -> np.ndarray:
    """The reference bank's Gumbel draws: split(key, n_subsets), then
    split(kk, k) per run, then gumbel(keys[t], (n,)) per step
    (``repro/core/greedy.py`` ``_sge_bank`` / ``stochastic_greedy``)."""
    def run(kk):
        return jax.vmap(lambda kt: jax.random.gumbel(kt, (n,)))(jax.random.split(kk, k))
    return np.asarray(jax.vmap(run)(jax.random.split(key, n_subsets)))


@pytest.mark.parametrize("name", FNS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_index_exact(name, seed):
    K = _gram(120, seed=seed)
    ref = jg.greedy(js.get(name), jnp.asarray(K), 40)
    out = tg.greedy(ts.get(name), torch.from_numpy(K), 40)
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(out.gains.numpy(), np.asarray(ref.gains), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("name", FNS)
def test_gains_at_matches_gathered_gains(name):
    """Bit-equal for the state-lookup functions.  Facility location reduces a
    gathered (n, s) block where ``gains`` reduces the (n, n) matrix, and
    PyTorch's column sums group the terms by the block's width, so the two
    agree to an fp32 ulp of the sum, not bit for bit (the reference's XLA
    sums are bit-equal); facility location is not on the ported path."""
    K = torch.from_numpy(_gram(48, seed=5))
    fn = ts.get(name)
    rng = np.random.default_rng(0)
    state = fn.init(K, 3)
    for _ in range(5):
        cand = torch.from_numpy(rng.integers(0, 48, size=(3, 13)))
        fast = ts.gains_at(fn, state, K, cand).numpy()
        full = fn.gains(state, K).gather(1, cand).numpy()
        if name == "facility_location":
            np.testing.assert_allclose(fast, full, rtol=2e-7, atol=0)
        else:
            np.testing.assert_array_equal(fast, full)
        state = fn.update(state, K, torch.from_numpy(rng.integers(0, 48, size=3)))


@pytest.mark.parametrize("name", FNS)
def test_evaluate_matches_reference(name):
    K = _gram(40, seed=6)
    mask = np.random.default_rng(1).random(40) < 0.3
    ref = float(js.get(name).evaluate(jnp.asarray(mask), jnp.asarray(K)))
    out = float(ts.get(name).evaluate(torch.from_numpy(mask), torch.from_numpy(K)))
    assert out == pytest.approx(ref, rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("bucketed", [False, True])
def test_greedy_importance(seed, bucketed):
    """Disparity-min importance is bit-equal.  Graph-cut's gains start from
    the Gram's column sums, which XLA and PyTorch add in different orders,
    so its importance agrees to rtol 1e-6 plus a few fp32 ulps of the
    largest column sum (gains near zero have no relative precision left)."""
    n = 150
    K = _gram(n, seed=seed)
    valid_j = valid_t = None
    if bucketed:
        K, valid = _padded(K, 256)
        valid_j, valid_t = jnp.asarray(valid), torch.from_numpy(valid)
    Kj, Kt = jnp.asarray(K), torch.from_numpy(K)
    ref = np.asarray(jg.greedy_importance(js.disparity_min, Kj, valid=valid_j))
    out = tg.greedy_importance(ts.disparity_min, Kt, valid=valid_t).numpy()
    np.testing.assert_array_equal(out, ref)
    if bucketed:
        assert not out[n:].any(), "padding never gains importance"
    ref = np.asarray(jg.greedy_importance(js.graph_cut, Kj, valid=valid_j))
    out = tg.greedy_importance(ts.graph_cut, Kt, valid=valid_t).numpy()
    ulp = float(np.spacing(np.float32(K.sum(0).max())))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=4 * ulp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stochastic_greedy_index_exact(seed):
    n, k = 130, 17
    K = _gram(n, seed=seed)
    key = jax.random.PRNGKey(seed)
    s = jg.stochastic_candidate_count(n, k, 0.01)
    assert tg.stochastic_candidate_count(n, k, 0.01) == s
    ref = jg.stochastic_greedy(js.graph_cut, jnp.asarray(K), k, key, s=s)
    noise = np.asarray(jax.vmap(lambda kt: jax.random.gumbel(kt, (n,)))(jax.random.split(key, k)))
    out = tg.stochastic_greedy(ts.graph_cut, torch.from_numpy(K), k, s=s, noise=noise)
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(ref.indices))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bucketed,exact_s", [(False, False), (True, False), (True, True)])
def test_sge_bank_index_exact(seed, bucketed, exact_s):
    """The bank (vmapped in the reference, a batch dimension here), with and
    without the pow2 padding + valid mask, and with s from the padded or
    the true geometry."""
    n, k, n_subsets = 200, 20, 4
    K = _gram(n, seed=seed)
    k_run, valid_j, valid_t = k, None, None
    if bucketed:
        K, valid = _padded(K, 256)
        k_run = 32
        valid_j, valid_t = jnp.asarray(valid), torch.from_numpy(valid)
    s = jg.stochastic_candidate_count(n, k, 0.01) if exact_s else None
    key = jax.random.PRNGKey(100 + seed)
    ref = np.asarray(jg.sge(js.graph_cut, jnp.asarray(K), k_run, key, n_subsets=n_subsets,
                            eps=0.01, valid=valid_j, s=s))
    out = tg.sge(ts.graph_cut, torch.from_numpy(K), k_run, n_subsets=n_subsets, eps=0.01,
                 valid=valid_t, s=s, noise=sge_draws(key, n_subsets, k_run, K.shape[0]))
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (out[:, :k] < n).all(), "padded elements are never picked"


def test_sge_generator_path_draws_distinct_valid_subsets():
    K = torch.from_numpy(_gram(100, seed=9))
    gen = torch.Generator().manual_seed(0)
    bank = tg.sge(ts.graph_cut, K, 10, n_subsets=6, generator=gen).numpy()
    assert bank.shape == (6, 10)
    assert all(len(set(row)) == 10 for row in bank)
    assert len({tuple(sorted(row)) for row in bank}) > 1, "runs draw independently"
    again = tg.sge(ts.graph_cut, K, 10, n_subsets=6,
                   generator=torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(bank, again)


def test_taylor_softmax_matches_reference():
    g = np.random.default_rng(0).normal(size=(300,)).astype(np.float32)
    np.testing.assert_allclose(tex.taylor_softmax(torch.from_numpy(g)).numpy(),
                               np.asarray(jex.taylor_softmax(jnp.asarray(g))), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wswor_index_exact_with_injected_noise(seed):
    rng = np.random.default_rng(seed)
    p = rng.random(400).astype(np.float32)
    p[rng.random(400) < 0.2] = 0.0           # masked entries can never be drawn
    p /= p.sum()
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jex.weighted_sample_without_replacement(key, jnp.asarray(p), 60))
    noise = np.asarray(jax.random.gumbel(key, p.shape))
    out = tex.weighted_sample_without_replacement(torch.from_numpy(p), 60, noise=noise)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert (p[out.numpy()] > 0).all()


def test_wswor_more_than_support_raises():
    p = torch.tensor([0.5, 0.5, 0.0, 0.0])
    with pytest.raises(ValueError, match="nonzero-probability"):
        tex.weighted_sample_without_replacement(p, 3, generator=torch.Generator())
    with pytest.raises(ValueError, match="nonzero-probability"):
        jex.weighted_sample_without_replacement(jax.random.PRNGKey(0), jnp.asarray(p.numpy()), 3)


def test_generator_draws_match_reference_distribution():
    """The port's own draws (a seeded ``torch.Generator``) cannot replay
    threefry; they are held to the reference's distribution instead.
    Gumbel noise: mean γ ≈ 0.5772, variance π²/6.  WSWOR: per-element
    inclusion frequencies over 3,000 draws agree with the reference's within
    0.05 (binomial sd ≤ 0.0091, so > 5 sd)."""
    g = tg.gumbel((200_000,), torch.Generator().manual_seed(0), "cpu").numpy()
    assert abs(g.mean() - np.euler_gamma) < 0.01
    assert abs(g.var() - np.pi ** 2 / 6) < 0.03
    m, k, n_draws = 30, 5, 3000
    p = np.random.default_rng(7).random(m).astype(np.float32) ** 2
    p /= p.sum()
    gen = torch.Generator().manual_seed(1)
    pt = torch.from_numpy(p)
    freq_t = np.zeros(m)
    for _ in range(n_draws):
        freq_t[tex.weighted_sample_without_replacement(pt, k, generator=gen).numpy()] += 1
    keys = jax.random.split(jax.random.PRNGKey(1), n_draws)
    draws_j = np.asarray(jax.vmap(lambda kk: jex._wswor(kk, jnp.asarray(p), k))(keys))
    freq_j = np.bincount(draws_j.ravel(), minlength=m)
    np.testing.assert_allclose(freq_t / n_draws, freq_j / n_draws, atol=0.05)
