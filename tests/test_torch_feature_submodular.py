"""The port's kernel-free (landmark) submodular selection
(``repro_torch.core.feature_submodular``) against ``repro.core.
feature_submodular`` on the CPU, at the reference's test sizes
(``tests/test_feature_submodular.py``).

The reference draws its k-means++ centres with ``jax.random``: one
``randint`` for the first, then one Gumbel-max ``categorical`` per centre.
The port takes those draws through its ``draws=(first, noise)`` seam, so
centres and Φ are held at fp32 ``rtol 1e-5, atol 1e-6`` and the greedy
indices exactly; the port's own ``torch.Generator`` draws are checked
statistically (the first centre uniform, each later one proportional to
the squared distance).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import facility_location as j_fl, gram_matrix as j_gram, greedy as j_greedy
from repro.core import feature_submodular as JF
from repro.data.datasets import GaussianMixtureDataset
from repro_torch.core import feature_submodular as TF
from repro_torch.core.greedy import greedy
from repro_torch.core.similarity import gram_matrix
from repro_torch.core.submodular import facility_location

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def clustered():
    ds = GaussianMixtureDataset(n=400, n_classes=8, dim=16, seed=0)
    return np.asarray(ds.features(), np.float32)


def reference_draws(key, m: int, n_landmarks: int):
    """The reference's k-means++ draws for ``key``: the first centre's row
    (``randint`` on the first half of the split) and, per later centre, the
    Gumbel draws ``categorical`` adds to its logits."""
    k0, k1 = jax.random.split(key)
    first = int(jax.random.randint(k0, (), 0, m))
    keys = jax.random.split(k1, n_landmarks - 1)
    noise = jax.vmap(lambda kk: jax.random.gumbel(kk, (m,)))(keys)
    return first, np.asarray(noise)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


@pytest.mark.parametrize("seed,n_landmarks", [(0, 32), (1, 16), (2, 80)])
def test_centres_and_phi_match_reference(clustered, seed, n_landmarks):
    key = jax.random.PRNGKey(seed)
    draws = reference_draws(key, len(clustered), n_landmarks)
    cj = np.asarray(JF.kmeans_pp_landmarks(key, jnp.asarray(clustered), n_landmarks))
    ct = TF.kmeans_pp_landmarks(_t(clustered), n_landmarks, draws=draws).numpy()
    np.testing.assert_allclose(ct, cj, **TOL)
    phi_j = np.asarray(JF.landmark_features(key, jnp.asarray(clustered), n_landmarks))
    phi_t = TF.landmark_features(_t(clustered), n_landmarks, draws=draws).numpy()
    assert phi_t.shape == (400, n_landmarks)
    np.testing.assert_allclose(phi_t, phi_j, **TOL)


@pytest.mark.parametrize("k", [10, 20])
def test_feature_fl_greedy_indices_equal_reference(clustered, k):
    key = jax.random.PRNGKey(0)
    L = TF.default_landmarks(len(clustered), k)
    sel_j = JF.feature_greedy_select(key, jnp.asarray(clustered), k)
    assert sel_j.phi.shape[1] == L
    sel_t = TF.feature_greedy_select(clustered, k, device="cpu",
                                     draws=reference_draws(key, len(clustered), L))
    np.testing.assert_array_equal(sel_t.indices.numpy(), np.asarray(sel_j.indices))
    np.testing.assert_allclose(sel_t.phi.numpy(), np.asarray(sel_j.phi), **TOL)


def test_feature_graph_cut_greedy_indices_equal_reference(clustered):
    key = jax.random.PRNGKey(0)
    z = clustered[:64]
    phi_j = JF.landmark_features(key, jnp.asarray(z), 16)
    phi_t = TF.landmark_features(_t(z), 16, draws=reference_draws(key, 64, 16))
    res_j = j_greedy(JF.feature_graph_cut, phi_j, 10)
    res_t = greedy(TF.feature_graph_cut, phi_t, 10)
    np.testing.assert_array_equal(res_t.indices.numpy(), np.asarray(res_j.indices))
    np.testing.assert_allclose(res_t.gains.numpy(), np.asarray(res_j.gains), rtol=1e-5,
                               atol=1e-4)
    assert np.all(np.diff(res_t.gains.numpy()) <= 1e-3), "diminishing returns along greedy"


def test_feature_fl_near_exact_objective(clustered):
    """The reference's bound: landmark-FL greedy recovers >= 90% of the exact
    facility-location value of exact greedy (on the port's own draws)."""
    k = 20
    z = _t(clustered)
    K = gram_matrix(z)
    exact = greedy(facility_location, K, k).indices
    m_exact = torch.zeros(len(z), dtype=torch.bool)
    m_exact[exact] = True
    v_exact = float(facility_location.evaluate(m_exact, K))
    for seed in (0, 1, 2):
        sel = TF.feature_greedy_select(z, k, seed=seed, device="cpu")
        assert len(set(sel.indices.tolist())) == k
        m_feat = torch.zeros(len(z), dtype=torch.bool)
        m_feat[sel.indices] = True
        v_feat = float(facility_location.evaluate(m_feat, K))
        assert v_feat >= 0.9 * v_exact, (seed, v_feat, v_exact)
    # the reference scores the same subsets the same way
    mj = np.zeros(len(z), bool)
    mj[exact.numpy()] = True
    np.testing.assert_allclose(v_exact, float(j_fl.evaluate(jnp.asarray(mj), j_gram(
        jnp.asarray(clustered)))), rtol=1e-5)


@pytest.mark.parametrize("name", ["facility_location", "graph_cut"])
def test_feature_gains_equal_evaluate_deltas(clustered, name):
    """Incremental gains equal evaluate-deltas on the Φ ground set."""
    fn = TF.feature_facility_location if name == "facility_location" else TF.feature_graph_cut
    phi = TF.landmark_features(_t(clustered[:64]), 16, seed=0)
    state = fn.init(phi, 1)
    mask = torch.zeros(64, dtype=torch.bool)
    rng = np.random.default_rng(0)
    for j in rng.permutation(64)[:8]:
        gains = fn.gains(state, phi)[0]
        before = float(fn.evaluate(mask, phi))
        mask[j] = True
        after = float(fn.evaluate(mask, phi))
        np.testing.assert_allclose(float(gains[j]), after - before, rtol=1e-4, atol=1e-4)
        state = fn.update(state, phi, torch.tensor([int(j)]))


def test_set_function_values_match_reference(clustered):
    """init/gains/update/evaluate against the reference on one Φ."""
    phi_np = np.asarray(JF.landmark_features(jax.random.PRNGKey(3), jnp.asarray(clustered), 24))
    phi = _t(phi_np)
    mask = np.zeros(400, bool)
    mask[[3, 50, 77, 301]] = True
    for jfn, tfn in ((JF.feature_facility_location, TF.feature_facility_location),
                     (JF.feature_graph_cut, TF.feature_graph_cut)):
        sj, st = jfn.init(jnp.asarray(phi_np)), tfn.init(phi, 1)
        for j in (3, 50, 77):
            sj = jfn.update(sj, jnp.asarray(phi_np), jnp.asarray(j))
            st = tfn.update(st, phi, torch.tensor([j]))
        np.testing.assert_allclose(tfn.gains(st, phi)[0].numpy(),
                                   np.asarray(jfn.gains(sj, jnp.asarray(phi_np))),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(float(tfn.evaluate(torch.as_tensor(mask), phi)),
                                   float(jfn.evaluate(jnp.asarray(mask), jnp.asarray(phi_np))),
                                   rtol=1e-5)
    empty = torch.zeros(400, dtype=torch.bool)
    assert float(TF.feature_facility_location.evaluate(empty, phi)) == 0.0


def test_own_draws_follow_kmeans_pp_distribution():
    """The port's generator path: the first centre is uniform and the second
    is drawn with probability proportional to its squared distance from the
    first (checked over 3,000 seeds on 5 points)."""
    z = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 2.0], [3.0, 3.0], [-1.0, 0.5]])
    m = len(z)
    counts = np.zeros((m, m))
    for seed in range(3000):
        c = TF.kmeans_pp_landmarks(z, 2, n_iters=0, seed=seed)
        f = int(torch.nonzero((z == c[0]).all(dim=1))[0])
        s = int(torch.nonzero((z == c[1]).all(dim=1))[0])
        counts[f, s] += 1
    first = counts.sum(1) / counts.sum()
    np.testing.assert_allclose(first, 1 / m, atol=0.03)
    d2 = ((z[:, None] - z[None]) ** 2).sum(-1).numpy()
    for f in range(m):
        p = d2[f] / d2[f].sum()
        np.testing.assert_allclose(counts[f] / counts[f].sum(), p, atol=0.06)
        assert counts[f, f] == 0


def test_lloyd_blocks_equal_the_whole_tensor(clustered, monkeypatch):
    """Lloyd's step in row blocks assigns exactly as over the whole (m, L, d)
    difference tensor, and so gives the same centres."""
    z = _t(clustered)
    centers = z[::25].clone()
    whole = ((z[:, None] - centers[None]) ** 2).sum(-1).argmin(-1)
    monkeypatch.setattr(TF, "_LLOYD_ELEMENTS", 7 * len(centers) * z.shape[1])
    np.testing.assert_array_equal(TF._lloyd_assign(z, centers).numpy(), whole.numpy())
    blocked = TF.kmeans_pp_landmarks(z, 16, seed=4)
    monkeypatch.setattr(TF, "_LLOYD_ELEMENTS", 1 << 27)
    assert torch.equal(blocked, TF.kmeans_pp_landmarks(z, 16, seed=4))


def test_memory_scaling_and_draw_shapes():
    """Φ is m x L, not m x m; the draw seam checks its shapes."""
    m, L = 2048, 64
    z = torch.as_tensor(np.random.default_rng(0).normal(size=(m, 24)), dtype=torch.float32)
    phi = TF.landmark_features(z, L, seed=0)
    assert tuple(phi.shape) == (m, L)
    assert m * m // phi.numel() == m // L
    with pytest.raises(ValueError, match="noise has shape"):
        TF.kmeans_pp_landmarks(z, L, draws=(0, np.zeros((L, m), np.float32)))


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        TF.feature_greedy_select(np.zeros((8, 4), np.float32), 2)
