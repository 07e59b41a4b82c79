"""Port parity of ``repro_torch.core.gram_free`` against ``repro.core.gram_free``:
every factory's ``init``, ``gains``, ``gains_at``, ``update`` and ``evaluate``,
the query facility location, the padding contract, and the greedy / SGE
trajectories on the gram-free route.

Both packages get the same row-normalised features (made with numpy, handed
over as arrays), so the only differences left are the order of fp32
reductions: gains within rtol 1e-6 / atol 1e-5 (a few fp32 ulps of gains
≤ n/2), and the reference runs its facility location through the Pallas
kernels in interpret mode where the port runs the kernels' plain versions.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.similarity import gram_matrix
from repro_torch.core import gram_free as tgf
from repro_torch.core import greedy as tg
from repro_torch.core import submodular as ts

torch.set_num_threads(1)

jgf = importlib.import_module("repro.core.gram_free")
jg = importlib.import_module("repro.core.greedy")
js = importlib.import_module("repro.core.submodular")

FNS = ["facility_location", "graph_cut", "disparity_sum", "disparity_min"]
TOL = dict(rtol=1e-6, atol=1e-5)


def _feats(n: int, d: int = 16, seed: int = 0, n_pad: int | None = None) -> np.ndarray:
    z = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    if n_pad is not None:
        z = np.concatenate([z, np.zeros((n_pad - n, d), np.float32)])
    return z


def _pair(name: str, **kw):
    if name == "facility_location":
        return (jgf.make_gram_free_facility_location(use_pallas=True, interpret=True,
                                                     block_i=64, block_j=64),
                tgf.make_gram_free_facility_location(use_pallas=True))
    return jgf.get_gram_free(name, **kw), tgf.get_gram_free(name, **kw)


def _state_np(state, port_state):
    """The reference's state by the port's keys (a bare array is the port's
    one tensor: ``c`` or ``cur``); the host-side ``size`` is not compared."""
    if isinstance(state, dict):
        return {k: np.asarray(v) for k, v in state.items() if k != "size"}
    (key,) = port_state
    return {key: np.asarray(state)}


@pytest.mark.parametrize("name", FNS)
@pytest.mark.parametrize("padded", [False, True])
def test_factory_steps_match_reference(name, padded):
    """init → (gains, gains_at, update) × 6 → evaluate, on the same picks."""
    n_pad = 96 if padded else None
    zn = _feats(80, seed=1, n_pad=n_pad)
    n = zn.shape[0]
    fj, ft = _pair(name)
    zj, zt = jnp.asarray(zn), torch.from_numpy(zn)
    sj, st = fj.init(zj), ft.init(zt, 1)
    for key, val in _state_np(sj, st).items():
        np.testing.assert_allclose(st[key][0].numpy() if st[key].dim() > 1 else st[key].numpy(),
                                   val, **TOL, err_msg=f"{name} init {key}")
    rng = np.random.default_rng(2)
    for j in (3, 41, 77, 0, 41, 12):
        np.testing.assert_allclose(ft.gains(st, zt)[0].numpy(), np.asarray(fj.gains(sj, zj)),
                                   **TOL, err_msg=name)
        cand = rng.integers(0, n, size=9)
        got = ts.gains_at(ft, st, zt, torch.from_numpy(cand)[None])[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(js.gains_at(fj, sj, zj, jnp.asarray(cand))),
                                   **TOL, err_msg=name)
        # the port's own gains_at equals its gathered gains bit for bit
        assert torch.equal(got, ft.gains(st, zt)[0][torch.from_numpy(cand)]), name
        sj, st = fj.update(sj, zj, jnp.asarray(j)), ft.update(st, zt, torch.tensor([j]))
    mask = np.zeros(n, bool)
    mask[[3, 41, 77, 12]] = True
    ref = float(fj.evaluate(jnp.asarray(mask), zj))
    assert float(ft.evaluate(torch.from_numpy(mask), zt)) == pytest.approx(ref, rel=1e-5, abs=1e-5)


def test_padding_contract():
    """All-zero rows: facility location pins their cover at +inf, graph-cut
    zeroes their column sums and diagonal, and no padding row ever gains."""
    zn = _feats(50, seed=3, n_pad=64)
    zt = torch.from_numpy(zn)
    fl = tgf.make_gram_free_facility_location()
    c = fl.init(zt, 2)["c"]
    assert c.shape == (2, 64) and torch.isinf(c[:, 50:]).all() and (c[:, :50] == 0).all()
    assert (fl.gains(fl.init(zt, 1), zt)[0] > 0).all(), "padding candidates still score"
    gc = tgf.make_gram_free_graph_cut(0.4).init(zt, 1)
    assert not gc["colsum"][50:].any() and not gc["diag"][50:].any()
    valid = torch.arange(64) < 50
    imp = tg.greedy_importance(fl, zt, valid=valid, lazy_budget=8).numpy()
    assert not imp[50:].any() and (imp[:50] > 0).all()


def test_query_facility_location_matches_reference():
    zn = _feats(70, seed=4, n_pad=80)
    zq = _feats(6, seed=5)
    fj = jgf.make_query_facility_location(zq)
    ft = tgf.make_query_facility_location(zq)
    zj, zt = jnp.asarray(zn), torch.from_numpy(zn)
    sj, st = fj.init(zj), ft.init(zt, 2)
    assert st["c"].shape == (2, 6)
    for j in (5, 60, 5, 33):
        g = ft.gains(st, zt)
        np.testing.assert_allclose(g[1].numpy(), np.asarray(fj.gains(sj, zj)), **TOL)
        assert not g[:, 70:].any(), "padding rows gain exactly 0"
        cand = torch.tensor([[1, 75, 60], [2, 3, 4]])
        np.testing.assert_allclose(ft.gains_at(st, zt, cand)[0].numpy(),
                                   np.asarray(fj.gains_at(sj, zj, jnp.asarray([1, 75, 60]))), **TOL)
        sj = fj.update(sj, zj, jnp.asarray(j))
        st = ft.update(st, zt, torch.tensor([j, j]))
    mask = np.zeros(80, bool)
    mask[[5, 60, 33]] = True
    assert float(ft.evaluate(torch.from_numpy(mask), zt)) == pytest.approx(
        float(fj.evaluate(jnp.asarray(mask), zj)), rel=1e-6)
    res_j = jg.greedy(fj, zj, 10)
    res_t = tg.greedy(ft, zt, 10)
    np.testing.assert_array_equal(res_t.indices.numpy(), np.asarray(res_j.indices))


def test_get_gram_free_names():
    for name in FNS:
        assert tgf.get_gram_free(name).name == "gram_free_" + name
    assert tgf.get_gram_free("graph_cut", lam=0.3).gains_at is not None
    with pytest.raises(KeyError, match="no gram-free variant"):
        tgf.get_gram_free("log_determinant")


@pytest.mark.parametrize("name", FNS)
def test_gram_free_greedy_matches_reference_and_gram_route(name):
    """Greedy over features picks what the reference picks over features,
    and what the port picks over the materialised Gram."""
    zn = _feats(160, d=24, seed=7)
    fj, ft = _pair(name)
    ref = jg.greedy(fj, jnp.asarray(zn), 16)
    out = tg.greedy(ft, torch.from_numpy(zn), 16)
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(ref.indices), err_msg=name)
    np.testing.assert_allclose(out.gains.numpy(), np.asarray(ref.gains), **TOL)
    K = torch.from_numpy(np.asarray(gram_matrix(jnp.asarray(zn))))
    dense = tg.greedy(ts.get(name), K, 16)
    np.testing.assert_array_equal(out.indices.numpy(), dense.indices.numpy(), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gram_free_sge_bank_index_exact(seed):
    """The paper's easy function, gram-free, bucketed, with the reference's
    draws injected: the bank is index-exact."""
    from tests.test_torch_greedy import sge_draws

    zn = _feats(200, seed=20 + seed, n_pad=256)
    valid = np.arange(256) < 200
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jg.sge(jgf.make_gram_free_graph_cut(0.4), jnp.asarray(zn), 32, key,
                            n_subsets=4, valid=jnp.asarray(valid)))
    out = tg.sge(tgf.make_gram_free_graph_cut(0.4), torch.from_numpy(zn), 32, n_subsets=4,
                 valid=torch.from_numpy(valid), noise=sge_draws(key, 4, 32, 256)).numpy()
    diff = np.argwhere(out != ref)
    assert not len(diff), f"bank parts from the reference at (run, step) {diff[0].tolist()}"
