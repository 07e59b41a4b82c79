"""The port's sharded selection (``repro_torch.core.sharded``) on gloo CPU
processes against the JAX reference.

One launch per world size (W = 2, and W = 8, the reference's fixture mesh)
starts W processes with the port's ``testing.faults.launch_hosts``; every
rank runs every case of ``CHILD`` on the fixtures of
``tests/test_sharded.py`` (features normalised by the reference, the
reference's Gumbel draws fed through the ``noise=`` / ``sge_noise=``
seams) and writes its results to an npz.  The tests hold them against the
live reference's single-device engines, run here:

  * indices exact for greedy over the four set functions, stochastic greedy
    and the SGE bank, disparity-min importance (gains bit-exact), graph-cut
    ``refine``, the preprocessor and ``milo_fixed``; facility-location gains
    at rtol 1e-6;
  * the lazy facility-location cases by the near-tie rule
    (``_near_tie_check``): the cached gains carry the ring sum's ulps, so a
    trajectory may part from the reference's only at a near-tie of exact
    gains; past it the sorted importance is compared;
  * the ring's W − 1 hops per full evaluation, the divisibility refusal,
    rows per rank, two-level gathers bit-identical with a smaller payload,
    every rank's results equal (replicated), compression and its integrity
    check.

One more test runs the reference's own ``sharded_*`` under
``--xla_force_host_platform_device_count=W`` in a subprocess, on cases that
pass there, and compares disparity gains bit for bit.
"""
from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.partition import ByClass, proportional_budgets
from repro.core.similarity import normalize_rows
from repro_torch.core import gram_free as tgf
from repro_torch.core import greedy as tg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
jg = importlib.import_module("repro.core.greedy")
jgf = importlib.import_module("repro.core.gram_free")

CHILD_ENV = {"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
NAMES = ["facility_location", "graph_cut", "disparity_sum", "disparity_min"]
LAZY_CASES = [(256, 0, False), (256, 1, False), (128, 3, False), (128, 4, True)]
SIZES = [97, 83, 70, 45, 5]      # the reference's preprocessor fixture
ULP = float(np.spacing(np.float32(1.0)))


def _fixture(n: int, d: int = 16, seed: int = 0) -> np.ndarray:
    """``tests/test_sharded.py``'s fixture, normalised by the reference."""
    rng = np.random.default_rng(seed)
    return np.array(normalize_rows(jnp.asarray(rng.normal(size=(n, d)).astype(np.float32))))


def _draws(key, k: int, n: int) -> np.ndarray:
    """The reference's stochastic-greedy draws: split(key, k), gumbel (n,)."""
    return np.asarray(jax.vmap(lambda kt: jax.random.gumbel(kt, (n,)))(jax.random.split(key, k)))


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _prep_data():
    rng = np.random.default_rng(14)
    labels = np.concatenate([np.full(s, i) for i, s in enumerate(SIZES)])
    feats = rng.normal(size=(len(labels), 12)).astype(np.float32)
    return feats, labels


def _prep_noise(labels, key, n_subsets: int = 8) -> list[np.ndarray]:
    """The reference preprocessor's per-class SGE draws (bucketed), from
    ``key``: ``key, k_sge = split(key)`` per class, then the bank's."""
    parts = ByClass().partition(labels, len(labels))
    budgets = proportional_budgets(parts, max(1, round(0.1 * len(labels))))
    out = []
    for part, k_c in zip(parts, budgets):
        key, k_sge = jax.random.split(key)
        n_run = _next_pow2(len(part.indices))
        k_run = min(n_run, _next_pow2(k_c))
        out.append(np.stack([_draws(kk, k_run, n_run)
                             for kk in jax.random.split(k_sge, n_subsets)]))
    return out


PREP_CASES = (("prep", dict(gram_free=True)),
              ("prep_lazy", dict(gram_free=True, lazy_gains=True, hard_fn="facility_location")))

# the cases every rank runs; inputs from inp.npz, outputs to out.<rank>.npz
CHILD = f"PREP_CASES = {PREP_CASES!r}\n" + r"""
import sys
import numpy as np, torch
torch.set_num_threads(1)
inp_path, out_path = sys.argv[1:3]
from repro_torch.distributed import multihost
assert multihost.initialize(timeout=60.0, device="cpu")
from repro_torch.core import greedy as GR, sharded as S
from repro_torch.core.milo import MiloPreprocessor
from repro_torch.distributed.compression import CompressionIntegrityError
from repro_torch.distributed.sharding import selection_mesh
from repro_torch.selection import build_selector
from repro_torch.testing import faults

inp = dict(np.load(inp_path))
mesh = selection_mesh()
W, me = mesh.size, mesh.rank
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
out = {"W": np.int64(W), "backend": np.array(mesh.backend)}
fn = lambda name, **kw: S.make_sharded_gram_free(name, mesh=mesh, **kw)

z0 = T(inp["z0"])
for name in ["facility_location", "graph_cut", "disparity_sum", "disparity_min"]:
    r = S.sharded_greedy(fn(name), z0, 24, mesh=mesh)
    out[f"greedy_{name}_idx"], out[f"greedy_{name}_gains"] = r.indices.numpy(), r.gains.numpy()
    # the refine (the hierarchical level-1 pass) through its own entry point
    r = S.sharded_refine(fn(name), z0, 32, mesh=mesh)
    out[f"refine_{name}_idx"] = r.indices.numpy()

z1 = T(inp["z1"])
for name in ["facility_location", "graph_cut"]:
    r = S.sharded_stochastic_greedy(fn(name), z1, 20, s=int(inp["s1"]), mesh=mesh,
                                    noise=inp["noise1"])
    out[f"stoch_{name}_idx"] = r.indices.numpy()
    out[f"bank_{name}"] = S.sharded_sge(fn(name), z1, 20, n_subsets=3, mesh=mesh,
                                        noise=inp["bank1"]).numpy()

valid2 = torch.arange(256) < 200
out["imp_dmin"] = S.sharded_greedy_importance(fn("disparity_min"), T(inp["z2p"]), mesh=mesh,
                                              valid=valid2).numpy()
z3 = T(inp["z3"])
out["imp_fl"] = S.sharded_greedy_importance(fn("facility_location"), z3, mesh=mesh).numpy()
# the lazy WRE pass, its trajectory recorded as the engine returns it
passes = []
lazy = GR.lazy_greedy
GR.lazy_greedy = lambda *a, **kw: passes.append(lazy(*a, **kw)) or passes[-1]
out["imp_fl_lazy"] = S.sharded_greedy_importance(fn("facility_location"), z3, mesh=mesh,
                                                 lazy_budget=16).numpy()
GR.lazy_greedy = lazy
out["lazy_full_idx"] = passes[0].indices.numpy()

for n, seed, masked in [(256, 0, False), (256, 1, False), (128, 3, False), (128, 4, True)]:
    z = T(inp[f"lz_{n}_{seed}"])
    valid = (torch.arange(n) < n - n // 4) if masked else None
    mesh.reset_counts()
    r = S.sharded_lazy_greedy(fn("facility_location"), z, n // 4, budget=n // 8, mesh=mesh,
                              valid=valid)
    tag = f"lazy_{n}_{seed}"
    out[tag + "_idx"], out[tag + "_gains"] = r.indices.numpy(), r.gains.numpy()
    out[tag + "_rows"] = r.rows_evaluated.numpy()
    out[tag + "_hops"] = np.int64(mesh.hops)

# one full facility-location evaluation: exactly W - 1 ring hops
z5 = T(inp["z5"])
zl = multihost.global_put(z5, mesh, (mesh.axis, None)).local
fl = fn("facility_location")
st = fl.init(zl, 1)
mesh.reset_counts()
out["full_gains"] = fl.gains(st, zl)[0].numpy()
out["full_gains_hops"] = np.int64(mesh.hops)
out["staged"] = np.array([mesh.staged_calls, mesh.staged_bytes])

# two-level gathers: bit-identical, smaller payload
z6 = T(inp["z6"])
a = S.sharded_lazy_greedy(fn("facility_location"), z6, 256, budget=32, mesh=mesh)
b = S.sharded_lazy_greedy(fn("facility_location"), z6, 256, budget=32, mesh=mesh, two_level=True)
for tag, r in (("tl_single", a), ("tl_two", b)):
    out[tag + "_idx"], out[tag + "_gains"] = r.indices.numpy(), r.gains.numpy()
    out[tag + "_rows"] = r.rows_evaluated.numpy()
z7 = T(inp["z7"])
out["imp_two_level"] = S.sharded_greedy_importance(fn("facility_location"), z7, mesh=mesh,
                                                   lazy_budget=16, lazy_two_level=True).numpy()

# the padding never selected (the generator path)
z4 = T(inp["z4p"])
gen = torch.Generator().manual_seed(5)
out["valid_bank"] = S.sharded_sge(fn("graph_cut"), z4, 9, n_subsets=4, mesh=mesh,
                                  valid=torch.arange(128) < 96, generator=gen).numpy()

# rows per rank: a RowShard placed by global_put runs unchanged
zs = multihost.global_put(T(inp["z8"]), mesh, (mesh.axis, None))
out["rows_per_rank"] = np.array(zs.local.shape)
out["rowshard_idx"] = S.sharded_greedy(fn("disparity_min"), zs, 16, mesh=mesh).indices.numpy()

# the divisibility refusal and the mesh's own checks
try:
    S.sharded_greedy(fn("graph_cut"), T(inp["z129"]), 8, mesh=mesh)
    out["refusal"] = np.array("")
except ValueError as e:
    out["refusal"] = np.array(str(e))
half = selection_mesh(max(1, W // 2))
out["mesh_sizes"] = np.array([selection_mesh().shape["sel"], half.size])
try:
    selection_mesh(10**6)
    out["mesh_refusal"] = np.array("")
except ValueError as e:
    out["mesh_refusal"] = np.array(str(e))

# the preprocessor, flat and lazy, sharded (the reference's draws)
feats, labels = inp["prep_x"], inp["prep_y"]
noise = [inp[f"prep_noise_{i}"] for i in range(int(inp["prep_n"]))]
for tag, kw in PREP_CASES:
    md = MiloPreprocessor(subset_fraction=0.1, shard_selection=True, device="cpu",
                          **kw).preprocess(feats, labels, 0, sge_noise=noise)
    out[tag + "_sge"], out[tag + "_imp"] = md.sge_subsets, md.wre_importance
    out[tag + "_probs"] = md.wre_probs
    out[tag + "_flag"] = np.array(md.config["shard_selection"])

out["milo_fixed"] = build_selector("milo_fixed", features=inp["mf_x"], k=24,
                                   shard_selection=True, device="cpu").plan(0).indices

# compression: a compressed run, then one corrupted payload
fc = fn("facility_location", compress="int8", compress_rounds=2)
for tag in ("z0", "zmh"):
    r = S.sharded_greedy(fc, T(inp[tag]), 24, mesh=mesh)
    out[f"c8_{tag}_idx"], out[f"c8_{tag}_gains"] = r.indices.numpy(), r.gains.numpy()
# the compressed sum alone, on given per-rank partials (B runs a rank)
for rounds in (1, 2, 3):
    out[f"c8_sum_r{rounds}"] = S._compressed_psum(mesh, T(inp["c8_parts"][me]),
                                                  rounds=rounds).numpy()
S.payload_hook = faults.flip_payload_byte(at_call=S._payload_calls + 3, process=W - 1, index=5)
try:
    S.sharded_greedy(fc, z0, 24, mesh=mesh)
    out["corrupt"] = np.array("no error")
except CompressionIntegrityError as e:
    out["corrupt"] = np.array(type(e).__name__)
out["corrupt_fired"] = np.int64(S.payload_hook.fired)
S.payload_hook = None

np.savez(f"{out_path}.{me}.npz", **out)
print("SHARDED_DONE", me, flush=True)
"""


def _inputs(path: Path) -> dict:
    key7 = jax.random.PRNGKey(7)
    n1, k1 = 256, 20
    inp = {
        "z0": _fixture(256), "z1": _fixture(256, seed=1), "z3": _fixture(128, seed=3),
        "z5": _fixture(256, seed=5), "z6": _fixture(256, seed=6), "z7": _fixture(128, seed=7),
        "z8": _fixture(512, seed=5), "z129": _fixture(129, seed=6),
        # the two-process selection fixture of tests/test_multihost.py
        "zmh": np.array(normalize_rows(jnp.asarray(
            np.random.default_rng(0).normal(size=(256, 16)).astype(np.float32)))),
        # per-rank partial gains for the compressed sum: (rank, run, n),
        # the first W ranks' rows used
        "c8_parts": (np.random.default_rng(21).exponential(size=(8, 3, 256))
                     * np.array([1.0, 10.0, 0.01])[:, None]).astype(np.float32),
        "s1": np.int64(jg.stochastic_candidate_count(n1, k1, 0.01)),
        "noise1": _draws(key7, k1, n1),
        "bank1": np.stack([_draws(kk, k1, n1) for kk in jax.random.split(key7, 3)]),
    }
    z2 = _fixture(256, seed=2)
    z2[200:] = 0.0
    inp["z2p"] = z2
    z4 = _fixture(128, seed=4)
    z4[96:] = 0.0
    inp["z4p"] = z4
    for n, seed, masked in LAZY_CASES:
        z = _fixture(n, seed=seed)
        if masked:
            z[n - n // 4:] = 0.0
        inp[f"lz_{n}_{seed}"] = z
    feats, labels = _prep_data()
    noise = _prep_noise(labels, jax.random.PRNGKey(0))
    inp.update(prep_x=feats, prep_y=labels, prep_n=np.int64(len(noise)),
               mf_x=np.random.default_rng(15).normal(size=(256, 12)).astype(np.float32))
    inp.update({f"prep_noise_{i}": a for i, a in enumerate(noise)})
    np.savez(path, **inp)
    return inp


@pytest.fixture(scope="module", params=[2, 8], ids=lambda w: f"W{w}")
def run(request, tmp_path_factory):
    from repro_torch.testing.faults import launch_hosts

    W = request.param
    tmp = tmp_path_factory.mktemp(f"sharded_w{W}")
    inp = _inputs(tmp / "inp.npz")
    t0 = time.perf_counter()
    # 8 processes take ~30 s alone and several times that beside the suite's
    # other workers (every collective waits for all 8 to be scheduled)
    res = launch_hosts(CHILD, [str(tmp / "inp.npz"), str(tmp / "out")], num_processes=W,
                       env=CHILD_ENV, cwd=str(ROOT), timeout=120.0 if W == 2 else 400.0)
    seconds = time.perf_counter() - t0
    for r in res:
        assert r.returncode == 0, (r.process_id, r.stderr[-3000:])
        assert "SHARDED_DONE" in r.stdout
    outs = []
    for i in range(W):
        with np.load(tmp / f"out.{i}.npz") as f:
            outs.append({k: f[k] for k in f.files})
    return {"W": W, "inp": inp, "out": outs[0], "ranks": outs, "seconds": seconds}


def _near_tie_check(out_idx, ref_idx, z: np.ndarray, valid_n: int | None = None) -> int:
    """The lazy rule: the picks are the reference's up to the first parting,
    and there the two picks' exact facility-location gains (float64, given
    the picks before) are a near-tie: within rtol 1e-5 plus 4 fp32 ulps of
    the first gain.  Returns the parting step (len when none)."""
    out_idx, ref_idx = np.asarray(out_idx), np.asarray(ref_idx)
    parted = np.nonzero(out_idx != ref_idx)[0]
    t = int(parted[0]) if len(parted) else len(ref_idx)
    if t < len(ref_idx):
        g = z.astype(np.float64)
        live = np.linalg.norm(g, axis=1) > 0
        sim = lambda idx: np.where(live[:, None], 0.5 + 0.5 * g @ g[np.asarray(idx)].T, 0.0)  # noqa: E731
        cover = sim(ref_idx[:t]).max(axis=1) if t else np.zeros(len(g))
        gain = lambda j: float(np.maximum(sim([j])[:, 0] - cover, 0.0).sum())  # noqa: E731
        ga, gb = gain(ref_idx[t]), gain(out_idx[t])
        first = gain(ref_idx[0]) if t else max(ga, gb)
        tol = 1e-5 * max(ga, gb) + 4 * float(np.spacing(np.float32(first)))
        assert abs(ga - gb) <= tol, f"pick {t}: gains {ga} and {gb} are no near-tie (tol {tol})"
    return t


def test_every_rank_holds_the_same_results(run):
    """The results are replicated by construction: every rank's are the
    same bits, and the backend is gloo on the CPU."""
    assert int(run["out"]["W"]) == run["W"] and str(run["out"]["backend"]) == "gloo"
    for other in run["ranks"][1:]:
        for k, v in run["out"].items():
            if k != "corrupt_fired":   # the one rank whose payload was flipped
                np.testing.assert_array_equal(v, other[k], err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_greedy_matches_reference(run, name):
    z = jnp.asarray(run["inp"]["z0"])
    ref = jg.greedy(jgf.get_gram_free(name), z, 24)
    out = run["out"]
    np.testing.assert_array_equal(out[f"greedy_{name}_idx"], np.asarray(ref.indices))
    if name.startswith("disparity"):
        # no cross-rank arithmetic: the port's single-device gains, bit for bit
        one = tg.greedy(tgf.get_gram_free(name), torch.from_numpy(run["inp"]["z0"]), 24)
        np.testing.assert_array_equal(out[f"greedy_{name}_gains"], one.gains.numpy())
    np.testing.assert_allclose(out[f"greedy_{name}_gains"], np.asarray(ref.gains),
                               rtol=1e-6, atol=4 * ULP)
    want = jg.refine(jgf.get_gram_free(name), z, 32)
    if name == "facility_location":
        _near_tie_check(out[f"refine_{name}_idx"], np.asarray(want.indices), run["inp"]["z0"])
    else:
        np.testing.assert_array_equal(out[f"refine_{name}_idx"], np.asarray(want.indices))


@pytest.mark.parametrize("name", ["facility_location", "graph_cut"])
def test_sharded_stochastic_greedy_and_bank_match_reference(run, name):
    inp, out = run["inp"], run["out"]
    z, key = jnp.asarray(inp["z1"]), jax.random.PRNGKey(7)
    fn = jgf.get_gram_free(name)
    a = jg.stochastic_greedy(fn, z, 20, key, s=int(inp["s1"]))
    np.testing.assert_array_equal(out[f"stoch_{name}_idx"], np.asarray(a.indices))
    bank = jg.sge(fn, z, 20, key, n_subsets=3)
    np.testing.assert_array_equal(out[f"bank_{name}"], np.asarray(bank))


def test_sharded_importance_matches_reference(run):
    """Disparity-min importance over a bucketed valid mask: the port's
    single-device importance bit for bit, the reference's at the port's
    parity tolerance (torch's and XLA's products differ in last bits);
    facility location (eager) at the reference's tolerance."""
    inp, out = run["inp"], run["out"]
    a = jg.greedy_importance(jgf.get_gram_free("disparity_min"), jnp.asarray(inp["z2p"]),
                             valid=jnp.arange(256) < 200)
    one = tg.greedy_importance(tgf.get_gram_free("disparity_min"), torch.from_numpy(inp["z2p"]),
                               valid=torch.arange(256) < 200)
    np.testing.assert_array_equal(out["imp_dmin"], one.numpy())
    np.testing.assert_allclose(out["imp_dmin"], np.asarray(a), rtol=1e-6, atol=4 * ULP)
    assert not out["imp_dmin"][200:].any()
    b = jg.greedy_importance(jgf.get_gram_free("facility_location"), jnp.asarray(inp["z3"]))
    np.testing.assert_allclose(out["imp_fl"], np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("n,seed,masked", LAZY_CASES)
def test_sharded_lazy_greedy_by_the_near_tie_rule(run, n, seed, masked):
    """Shortlist-horizon lazy runs: up to the first parting (a near-tie)
    the indices, ``rows_evaluated`` and gains (rtol 1e-6) are the
    reference's; the delta path really ran (some step gathered the
    budget) and every full evaluation made W - 1 hops."""
    z = run["inp"][f"lz_{n}_{seed}"]
    valid = jnp.arange(n) < n - n // 4 if masked else None
    ref = jg.lazy_greedy(jgf.get_gram_free("facility_location"), jnp.asarray(z), n // 4,
                         budget=n // 8, valid=valid)
    tag = f"lazy_{n}_{seed}"
    out = run["out"]
    t = _near_tie_check(out[tag + "_idx"], np.asarray(ref.indices), z)
    np.testing.assert_array_equal(out[tag + "_rows"][:t], np.asarray(ref.rows_evaluated)[:t])
    np.testing.assert_allclose(out[tag + "_gains"][:t], np.asarray(ref.gains)[:t],
                               rtol=1e-6, atol=1e-6)
    rows = out[tag + "_rows"]
    assert (rows == n // 8).any()
    # the first evaluation and every full recompute: W - 1 hops each
    assert int(out[tag + "_hops"]) == (run["W"] - 1) * (1 + int((rows == n).sum()))


def test_sharded_lazy_importance_full_run(run):
    """The composed WRE pass (lazy budget 16): its full-pass trajectory
    parts from the reference's only at a near-tie; the sorted importance is
    the reference's within its full-pass tolerance, zeros where its are."""
    inp, out = run["inp"], run["out"]
    fn = jgf.get_gram_free("facility_location")
    z = jnp.asarray(inp["z3"])
    ref_traj = jg.lazy_greedy(fn, z, 128, budget=16)
    _near_tie_check(out["lazy_full_idx"], np.asarray(ref_traj.indices), inp["z3"])
    for key, z_key, kw in (("imp_fl_lazy", "z3", {}), ("imp_two_level", "z7",
                                                       {"lazy_two_level": True})):
        ref = np.asarray(jg.greedy_importance(fn, jnp.asarray(inp[z_key]), lazy_budget=16, **kw))
        np.testing.assert_allclose(np.sort(out[key]), np.sort(ref), rtol=1e-4, atol=1e-5)
        assert ((out[key] == 0.0) == (ref == 0.0)).all()


def test_ring_makes_exactly_w_minus_one_hops(run):
    out = run["out"]
    assert int(out["full_gains_hops"]) == run["W"] - 1
    fn1 = jgf.get_gram_free("facility_location")
    z = jnp.asarray(run["inp"]["z5"])
    np.testing.assert_allclose(out["full_gains"], np.asarray(fn1.gains(fn1.init(z), z)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(out["staged"], [0, 0])   # CPU tensors: nothing staged


def test_two_level_gathers_bit_identical_with_a_smaller_payload(run):
    """On the port's sharded path the two-level gather is bit-identical to
    the single-level one — indices AND gains (the reference's forced-8 run
    parts by 1 ulp here) — with a smaller gathered block."""
    out, n, budget = run["out"], 256, 32
    np.testing.assert_array_equal(out["tl_single_idx"], out["tl_two_idx"])
    np.testing.assert_array_equal(out["tl_single_gains"], out["tl_two_gains"])
    ra, rb = out["tl_single_rows"], out["tl_two_rows"]
    np.testing.assert_array_equal(ra == n, rb == n)
    lazy_a, lazy_b = ra[ra < n], rb[rb < n]
    assert np.all(lazy_a == budget)
    assert set(lazy_b.tolist()) <= set(jg._gather_levels(budget))
    assert lazy_b.sum() < lazy_a.sum()


def test_valid_mask_rows_per_rank_and_refusals(run):
    out, W = run["out"], run["W"]
    subs = out["valid_bank"]
    assert subs.max() < 96 and all(len(set(r.tolist())) == 9 for r in subs)
    np.testing.assert_array_equal(out["rows_per_rank"], [512 // W, 16])
    ref = jg.greedy(jgf.get_gram_free("disparity_min"), jnp.asarray(run["inp"]["z8"]), 16)
    np.testing.assert_array_equal(out["rowshard_idx"], np.asarray(ref.indices))
    assert "not divisible" in str(out["refusal"])
    np.testing.assert_array_equal(out["mesh_sizes"], [W, max(1, W // 2)])
    assert "out of range" in str(out["mesh_refusal"])


def test_preprocessor_shard_selection_matches_reference(run):
    """The flat gram-free preprocessor: sharded and single-device artifacts
    are the same bits, and the bank is the reference's (its own draws);
    the lazy one: the bank equal, the importance by the near-tie rule's
    sorted comparison, class by class."""
    from repro.core.milo import MiloPreprocessor as JPre
    from repro_torch.core.milo import MiloPreprocessor as TPre

    inp, out = run["inp"], run["out"]
    feats, labels = inp["prep_x"], inp["prep_y"]
    noise = [inp[f"prep_noise_{i}"] for i in range(int(inp["prep_n"]))]
    for tag, kw in PREP_CASES:
        assert bool(out[tag + "_flag"])
        ref = JPre(subset_fraction=0.1, **kw).preprocess(feats, labels, jax.random.PRNGKey(0))
        base = TPre(subset_fraction=0.1, device="cpu", **kw).preprocess(feats, labels, 0,
                                                                          sge_noise=noise)
        np.testing.assert_array_equal(out[tag + "_sge"], ref.sge_subsets)
        np.testing.assert_array_equal(out[tag + "_sge"], base.sge_subsets)
        if tag == "prep":
            np.testing.assert_array_equal(out[tag + "_imp"], base.wre_importance)
            np.testing.assert_array_equal(out[tag + "_probs"], base.wre_probs)
            np.testing.assert_allclose(out[tag + "_imp"], ref.wre_importance, rtol=1e-5,
                                       atol=1e-6)
        else:
            for c in range(len(SIZES)):
                m = labels == c
                np.testing.assert_allclose(np.sort(out[tag + "_imp"][m]),
                                           np.sort(ref.wre_importance[m]), rtol=1e-4, atol=1e-5)


def test_milo_fixed_shard_selection_matches_reference(run):
    from repro.selection import build_selector as jbuild

    feats = run["inp"]["mf_x"]
    ref = jbuild("milo_fixed", features=feats, k=24, gram_free=True)
    np.testing.assert_array_equal(run["out"]["milo_fixed"], ref.plan(0).indices)


def test_compressed_sum_and_its_integrity_check(run):
    """int8 with two error-feedback rounds picks nearly the exact subset (a
    sanity bound; ``test_reference_sharded_disparity_gains`` holds it to the
    reference's compressed run); a byte flipped in one rank's payload after
    its checksum was stamped makes every rank raise
    ``CompressionIntegrityError``."""
    out = run["out"]
    assert np.isfinite(out["c8_z0_gains"]).all()
    overlap = len(set(out["c8_z0_idx"].tolist()) & set(out["greedy_facility_location_idx"].tolist()))
    assert overlap >= 20, overlap
    np.testing.assert_allclose(out["c8_z0_gains"], out["greedy_facility_location_gains"],
                               rtol=0.05, atol=0.05)
    for rank in run["ranks"]:
        assert str(rank["corrupt"]) == "CompressionIntegrityError"
    assert [int(r["corrupt_fired"]) for r in run["ranks"]][-1] == 1
    assert sum(int(r["corrupt_fired"]) for r in run["ranks"]) == 1


def test_sharded_factories_are_memoized():
    from repro_torch.core.sharded import make_sharded_gram_free, sharded_greedy
    from repro_torch.distributed.sharding import SelectionMesh, selection_mesh

    m8, m4 = SelectionMesh(None, tuple(range(8)), 0), SelectionMesh(None, tuple(range(4)), 0)
    for name in NAMES:
        assert make_sharded_gram_free(name, mesh=m8) is make_sharded_gram_free(name, mesh=m8)
        assert make_sharded_gram_free(name, mesh=m8).mesh is m8
    assert make_sharded_gram_free("graph_cut", mesh=m8) is not \
        make_sharded_gram_free("graph_cut", mesh=m4)
    with pytest.raises(ValueError, match="unknown compression scheme"):
        make_sharded_gram_free("facility_location", mesh=m8, compress="zstd")
    # a set function built for one mesh refuses to run on another
    z = torch.from_numpy(_fixture(64))
    with pytest.raises(ValueError, match="not built for this mesh"):
        sharded_greedy(make_sharded_gram_free("graph_cut", mesh=m8), z, 4, mesh=selection_mesh())


REFERENCE = r"""
import sys, json
import numpy as np, jax, jax.numpy as jnp
W, inp_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
assert jax.device_count() == W, jax.device_count()
from repro.core import make_sharded_gram_free, sharded_greedy, sharded_greedy_importance
from repro.distributed.sharding import selection_mesh
inp = dict(np.load(inp_path))
mesh = selection_mesh(W)
out = {}
for name in ("disparity_sum", "disparity_min"):
    r = sharded_greedy(make_sharded_gram_free(name, n_shards=W), jnp.asarray(inp["z0"]), 24,
                       mesh=mesh)
    out[name] = np.asarray(r.gains)
out["imp_dmin"] = np.asarray(sharded_greedy_importance(
    make_sharded_gram_free("disparity_min", n_shards=W), jnp.asarray(inp["z2p"]), mesh=mesh,
    valid=jnp.arange(256) < 200))
fc = make_sharded_gram_free("facility_location", n_shards=W, compress="int8", compress_rounds=2)
for tag in ("z0", "zmh"):
    r = sharded_greedy(fc, jnp.asarray(inp[tag]), 24, mesh=mesh)
    out[f"c8_{tag}_idx"], out[f"c8_{tag}_gains"] = np.asarray(r.indices), np.asarray(r.gains)
# the compressed sum alone: each run's (W, n) partials, one row a device
from jax.sharding import PartitionSpec as P
from repro.core import sharded as RS
parts = inp["c8_parts"][:W]
for rounds in (1, 2, 3):
    f = jax.jit(RS.shard_map(lambda x: RS._compressed_psum(x[0], "sel", rounds=rounds)[None],
                             mesh=mesh, in_specs=P("sel", None), out_specs=P("sel", None),
                             check_rep=False))
    out[f"c8_sum_r{rounds}"] = np.stack([np.asarray(f(jnp.asarray(parts[:, b])))
                                         for b in range(parts.shape[1])], axis=1)  # (W, B, n)
np.savez(out_path, **out)
"""


def test_reference_sharded_disparity_gains(run, tmp_path):
    """The reference's own sharded engines on W forced CPU devices (cases
    that pass there).  Disparity-min's gains over 24 picks equal the port's
    W-rank gains bit for bit; disparity-sum's and disparity-min's importance
    carry the last-bit differences of torch's and XLA's products (the
    single-device engines' own), so they are held at rtol 1e-6 + 4 ulps,
    with the indices exact.  The compressed sum (``_compressed_psum``, 1-3
    rounds, three runs a rank) on the same per-rank partials: the
    reference's up to its compiled arithmetic's last bits and one
    last-round quantization step a rank (bit-equal on every rank).  The int8-compressed facility location (two
    error-feedback rounds, k 24, on ``z0`` and on the two-process fixture):
    the reference's indices, and its gains within one last-round
    quantization step a rank."""
    W = run["W"]
    np.savez(tmp_path / "inp.npz", **{k: run["inp"][k] for k in ("z0", "z2p", "zmh", "c8_parts")})
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS=f"--xla_force_host_platform_device_count={W}")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(W), str(tmp_path / "inp.npz"),
                        str(tmp_path / "ref.npz")], env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    out = run["out"]
    with np.load(tmp_path / "ref.npz") as f:
        np.testing.assert_array_equal(out["greedy_disparity_min_gains"], f["disparity_min"])
        np.testing.assert_allclose(out["greedy_disparity_sum_gains"], f["disparity_sum"],
                                   rtol=1e-6, atol=4 * ULP)
        np.testing.assert_allclose(out["imp_dmin"], f["imp_dmin"], rtol=1e-6, atol=4 * ULP)
        assert ((out["imp_dmin"] == 0.0) == (f["imp_dmin"] == 0.0)).all()
        # the compressed sum on the same partials (per-run quantization,
        # error feedback, rank-order decode): every rank's copy the same
        # bits, and the reference's up to the last bits of its compiled
        # arithmetic (XLA contracts the decode into FMAs and turns the
        # scale's /127 into a multiply), which can flip at most one
        # last-round quantization step a rank: scale_R ≤ max|x| / (127·254^(R-1))
        parts = run["inp"]["c8_parts"][:W]                     # (W, B, n)
        for rounds in (1, 2, 3):
            want = f[f"c8_sum_r{rounds}"]                      # (W, B, n)
            got = run["ranks"][0][f"c8_sum_r{rounds}"]
            for rank in run["ranks"][1:]:
                np.testing.assert_array_equal(rank[f"c8_sum_r{rounds}"], got)
            assert (want == want[0]).all()
            step = W * np.abs(parts).max(axis=(0, 2)) / (127.0 * 254.0 ** (rounds - 1))
            tol = step[:, None] + 4 * W * np.spacing(np.abs(want[0]))
            np.testing.assert_array_less(np.abs(got - want[0]), tol, err_msg=f"rounds {rounds}")
        # the compressed greedy: the reference's picks; its gains move from
        # the reference's only where a partial's last bits (torch's and
        # XLA's products) flip a quantization step, the last round's at
        # most: g_t / (127·254) a rank (a partial is at most the gain), here
        # with a factor 2 for the scales' own last bits
        for tag in ("z0", "zmh"):
            np.testing.assert_array_equal(out[f"c8_{tag}_idx"], f[f"c8_{tag}_idx"], err_msg=tag)
            want = f[f"c8_{tag}_gains"]
            step = W * np.abs(want) / 127.0 ** 2
            np.testing.assert_array_less(np.abs(out[f"c8_{tag}_gains"] - want), step + 4 * ULP,
                                         err_msg=tag)
