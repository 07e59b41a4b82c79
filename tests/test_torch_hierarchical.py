"""The hierarchical path of the port against the JAX reference, on the CPU:
block partitions, ``greedy.refine``, the level-1 refine of
``MiloPreprocessor``, ``warmup``, ``hierarchical_select``,
``targeted_select``, the ``milo_hier`` / ``milo_targeted`` selectors and the
session's partition checks.

The reference runs as its own tests run it (``tests/test_hierarchical.py``;
``use_pallas=True`` puts its similarity kernel in interpret mode); the port
runs on ``device="cpu"`` with the reference's SGE draws injected through
``sge_noise=``.  What is exact and what is not:

* partitions, budgets, configs and ``config_hash``, the bank (graph-cut
  SGE, then the refine) and the geometry dicts are equal; ``wre_probs``
  agree to rtol 1e-5, atol 1e-7 (fp32 reduction order);
* the lazy facility-location WRE pass is held per partition to the rules of
  ``tests/test_torch_slice.py`` (index-exact up to the first near-tie of
  the cached gains);
* ``hierarchical_select`` over raw features: the port's ``normalize_rows``
  (``torch.linalg.vector_norm``) and the reference's (XLA's norm, an FMA
  chain at d = 32) differ by one ulp in ~40% of the fixture's rows, which
  reorders a 2-ulp near-tie of facility-location gains deep in the refine.
  The index-exact comparisons therefore carry the reference's
  normalisation into the port (monkeypatched, as
  ``tests/test_torch_tune.py`` carries the reference's initial parameters),
  and the raw run is held to the first parting being a near-tie;
* the lazy refine's cached gains drift by a few ulps in each package, the
  port's drift not the reference's (``tests/test_torch_lazy.py``): it is
  index-exact over its shortlist horizon (a quarter of the union) and its
  first parting after it is a near-tie; the eager refine
  (``lazy_threshold=None``) is index-exact over all k picks.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.selection as jsel
from repro.core.metadata import MetadataMismatchError as JMismatch
from repro.core.metadata import MiloMetadata as JMeta
from repro.core.milo import MiloPreprocessor as JPre
from repro.core.similarity import normalize_rows as jnormalize
import repro_torch.selection as tsel
from repro_torch.core import gram_free as tgf
from repro_torch.core import greedy as tg
from repro_torch.core.metadata import MetadataMismatchError
from repro_torch.core.metadata import MiloMetadata as TMeta
from repro_torch.core.milo import MiloPreprocessor as TPre, _next_pow2

torch.set_num_threads(1)

jpart = importlib.import_module("repro.core.partition")
tpart = importlib.import_module("repro_torch.core.partition")
jg = importlib.import_module("repro.core.greedy")
jgf = importlib.import_module("repro.core.gram_free")
jmilo = importlib.import_module("repro.core.milo")
tmilo = importlib.import_module("repro_torch.core.milo")
tsim = importlib.import_module("repro_torch.core.similarity")
jselectors = importlib.import_module("repro.selection.selectors")


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def _golden_dataset():
    """The reference's ``tests/test_hierarchical.py`` fixture."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(240, 16)).astype(np.float32)
    labels = rng.integers(0, 4, size=240).astype(np.int64)
    return feats, labels


def _ref_normalized(n: int, d: int = 16, seed: int = 11) -> np.ndarray:
    """numpy features through the reference's normalisation (as
    ``tests/test_torch_lazy.py`` hands them to both packages)."""
    z = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return np.asarray(jnormalize(jnp.asarray(z)))


@pytest.fixture(scope="module")
def fixture_4096():
    """The reference's objective fixture: n = 4096, d = 32, k = 128."""
    return np.random.default_rng(7).normal(size=(4096, 32)).astype(np.float32), 128


@pytest.fixture
def reference_normalization(monkeypatch):
    """Carry the reference's ``normalize_rows`` into the port (both modules
    that call it on this path), through numpy."""
    def ref_norm(z, eps=1e-8):
        out = np.asarray(jnormalize(jnp.asarray(z.detach().cpu().numpy()), eps))
        return torch.from_numpy(out).to(z.device)

    monkeypatch.setattr(tmilo, "normalize_rows", ref_norm)
    monkeypatch.setattr(tsim, "normalize_rows", ref_norm)


def reference_sge_noise(pre, labels, m, seed=0):
    """The reference's per-partition SGE draws: ``key, k_sge = split(key)``
    per partition (``_preprocess_clean``), then ``split(k_sge, n_subsets)``,
    ``split(kk, k_run)`` and ``gumbel(keys[t], (n_run,))``, in the geometry
    each partition runs at: n_run the bucket of n_c, k_run the bucket of the
    oversampled width min(n_c, rf·k_c)."""
    parts = pre.partition_strategy().partition(
        None if labels is None or not pre.classwise else labels, m)
    budgets = jpart.proportional_budgets(parts, max(1, int(round(pre.subset_fraction * m))))
    rf = max(1, int(pre.refine_factor))
    bucket = pre.bucket_classes and len(parts) > 1
    key = jax.random.PRNGKey(seed)
    noise = []
    for part, b in zip(parts, budgets):
        key, k_sge = jax.random.split(key)
        n_c = len(part.indices)
        k_sel = min(n_c, rf * b)
        n_run = _next_pow2(n_c) if bucket else n_c
        k_run = min(n_run, _next_pow2(k_sel)) if bucket else k_sel

        def run(kk, k_run=k_run, n_run=n_run):
            return jax.vmap(lambda kt: jax.random.gumbel(kt, (n_run,)))(jax.random.split(kk, k_run))

        noise.append(np.asarray(jax.vmap(run)(jax.random.split(k_sge, pre.n_sge_subsets))))
    return noise


def _fl_value(feats: np.ndarray, idx: np.ndarray) -> float:
    """Exact facility-location objective (rescaled cosine) of a subset."""
    z = feats.astype(np.float64)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    return float((0.5 + 0.5 * z @ z[np.asarray(idx)].T).max(axis=1).sum())


# ---------------------------------------------------------------------------
# partition strategies: index-equal to the reference's
# ---------------------------------------------------------------------------

PARTITION_CASES = {
    "by_class": ("ByClass", {}, True, 240),
    "by_class_no_labels": ("ByClass", {}, False, 7),
    "random_32_3": ("RandomBlocks", dict(block_size=32, seed=3), False, 240),
    "random_32_4": ("RandomBlocks", dict(block_size=32, seed=4), False, 240),
    "random_7_9_labels_ignored": ("RandomBlocks", dict(block_size=7, seed=9), True, 240),
    "random_one_block": ("RandomBlocks", dict(block_size=4096, seed=0), False, 240),
    "random_empty": ("RandomBlocks", dict(block_size=32, seed=0), False, 0),
    "balanced_32": ("BalancedBlocks", dict(block_size=32), True, 240),
    "balanced_30": ("BalancedBlocks", dict(block_size=30), True, 240),
    "balanced_no_labels": ("BalancedBlocks", dict(block_size=50), False, 240),
}


@pytest.mark.parametrize("case", sorted(PARTITION_CASES))
def test_partitions_index_equal(case):
    cls, kw, with_labels, m = PARTITION_CASES[case]
    _, labels = _golden_dataset()
    labels = labels[:m] if with_labels else None
    ref = getattr(jpart, cls)(**kw).partition(labels, m)
    out = getattr(tpart, cls)(**kw).partition(labels, m)
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert a.label == b.label
        assert a.indices.dtype == b.indices.dtype
        np.testing.assert_array_equal(a.indices, b.indices)
    seen = np.concatenate([p.indices for p in out]) if out else np.zeros(0, np.int64)
    np.testing.assert_array_equal(np.sort(seen), np.arange(m))
    assert getattr(tpart, cls)(**kw).config() == getattr(jpart, cls)(**kw).config()
    k = max(1, m // 10)
    assert tpart.proportional_budgets(out, k) == jpart.proportional_budgets(ref, k)


@pytest.mark.parametrize("name", ["by_class", "random_blocks", "balanced_blocks"])
def test_make_partition_strategy_matches_reference(name):
    t = tpart.make_partition_strategy(name, block_size=7, seed=9)
    j = jpart.make_partition_strategy(name, block_size=7, seed=9)
    assert t.name == j.name and t.config() == j.config()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tpart.PARTITION_STRATEGIES == jpart.PARTITION_STRATEGIES


def test_partition_strategy_refusals_match_reference():
    for mod in (tpart, jpart):
        with pytest.raises(ValueError, match="unknown partition strategy"):
            mod.make_partition_strategy("kmeans")
        for cls in (mod.RandomBlocks, mod.BalancedBlocks):
            with pytest.raises(ValueError, match="block_size"):
                cls(block_size=0)


# ---------------------------------------------------------------------------
# greedy.refine
# ---------------------------------------------------------------------------

REFINE_CASES = {
    # name: (set function, lazy_budget, k)
    "greedy": ("fl", None, 24),
    "lazy": ("fl", 32, 24),
    "budget_n_is_greedy": ("fl", 256, 24),
    "budget_0_is_greedy": ("fl", 0, 24),
    "no_lazy_hooks": ("graph_cut", 32, 24),
}


@pytest.mark.parametrize("case", sorted(REFINE_CASES))
def test_refine_index_exact(case):
    name, budget, k = REFINE_CASES[case]
    zn = _ref_normalized(256)
    if name == "fl":
        fj = jgf.make_gram_free_facility_location()
        ft = tgf.make_gram_free_facility_location()
    else:
        fj, ft = jgf.make_gram_free_graph_cut(0.4), tgf.make_gram_free_graph_cut(0.4)
    ref = jg.refine(fj, jnp.asarray(zn), k, lazy_budget=budget)
    out = tg.refine(ft, torch.from_numpy(zn), k, lazy_budget=budget)
    assert isinstance(out, tg.GreedyResult)
    np.testing.assert_array_equal(out.indices.numpy(), np.asarray(ref.indices))
    np.testing.assert_allclose(out.gains.numpy(), np.asarray(ref.gains), rtol=1e-5)
    eager = tg.greedy(ft, torch.from_numpy(zn), k)
    np.testing.assert_array_equal(out.indices.numpy(), eager.indices.numpy())


def test_refine_takes_the_lazy_engine_only_in_range(monkeypatch):
    calls = []
    orig = tg.lazy_greedy

    def spy(*args, **kwargs):
        calls.append(kwargs["budget"])
        return orig(*args, **kwargs)

    monkeypatch.setattr(tg, "lazy_greedy", spy)
    zn = torch.from_numpy(_ref_normalized(64))
    fn = tgf.make_gram_free_facility_location()
    for budget in (None, 0, 64, 100, 1, 63):
        tg.refine(fn, zn, 8, lazy_budget=budget)
    assert calls == [1, 63]


# ---------------------------------------------------------------------------
# MiloPreprocessor on the hierarchical path
# ---------------------------------------------------------------------------

HIER_PREPROCESS = {
    "random_blocks_dense": dict(gram_free=False, partition="random_blocks", partition_block=64,
                                refine_factor=2),
    "random_blocks_gram_free": dict(gram_free=True, partition="random_blocks",
                                    partition_block=64, refine_factor=2),
    "by_class_dense": dict(gram_free=False, refine_factor=2),
    "by_class_gram_free": dict(gram_free=True, refine_factor=2),
    "balanced_blocks_dense": dict(gram_free=False, partition="balanced_blocks",
                                  partition_block=40, refine_factor=3),
}


@pytest.fixture(scope="module")
def hier_artifacts():
    feats, labels = _golden_dataset()
    out = {}
    for case, kw in HIER_PREPROCESS.items():
        base = dict(subset_fraction=0.1, n_sge_subsets=4, use_pallas=True, **kw)
        md_j = JPre(**base).preprocess(feats, labels, jax.random.PRNGKey(0), prep_seed=0)
        pre = TPre(**base, device="cpu")
        md_t = pre.preprocess(feats, labels, 0, prep_seed=0,
                              sge_noise=reference_sge_noise(pre, labels, len(labels)))
        out[case] = (md_j, md_t)
    return out


@pytest.mark.parametrize("case", sorted(HIER_PREPROCESS))
def test_hierarchical_preprocess_matches_reference(hier_artifacts, case):
    md_j, md_t = hier_artifacts[case]
    feats, labels = _golden_dataset()
    assert md_t.config == md_j.config
    assert md_t.config_hash() == md_j.config_hash()
    for key in ("partition", "refine_factor"):
        assert md_t.config[key] == HIER_PREPROCESS[case].get(key, "by_class")
    np.testing.assert_array_equal(md_t.class_budgets, md_j.class_budgets)
    np.testing.assert_array_equal(md_t.class_labels, md_j.class_labels)
    diff = np.argwhere(md_t.sge_subsets != md_j.sge_subsets)
    assert not len(diff), f"bank parts from the reference at (slot, position) {diff[0].tolist()}"
    np.testing.assert_allclose(md_t.wre_probs, md_j.wre_probs, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(md_t.wre_importance, md_j.wre_importance, rtol=1e-5, atol=1e-6)
    k = md_t.k
    assert md_t.sge_subsets.shape == (4, k) and int(md_t.class_budgets.sum()) == k
    for slot in md_t.sge_subsets:
        assert len(np.unique(slot)) == k and slot.min() >= 0 and slot.max() < len(labels)
    np.testing.assert_allclose(float(md_t.wre_probs.astype(np.float64).sum()), 1.0, rtol=1e-5)


def test_flat_path_stamps_no_partition_keys():
    """by_class with rf 1 is the flat path: no partition key, so flat
    config hashes (and every reuse check keyed on them) do not move; rf 1
    and rf 0 are one config."""
    feats, labels = _golden_dataset()
    cfgs = []
    for rf in (1, 0):
        md = TPre(subset_fraction=0.1, n_sge_subsets=2, refine_factor=rf, device="cpu").preprocess(
            feats, labels, 0, prep_seed=0)
        for key in ("partition", "partition_block", "partition_seed", "refine_factor"):
            assert key not in md.config
        cfgs.append(md.config_hash())
    assert cfgs[0] == cfgs[1]


def test_lazy_facility_location_route_matches_reference():
    """The gram-free lazy facility-location WRE (``chip_smoke.py``'s
    GRAM_FREE_PATH) over random blocks with rf 2: the bank is index-exact,
    the importance per partition follows the lazy rules of
    ``tests/test_torch_slice.py``."""
    from tests.test_torch_slice import _assert_importance_per_lazy_rules

    feats, labels = _golden_dataset()
    base = dict(subset_fraction=0.1, n_sge_subsets=4, use_pallas=True, gram_free=True,
                hard_fn="facility_location", lazy_gains=True, lazy_two_level=True,
                partition="random_blocks", partition_block=64, refine_factor=2)
    md_j = JPre(**base).preprocess(feats, labels, jax.random.PRNGKey(0), prep_seed=0)
    pre = TPre(**base, device="cpu")
    md_t = pre.preprocess(feats, labels, 0, prep_seed=0,
                          sge_noise=reference_sge_noise(pre, labels, len(labels)))
    assert md_t.config == md_j.config and md_t.config_hash() == md_j.config_hash()
    np.testing.assert_array_equal(md_t.sge_subsets, md_j.sge_subsets)
    block = np.zeros(len(labels), np.int64)
    for p in pre.partition_strategy().partition(None, len(labels)):
        block[p.indices] = p.label
    _assert_importance_per_lazy_rules(md_t.wre_importance, md_j.wre_importance, block)


def test_warmup_does_not_move_the_artifact():
    feats, labels = _golden_dataset()
    kw = dict(subset_fraction=0.1, n_sge_subsets=2, gram_free=True, partition="random_blocks",
              partition_block=64, refine_factor=2, device="cpu")
    cold = TPre(**kw).preprocess(feats, labels, 3)
    pre = TPre(**kw)
    parts = pre.partition_strategy().partition(labels, len(labels))
    budgets = tpart.proportional_budgets(parts, cold.k)
    buckets = [(len(p.indices), b) for p, b in zip(parts, budgets)]
    assert pre.warmup(buckets, 16, seed=5) == len({(n, min(n, 2 * b)) for n, b in buckets}) == 1
    warm = pre.preprocess(feats, labels, 3)
    np.testing.assert_array_equal(warm.sge_subsets, cold.sge_subsets)
    np.testing.assert_array_equal(warm.wre_probs, cold.wre_probs)


WARMUP_CASES = {
    "reference_fixture": ([(26, 1), (26, 3), (26, 3), (26, 3)], 2,
                          dict(gram_free=True, lazy_gains=True, hard_fn="facility_location",
                               partition="random_blocks", partition_block=32)),
    "balanced_classes": ([(30, 3)] * 3 + [(14, 1)], 1, dict()),
    "zero_budgets": ([(10, 0), (12, 2), (12, 2), (9, 5)], 3, dict(gram_free=True)),
    "single_partition": ([(40, 4)], 2, dict()),
}


@pytest.mark.parametrize("case", sorted(WARMUP_CASES))
def test_warmup_count_matches_reference(case):
    buckets, rf, kw = WARMUP_CASES[case]
    ref = JPre(subset_fraction=0.1, refine_factor=rf, **kw).warmup(buckets, 8)
    out = TPre(subset_fraction=0.1, refine_factor=rf, device="cpu", **kw).warmup(buckets, 8)
    assert out == ref


# ---------------------------------------------------------------------------
# hierarchical_select and targeted_select
# ---------------------------------------------------------------------------

def _horizon_check(out: np.ndarray, ref: np.ndarray, feats: np.ndarray, ground: np.ndarray,
                   horizon: int) -> None:
    """Index-exact over the first ``horizon`` picks; the first parting after
    it must be a near-tie: the two picks' facility-location gains over the
    refine's ``ground`` rows (the union), given the picks before the
    parting, within 4 fp32 ulps of the larger.  Past it, both subsets cover
    the union alike (objective rtol 1e-5)."""
    g = ground.astype(np.float64)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    z = feats.astype(np.float64)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    sim = lambda idx: 0.5 + 0.5 * g @ z[np.asarray(idx)].T  # noqa: E731
    parted = np.nonzero(out != ref)[0]
    t = int(parted[0]) if len(parted) else len(ref)
    assert t >= horizon, f"parted at pick {t}, inside the horizon {horizon}"
    if t < len(ref):
        cover = sim(ref[:t]).max(axis=1) if t else np.zeros(len(g))
        ga, gb = (float(np.maximum(sim([j])[:, 0] - cover, 0.0).sum()) for j in (ref[t], out[t]))
        tol = 4 * float(np.spacing(np.float32(max(ga, gb))))
        assert abs(ga - gb) <= tol, f"pick {t}: gains {ga} and {gb} are no near-tie"
    np.testing.assert_allclose(sim(out).max(axis=1).sum(), sim(ref).max(axis=1).sum(), rtol=1e-5)


def _union_rows(monkeypatch) -> list:
    """Record the rows of every partition kernel the port builds (the last
    one is the refine's union)."""
    seen = []
    orig = tmilo._hier_kernel

    def spy(feats, n_pad, **kw):
        seen.append(np.array(feats))
        return orig(feats, n_pad, **kw)

    monkeypatch.setattr(tmilo, "_hier_kernel", spy)
    return seen


@pytest.mark.parametrize("gram_free", [True, False])
@pytest.mark.parametrize("lazy", [True, False])
def test_hierarchical_select_index_exact(fixture_4096, reference_normalization, monkeypatch,
                                        gram_free, lazy):
    feats, k = fixture_4096
    rows = _union_rows(monkeypatch)
    kw = dict(partition="random_blocks", block_size=512, refine_factor=2, gram_free=gram_free,
              lazy_threshold=0.125 if lazy else None, return_info=True)
    ref, info_j = jmilo.hierarchical_select(feats, k, **kw)
    out, info_t = tmilo.hierarchical_select(feats, k, use_pallas=True, device="cpu", **kw)
    assert info_t == info_j == {"n_partitions": 8, "union_size": 256,
                                "peak_partition_rows": 512, "refine_factor": 2}
    assert out.dtype == np.int64 and out.shape == (k,) and len(np.unique(out)) == k
    if lazy:
        _horizon_check(out, np.asarray(ref), feats, rows[-1], info_j["union_size"] // 4)
    else:
        np.testing.assert_array_equal(out, ref)


def test_hierarchical_select_raw_features_within_bound(fixture_4096, monkeypatch):
    """The port's own normalisation: within 5% of the exact flat greedy
    (the reference's bound) and equal to the reference up to a near-tie."""
    feats, k = fixture_4096
    rows = _union_rows(monkeypatch)
    out, info = tmilo.hierarchical_select(feats, k, partition="random_blocks", block_size=512,
                                          refine_factor=2, return_info=True, device="cpu")
    ref = jmilo.hierarchical_select(feats, k, partition="random_blocks", block_size=512,
                                    refine_factor=2)
    assert info["n_partitions"] == 8 and info["peak_partition_rows"] <= 512
    # the exact flat greedy, as the reference's test computes it
    flat = jg.greedy(jgf.make_gram_free_facility_location(), jnormalize(jnp.asarray(feats)), k)
    ratio = _fl_value(feats, out) / _fl_value(feats, np.asarray(flat.indices))
    assert ratio >= 0.95, f"hierarchical/flat objective ratio {ratio:.4f}"
    _horizon_check(out, np.asarray(ref), feats, rows[-1], 32)


EDGE_CASES = {
    "k_zero": (0, dict()),
    "k_over_n": (100, dict(partition="random_blocks", block_size=16)),
    "one_block": (5, dict(partition="random_blocks", block_size=64, refine_factor=2)),
    "balanced_dense": (6, dict(partition="balanced_blocks", block_size=16, gram_free=False)),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_hierarchical_select_edge_cases_match_reference(reference_normalization, case):
    k, kw = EDGE_CASES[case]
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(40, 8)).astype(np.float32)
    labels = rng.integers(0, 3, 40).astype(np.int64)
    ref, info_j = jmilo.hierarchical_select(feats, k, labels=labels, return_info=True, **kw)
    out, info_t = tmilo.hierarchical_select(feats, k, labels=labels, return_info=True,
                                            device="cpu", **kw)
    assert info_t == info_j
    assert out.dtype == np.int64
    if case == "k_over_n":
        # every row, in each block's exhaustive greedy order, whose late
        # picks tie (two rows of one block gain 0.2698897 at its 10th pick)
        np.testing.assert_array_equal(np.sort(out), np.arange(40))
        np.testing.assert_array_equal(np.sort(ref), np.arange(40))
    else:
        np.testing.assert_array_equal(out, ref)


TARGETED_CASES = ["fixture_4096", "clustered_by_class"]


@pytest.mark.parametrize("case", TARGETED_CASES)
def test_targeted_select_index_exact(fixture_4096, case):
    if case == "fixture_4096":
        feats, k = fixture_4096
        labels, queries = None, feats[:12]
        kw = dict(partition="random_blocks", block_size=512)
    else:
        rng = np.random.default_rng(2)
        labels = rng.integers(0, 4, 400).astype(np.int64)
        feats = (rng.normal(size=(400, 16)) + 2.0 * labels[:, None]).astype(np.float32)
        queries, k, kw = feats[np.where(labels == 2)[0][:12]], 8, {}
    ref, info_j = jmilo.targeted_select(feats, queries, k, labels=labels, return_info=True, **kw)
    out, info_t = tmilo.targeted_select(feats, queries, k, labels=labels, return_info=True,
                                        device="cpu", **kw)
    assert info_t == info_j
    np.testing.assert_array_equal(out, ref)
    # the subset covers the queries better than a random one of its size
    z = feats / np.linalg.norm(feats, axis=1, keepdims=True)
    q = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    cover = lambda idx: float((0.5 + 0.5 * z[idx] @ q.T).max(axis=0).sum())  # noqa: E731
    rand = np.random.default_rng(0).choice(len(feats), size=k, replace=False)
    assert cover(out) > cover(rand)


# ---------------------------------------------------------------------------
# the selectors
# ---------------------------------------------------------------------------

def _selector_inputs():
    rng = np.random.default_rng(3)
    labs = rng.integers(0, 3, 150).astype(np.int64)
    feats = (rng.normal(size=(150, 8)) + labs[:, None]).astype(np.float32)
    return feats, labs


SELECTOR_CASES = {
    "milo_hier": lambda f, l: dict(features=f, k=15, labels=l, partition="balanced_blocks",
                                   partition_block=32, refine_factor=2),
    "milo_hier_dense_graph_cut": lambda f, l: dict(features=f, k=12, partition="random_blocks",
                                                   partition_block=40, fn_name="graph_cut",
                                                   gram_free=False),
    "milo_targeted": lambda f, l: dict(features=f, queries=f[l == 1][:6], k=5, labels=l),
}


@pytest.mark.parametrize("case", sorted(SELECTOR_CASES))
def test_registry_plans_match_reference(reference_normalization, case):
    feats, labs = _selector_inputs()
    name = case if case != "milo_hier_dense_graph_cut" else "milo_hier"
    cfg = SELECTOR_CASES[case](feats, labs)
    ref = jsel.build_selector(name, **cfg)
    out = tsel.build_selector(name, device="cpu", **cfg)
    assert out.info == ref.info
    for epoch in (0, 5):
        pj, pt = ref.plan(epoch), out.plan(epoch)
        pt.validate(len(feats))
        assert pt.phase == pj.phase == "fixed"
        np.testing.assert_array_equal(pt.indices, pj.indices)
        np.testing.assert_array_equal(pt.weights, pj.weights)
        assert dict(pt.provenance) == dict(pj.provenance)


def test_selector_configs_are_the_references_plus_device():
    for name in ("MiloHierConfig", "MiloTargetedConfig"):
        t = [(f.name, f.default) for f in dataclasses.fields(getattr(tsel, name))]
        j = [(f.name, f.default) for f in dataclasses.fields(getattr(jselectors, name))]
        assert t == j + [("device", "cuda")]


# ---------------------------------------------------------------------------
# artifacts and sessions across packages
# ---------------------------------------------------------------------------

HIER = dict(partition="random_blocks", partition_block=64, refine_factor=2)


def _session_cfg(path=None, **kw):
    return dict(subset_fraction=0.1, n_sge_subsets=2,
                metadata_path=None if path is None else str(path), **kw)


def test_artifacts_load_across_packages_with_partition_keys(hier_artifacts, tmp_path):
    md_j, md_t = hier_artifacts["random_blocks_gram_free"]
    for src, load in ((md_j, TMeta.load), (md_t, JMeta.load)):
        path = str(tmp_path / f"{type(src).__module__}.npz")
        src.save(path)
        back = load(path, expected_hash=src.config_hash())
        assert back.config == src.config and back.config["partition"] == "random_blocks"
        for f in ("sge_subsets", "wre_probs", "wre_importance", "class_labels", "class_budgets"):
            np.testing.assert_array_equal(getattr(back, f), getattr(src, f))


def test_sessions_reuse_each_others_hierarchical_artifacts(tmp_path):
    feats, labels = _golden_dataset()
    path_j = tmp_path / "ref.npz"
    md_j = jsel.MiloSession(jsel.MiloSessionConfig(**_session_cfg(path_j, **HIER))).preprocess(
        feats, labels)
    reuse = tsel.MiloSession(tsel.MiloSessionConfig(**_session_cfg(path_j, **HIER)), device="cpu")
    assert reuse.preprocess(feats, labels).config_hash() == md_j.config_hash()
    assert reuse.loaded_from_artifact
    path_t = tmp_path / "port.npz"
    made = tsel.MiloSession(tsel.MiloSessionConfig(**_session_cfg(path_t, **HIER)), device="cpu")
    md_t = made.preprocess(feats, labels)
    assert md_t.config == md_j.config  # the same stamped provenance
    back = jsel.MiloSession(jsel.MiloSessionConfig(**_session_cfg(path_t, **HIER)))
    assert back.preprocess(feats, labels).config_hash() == md_t.config_hash()
    assert back.loaded_from_artifact


BAD_CONFIGS = {
    "partition": dict(partition="by_class"),
    "partition_block": dict(HIER, partition_block=32),
    "partition_seed": dict(HIER, partition_seed=1),
    "refine_factor": dict(HIER, refine_factor=3),
}


def _mismatch(err: Exception) -> str:
    return str(err).split("config mismatch on ", 1)[1]


@pytest.fixture(scope="module")
def reference_artifacts(tmp_path_factory):
    feats, labels = _golden_dataset()
    root = tmp_path_factory.mktemp("hier_sessions")
    paths = {"hier": root / "hier.npz", "flat": root / "flat.npz"}
    jsel.MiloSession(jsel.MiloSessionConfig(**_session_cfg(paths["hier"], **HIER))).preprocess(
        feats, labels)
    jsel.MiloSession(jsel.MiloSessionConfig(**_session_cfg(paths["flat"]))).preprocess(
        feats, labels)
    return paths


@pytest.mark.parametrize("bad", sorted(BAD_CONFIGS) + ["flat_artifact"])
def test_session_refusals_match_reference(reference_artifacts, bad):
    """Artifact load: the port refuses what the reference refuses, naming
    the same keys and values."""
    feats, labels = _golden_dataset()
    if bad == "flat_artifact":
        path, kw = reference_artifacts["flat"], HIER
    else:
        path, kw = reference_artifacts["hier"], BAD_CONFIGS[bad]
    with pytest.raises(JMismatch, match="partition|refine") as ej:
        jsel.MiloSession(jsel.MiloSessionConfig(**_session_cfg(path, **kw))).preprocess(
            feats, labels)
    with pytest.raises(MetadataMismatchError, match="partition|refine") as et:
        tsel.MiloSession(tsel.MiloSessionConfig(**_session_cfg(path, **kw)),
                         device="cpu").preprocess(feats, labels)
    assert _mismatch(et.value) == _mismatch(ej.value)


@pytest.mark.parametrize("bad", sorted(BAD_CONFIGS) + ["flat_artifact"])
def test_adopt_refusals_match_reference(hier_artifacts, bad):
    """``adopt_metadata``: the reference's hierarchical (or flat) artifact,
    refused by a port session on a mismatched config, as by the
    reference's."""
    feats, labels = _golden_dataset()
    if bad == "flat_artifact":
        md = jsel.MiloSession(jsel.MiloSessionConfig(**_session_cfg())).build_metadata(
            feats, labels)
        kw = HIER
    else:
        md = jsel.MiloSession(jsel.MiloSessionConfig(**_session_cfg(**HIER))).build_metadata(
            feats, labels)
        kw = BAD_CONFIGS[bad]
    with pytest.raises(JMismatch) as ej:
        jsel.MiloSession(jsel.MiloSessionConfig(**_session_cfg(**kw))).adopt_metadata(md)
    port_md = TMeta(md.sge_subsets, md.wre_probs, md.wre_importance, md.class_labels,
                    md.class_budgets, dict(md.config))
    with pytest.raises(MetadataMismatchError) as et:
        tsel.MiloSession(tsel.MiloSessionConfig(**_session_cfg(**kw)),
                         device="cpu").adopt_metadata(port_md)
    assert _mismatch(et.value) == _mismatch(ej.value)
    if bad != "flat_artifact":
        session = tsel.MiloSession(tsel.MiloSessionConfig(**_session_cfg(**HIER)), device="cpu")
        assert session.adopt_metadata(port_md) is port_md


def test_session_preprocesses_hierarchically_and_trains():
    feats, labels = _golden_dataset()
    cfg = _session_cfg(**HIER)
    s = tsel.MiloSession(tsel.MiloSessionConfig(total_epochs=4, **cfg), device="cpu")
    md = s.preprocess(feats, labels)
    assert md.config["partition"] == "random_blocks" and md.config["refine_factor"] == 2
    assert md.config["partition_block"] == 64 and md.config["partition_seed"] == 0
    report = s.train(feats, labels, test_x=feats, test_y=labels)
    assert report.steps == 4 and np.isfinite(report.final_acc)
    sel = s.selector("milo_hier", n=len(feats), features=feats, k=20, labels=labels,
                     partition="balanced_blocks", partition_block=32)
    assert len(np.unique(sel.plan(0).indices)) == 20
