"""The port offers what the reference offers its users.

* Name parity (ast only, no import): every public top-level name, and every
  public method of a same-named class, of each module of ``src/repro/`` has a
  counterpart in the same module of ``src/repro_torch/``, apart from the
  stated allow-list.
* Package exports: what each reference package exports is readable from the
  port's package of the same name.
* The legacy ``indices_for_epoch`` protocol: ``Pipeline`` trains on legacy
  selectors through ``ensure_selector`` in both packages, with the same
  plans and visit order.
* The exploration types and ``SyntheticTextDataset`` against the reference's.
"""
import ast
import importlib
import os
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.baselines.selectors as jbase
import repro.core as jcore
import repro.core.exploration as jexp
import repro.core.metadata as jmeta
import repro.core.milo as jmilo
import repro.data.datasets as jdata
import repro.data.pipeline as jpipe
import repro.selection as jsel
import repro_torch.baselines.selectors as tbase
import repro_torch.core as tcore
import repro_torch.core.exploration as texp
import repro_torch.core.metadata as tmeta
import repro_torch.core.milo as tmilo
import repro_torch.data.datasets as tdata
import repro_torch.data.pipeline as tpipe
import repro_torch.selection as tsel
from repro.core.curriculum import CurriculumConfig as JCurriculum
from repro_torch.core.curriculum import CurriculumConfig as TCurriculum

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
FP32 = dict(rtol=1e-4, atol=2e-4)   # tests/test_kernels.py's fp32 tolerances

#: reference module -> names with no counterpart in the port's module, and why
ALLOWED = {
    "kernels/similarity/similarity.py": {
        "similarity_pallas": "the Pallas kernel; its port is CUDA in csrc/similarity.cu"},
    "kernels/fl_gains/fl_gains.py": {
        "fl_gains_pallas": "the Pallas kernel; its port is CUDA in csrc/fl_gains.cu",
        "fl_gains_gram_free_pallas": "the Pallas kernel; its port is CUDA in csrc/fl_gains.cu",
        "fl_gains_gram_free_delta_pallas":
            "the Pallas kernel; its port is CUDA in csrc/fl_gains.cu"},
    "kernels/flash_attention/flash_attention.py": {
        "flash_attention_pallas": "the Pallas kernel; its port is CUDA in csrc/flash_attention.cu"},
    "kernels/ssd_chunk/ssd_chunk.py": {
        "ssd_chunk_pallas": "the Pallas kernel; its port is CUDA in csrc/ssd_chunk.cu"},
    "launch/roofline.py": {
        name: "parses XLA's HLO text; launch/cost_analysis.py counts the port's ops instead"
        for name in ("ICI_BW", "collective_bytes", "roofline_terms_from_hlo")},
}
#: reference modules with no counterpart module, and why
ALLOWED_MODULES = {
    "launch/hlo_analysis.py": "XLA's HLO-text parser; launch/cost_analysis.py replaces it",
}


def _public_names(path: Path) -> tuple[set[str], dict[str, set[str]]]:
    """(public top-level names a module defines, public methods per class)."""
    top, methods = set(), {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            top.add(node.name)
            if isinstance(node, ast.ClassDef):
                methods[node.name] = {n.name for n in node.body if isinstance(
                    n, (ast.FunctionDef, ast.AsyncFunctionDef)) and not n.name.startswith("_")}
        elif isinstance(node, ast.Assign):
            top.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            top.add(node.target.id)
    return {n for n in top if not n.startswith("_")}, methods


def _exported(path: Path) -> set[str]:
    """The public names a package's ``__init__.py`` defines or imports."""
    names, _ = _public_names(path)
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_") and n != "annotations"}


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py") if p.name != "__init__.py")
PACKAGES = sorted(str(p.parent.relative_to(REF)) for p in REF.rglob("__init__.py"))


@pytest.mark.parametrize("rel", MODULES)
def test_module_names_have_port_counterparts(rel):
    if rel in ALLOWED_MODULES:
        return
    assert (PORT / rel).exists(), f"src/repro_torch/{rel} is missing"
    ref_top, ref_methods = _public_names(REF / rel)
    port_top, port_methods = _public_names(PORT / rel)
    allowed = ALLOWED.get(rel, {})
    assert sorted(ref_top - port_top - set(allowed)) == []
    for cls, methods in ref_methods.items():
        if cls in port_methods:
            assert sorted(methods - port_methods[cls]) == [], cls


def test_allow_list_is_limited_to_the_kernels_and_the_hlo_parser():
    """Every allowed name is really missing from the port (a stale entry
    would hide nothing and fail here), and each names what replaces it."""
    for rel, names in ALLOWED.items():
        port_top, _ = _public_names(PORT / rel)
        assert not set(names) & port_top, rel
        assert rel.startswith("kernels/") or rel == "launch/roofline.py"
    assert set(ALLOWED_MODULES) == {"launch/hlo_analysis.py"}
    assert not (PORT / "launch" / "hlo_analysis.py").exists()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_package_exports_are_readable_from_the_port(pkg):
    ref = _exported(REF / pkg / "__init__.py")
    mod = importlib.import_module("repro_torch" + ("" if pkg == "." else "." + pkg.replace("/", ".")))
    assert sorted(n for n in ref if not hasattr(mod, n)) == []


@pytest.mark.parametrize("ref, port", [(jcore, tcore), (jsel, tsel)], ids=["core", "selection"])
def test_dunder_all_matches(ref, port):
    assert set(ref.__all__) <= set(port.__all__)
    assert [n for n in ref.__all__ if getattr(port, n, None) is None] == []


def test_core_import_stays_light():
    """``import repro_torch.core`` loads no submodule until a name is read."""
    code = ("import sys; import repro_torch.core as c; "
            "print(sorted(m for m in sys.modules if m.startswith('repro_torch.core.'))); "
            "c.MiloPreprocessor; print('milo' in {m.split('.')[-1] for m in sys.modules})")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == ["[]", "True"]


# ---------------------------------------------------------------------------
# the legacy selector protocol
# ---------------------------------------------------------------------------

N, K, EPOCHS = 60, 12, 6


def _features() -> np.ndarray:
    return np.random.default_rng(3).normal(size=(N, 8)).astype(np.float32)


def _metadata(pkg):
    rng = np.random.default_rng(5)
    imp = rng.random(N).astype(np.float32)
    w = 1.0 + imp + 0.5 * imp * imp
    return pkg.MiloMetadata(
        sge_subsets=np.stack([rng.choice(N, K, replace=False) for _ in range(3)]).astype(np.int64),
        wre_probs=(w / w.sum()).astype(np.float32), wre_importance=imp,
        class_labels=np.zeros(N, np.int64), class_budgets=np.array([K], np.int64),
        config={"k": K})


def _reference_wre_noise(seed: int):
    """The reference's Gumbel draws of a WRE window (``core.milo``'s key)."""
    def noise(window: int) -> np.ndarray:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), window)
        return np.asarray(jax.random.gumbel(key, (N,)))
    return noise


LEGACY = {
    "RandomSelector": (lambda: jbase.RandomSelector(N, K, seed=4),
                       lambda: tbase.RandomSelector(N, K, seed=4)),
    "AdaptiveRandomSelector": (lambda: jbase.AdaptiveRandomSelector(N, K, R=2, seed=4),
                               lambda: tbase.AdaptiveRandomSelector(N, K, R=2, seed=4)),
    "MiloFixedSelector": (lambda: jbase.MiloFixedSelector(_features(), K),
                          lambda: tbase.MiloFixedSelector(_features(), K, device="cpu")),
    "FullSelector": (lambda: jpipe.FullSelector(N), lambda: tpipe.FullSelector(N)),
    "MiloSelector": (
        lambda: jmilo.MiloSelector(_metadata(jmeta), JCurriculum(EPOCHS, kappa=1 / 3), seed=2),
        lambda: tmilo.MiloSelector(_metadata(tmeta), TCurriculum(EPOCHS, kappa=1 / 3), seed=2,
                                   device="cpu", wre_noise=_reference_wre_noise(2))),
}


@pytest.mark.parametrize("name", sorted(LEGACY))
def test_pipeline_trains_on_legacy_selectors_as_the_reference(name):
    make_ref, make_port = LEGACY[name]
    batch = lambda idx: {"i": idx}  # noqa: E731
    jp = jpipe.Pipeline(batch, make_ref(), 4, seed=7, prefetch=False)
    tp = tpipe.Pipeline(batch, make_port(), 4, seed=7, prefetch=False, device="cpu")
    for e in range(EPOCHS):
        a, b = jp.plan_for_epoch(e), tp.plan_for_epoch(e)
        np.testing.assert_array_equal(b.indices, a.indices)
        np.testing.assert_array_equal(b.weights, a.weights)
        assert (b.phase, b.epoch, dict(b.provenance)) == (a.phase, a.epoch, dict(a.provenance))
        np.testing.assert_array_equal(tp.epoch_indices(e), jp.epoch_indices(e))
        assert tp.steps_per_epoch(e) == jp.steps_per_epoch(e)


def test_legacy_phases():
    """The adapter's phase inference: a curriculum's sge/wre, an ``R``
    ``adaptive``, anything else ``fixed``."""
    phases = {name: [tsel.ensure_selector(make_port()).plan(e).phase for e in range(EPOCHS)]
              for name, (_, make_port) in LEGACY.items()}
    assert phases["MiloSelector"] == ["sge"] * 2 + ["wre"] * 4
    assert set(phases["AdaptiveRandomSelector"]) == {"adaptive"}
    assert set(phases["RandomSelector"]) == set(phases["FullSelector"]) == {"fixed"}


def test_pipeline_on_a_legacy_selector_yields_weighted_batches():
    """The port's ``Pipeline`` used to call ``plan`` on its selector as is,
    so a legacy selector raised ``AttributeError``."""
    x = np.arange(100, dtype=np.float32)[:, None]
    pipe = tpipe.Pipeline(lambda i: {"x": x[i]}, tbase.RandomSelector(n=100, k=10), batch_size=5,
                          seed=0, device="cpu")
    plan = pipe.plan_for_epoch(0)
    assert plan.phase == "fixed" and plan.k == 10
    assert plan.provenance["adapter"] == "RandomSelector"
    batches = list(pipe.epoch(0))
    assert len(batches) == 2 and all(b["weights"].tolist() == [1.0] * 5 for b in batches)


def test_ensure_selector_and_the_shim():
    new = tsel.build_selector("random", n=N, k=K, seed=1)
    assert tsel.ensure_selector(new) is new
    with pytest.raises(TypeError, match="neither plan"):
        tsel.ensure_selector(object())
    with pytest.warns(DeprecationWarning, match="indices_for_epoch is deprecated"):
        idx = new.indices_for_epoch(0)
    np.testing.assert_array_equal(idx, new.plan(0).indices)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = jsel.build_selector("random", n=N, k=K, seed=1).indices_for_epoch(0)
    np.testing.assert_array_equal(idx, ref)
    legacy = tmilo.MiloSelector(_metadata(tmeta), TCurriculum(EPOCHS), device="cpu")
    adapter = tsel.LegacySelectorAdapter(legacy)
    adapter.plan(0)
    assert legacy._cache_epoch == 0
    adapter.reset_cache()
    assert legacy._cache_epoch == -1


def test_selector_entries_match():
    ref = {e.name: e.config_cls.__name__ for e in jsel.iter_entries()}
    port = {e.name: e.config_cls.__name__ for e in tsel.iter_entries()}
    assert port == ref
    assert isinstance(next(tsel.iter_entries()), tsel.SelectorEntry)


def test_session_pipeline(tmp_path):
    """``MiloSession.pipeline``: the session's seed and device, and with a
    buffer registry its shared device columns, which the Trainer uses."""
    from repro_torch.serve import BufferRegistry
    from repro_torch.selection import session as S
    from repro_torch.train.trainer import Trainer, TrainerConfig

    feats = _features()
    labs = (np.arange(N) % 3).astype(np.int64)
    reg = BufferRegistry(device="cpu")
    s = tsel.MiloSession(seed=9, device="cpu", buffer_registry=reg)
    sel = s.selector("random", n=N, k=K)
    pipe = s.pipeline(None, sel, 4, arrays={"x": feats, "y": labs})
    assert pipe.seed == 9 and pipe.device == torch.device("cpu")
    assert pipe.resident["x"] is reg.get({"x": feats})["x"]
    ref = jsel.MiloSession(seed=9).pipeline(None, jsel.build_selector("random", n=N, k=K, seed=9),
                                            4, arrays={"x": feats, "y": labs})
    np.testing.assert_array_equal(pipe.epoch_indices(1), ref.epoch_indices(1))
    tr = Trainer(S._classifier_step_fn(1), pipe, TrainerConfig(epochs=1), fused=True, superstep=2)
    assert tr._resident_buffers() is pipe.resident
    with pytest.raises(ValueError, match="mirror"):
        tpipe.Pipeline(None, sel, 4, arrays={"x": feats}, resident={"y": torch.zeros(N)},
                       device="cpu")


# ---------------------------------------------------------------------------
# exploration types and the text dataset
# ---------------------------------------------------------------------------

def test_build_wre_against_the_reference():
    imp = np.random.default_rng(0).normal(size=500).astype(np.float32)
    ref = jexp.build_wre(jnp.asarray(imp))
    port = texp.build_wre(torch.from_numpy(imp))
    assert port.probs.dtype == port.importance.dtype == torch.float32
    np.testing.assert_allclose(port.probs.numpy(), np.asarray(ref.probs), **FP32)
    np.testing.assert_allclose(port.importance.numpy(), np.asarray(ref.importance), **FP32)
    np.testing.assert_allclose(texp.build_wre(imp.astype(np.float64)).probs.numpy(),
                               np.asarray(ref.probs), **FP32)
    # the draws are the port's own; with the reference's Gumbel draws they
    # are the reference's indices
    key = jax.random.PRNGKey(1)
    noise = np.asarray(jax.random.gumbel(key, (500,)))
    np.testing.assert_array_equal(port.sample(40, noise=noise).numpy(),
                                  np.asarray(ref.sample(key, 40)))
    gen = torch.Generator().manual_seed(0)
    draw = port.sample(40, generator=gen)
    assert len(set(draw.tolist())) == 40


def test_sge_bank_rotation_against_the_reference():
    subsets = np.random.default_rng(0).integers(0, 100, size=(5, 7)).astype(np.int32)
    ref, port = jexp.SGEBank(jnp.asarray(subsets)), texp.SGEBank(torch.from_numpy(subsets))
    assert port.n_subsets == ref.n_subsets == 5
    for R in (0, 1, 3):
        for e in range(17):
            np.testing.assert_array_equal(port.subset_for_epoch(e, R).numpy(),
                                          np.asarray(ref.subset_for_epoch(e, R)))


def test_synthetic_text_dataset_is_the_reference():
    kw = dict(n=60, n_classes=3, vocab=32, seq_len=12, seed=4)
    ref, port = jdata.SyntheticTextDataset(**kw), tdata.SyntheticTextDataset(**kw)
    np.testing.assert_array_equal(port.tokens, ref.tokens)
    np.testing.assert_array_equal(port.y, ref.y)
    assert port.tokens.dtype == ref.tokens.dtype and port.y.dtype == ref.y.dtype
    np.testing.assert_array_equal(port.features(), ref.features())
    for a, b in zip(port.split(), ref.split()):
        np.testing.assert_array_equal(a, b)
