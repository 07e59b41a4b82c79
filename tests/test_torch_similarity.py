"""Port parity: the similarity kernel module and ``core.similarity`` of
``repro_torch`` against the JAX reference.

On the CPU the port's wrapper takes its plain version; it is held against the
reference's Pallas kernel run in interpret mode (as ``tests/test_kernels.py``
runs it) over the same sweep, both ``normalized`` branches, fp32 and bf16,
at the reference's tolerances.  The CUDA kernel itself is held against the
plain version on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import similarity as jsim
from repro.kernels.similarity import ops as jsim_ops
from repro_torch.core import similarity as tsim
from repro_torch.kernels.similarity import ops as tsim_ops
from repro_torch.kernels.similarity import similarity as tsim_kernel
from repro_torch.kernels.similarity.ref import similarity_ref

# the suite runs in parallel workers beside wall-clock-sensitive tests:
# keep this file's PyTorch CPU work on one thread per worker
torch.set_num_threads(1)

SWEEP = [(64, 64, 16), (256, 256, 64), (300, 517, 48), (8, 1024, 128)]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype_name):
    # the reference's kernel tolerances (tests/test_kernels.py)
    return dict(rtol=2e-2, atol=2e-2) if dtype_name == "bfloat16" else dict(rtol=1e-4, atol=2e-4)


def _rows(rng, m, d, normalized):
    z = rng.normal(size=(m, d)).astype(np.float32)
    if normalized:
        z /= np.linalg.norm(z, axis=1, keepdims=True)
    return z


def _both(z, dtype_name):
    jd, td = DTYPES[dtype_name]
    return jnp.asarray(z, jd), torch.from_numpy(z).to(td)


@pytest.mark.parametrize("mq,mk,d", SWEEP)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("normalized", [False, True])
def test_similarity_plain_matches_reference_kernel(mq, mk, d, dtype_name, normalized):
    rng = np.random.default_rng(mq * 7 + mk + d)
    zq_j, zq_t = _both(_rows(rng, mq, d, normalized), dtype_name)
    zk_j, zk_t = _both(_rows(rng, mk, d, normalized), dtype_name)
    ref = np.asarray(jsim_ops.similarity(zq_j, zk_j, normalized=normalized, interpret=True))
    before = tsim_kernel.launches
    out = tsim_ops.similarity(zq_t, zk_t, normalized=normalized)
    assert tsim_kernel.launches == before, "a CPU tensor never launches the kernel"
    assert out.dtype == torch.float32 and tuple(out.shape) == (mq, mk)
    np.testing.assert_allclose(out.numpy(), ref, **_tol(dtype_name))


def test_similarity_plain_writes_into_strided_out():
    rng = np.random.default_rng(0)
    zq = torch.from_numpy(_rows(rng, 37, 16, True))
    zk = torch.from_numpy(_rows(rng, 50, 16, True))
    big = torch.zeros((64, 64))
    tsim_ops.similarity(zq, zk, normalized=True, out=big[:37, :50])
    np.testing.assert_array_equal(big[:37, :50].numpy(),
                                  similarity_ref(zq, zk, normalized=True).numpy())
    assert float(big[37:].abs().sum()) == 0.0 and float(big[:, 50:].abs().sum()) == 0.0


def _gram_tol(metric):
    # rbf's squared distances come from the expansion |q|² - 2q·k + |k|², whose
    # cancellation leaves a few fp32 ulps of |q|² + |k|² (~1e-5 at these
    # norms) in d2 whichever order the sums run; exp(-d2 / bandwidth) carries
    # that over, so rbf gets 1e-4 where the other metrics hold 1e-5
    return dict(rtol=1e-5, atol=1e-4 if metric == "rbf" else 1e-5)


@pytest.mark.parametrize("metric", ["cosine", "dot", "rbf"])
def test_gram_matrix_matches_reference(metric):
    rng = np.random.default_rng(1)
    z = rng.normal(size=(90, 24)).astype(np.float32)
    ref = np.asarray(jsim.gram_matrix(jnp.asarray(z), metric=metric))
    out = tsim.gram_matrix(torch.from_numpy(z), metric=metric).numpy()
    np.testing.assert_allclose(out, ref, **_gram_tol(metric))


@pytest.mark.parametrize("metric,use_pallas", [("cosine", False), ("cosine", True),
                                               ("dot", False), ("rbf", False)])
@pytest.mark.parametrize("n_pad", [None, 512])
def test_gram_matrix_blocked_matches_reference(metric, use_pallas, n_pad):
    """Ragged final tile (300 rows, blocks of 128); with ``n_pad`` the port
    writes the Gram into the top-left of a zero (n_pad, n_pad) matrix — the
    reference's blocked Gram followed by its ``jnp.pad``."""
    rng = np.random.default_rng(2)
    m = 300
    z = rng.normal(size=(m, 32)).astype(np.float32)
    ref = np.asarray(jsim.gram_matrix_blocked(jnp.asarray(z), metric=metric, block=128,
                                              use_pallas=use_pallas, interpret=True))
    if n_pad is not None:
        ref = np.pad(ref, ((0, n_pad - m), (0, n_pad - m)))
    out = tsim.gram_matrix_blocked(torch.from_numpy(z), metric=metric, block=128,
                                   use_pallas=use_pallas, n_pad=n_pad).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, **_gram_tol(metric))
    if n_pad is not None:
        assert not out[m:].any() and not out[:, m:].any(), "padding is exact zeros"


def test_zero_norm_rows_stay_exact_zero_rows():
    z = np.random.default_rng(3).normal(size=(12, 8)).astype(np.float32)
    z[[2, 7]] = 0.0
    zn_ref = np.asarray(jsim.normalize_rows(jnp.asarray(z)))
    zn = tsim.normalize_rows(torch.from_numpy(z)).numpy()
    assert not zn[[2, 7]].any()
    np.testing.assert_allclose(zn, zn_ref, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tsim.zero_norm_rows(torch.from_numpy(z)).numpy(),
                                  np.asarray(jsim.zero_norm_rows(jnp.asarray(z))))
    # a zero row scores exactly 0.5 against everything under the rescaled cosine
    K = tsim.gram_matrix_blocked(torch.from_numpy(z), block=5).numpy()
    assert np.all(K[2] == 0.5) and np.all(K[:, 7] == 0.5)


def test_copy_operands_pass_addressable_rows_and_copy_the_rest_exactly():
    """The dispatch's counted copy (``ops.copy_operands``): rows the kernel's
    4-element copies can address pass through as they are; a misaligned
    base or a non-contiguous view is copied exactly, and d % 4 != 0 pads
    both operands with zero columns."""
    z = torch.from_numpy(_rows(np.random.default_rng(5), 24, 12, True))
    before = tsim_ops.copies
    a, b = tsim_ops.copy_operands(z, z[:7])
    assert a is z and b.data_ptr() == z.data_ptr() and tsim_ops.copies == before
    buf = torch.zeros(24 * 12 + 1)
    off = buf[1:].view(24, 12)
    off.copy_(z)
    assert not tsim_kernel.copy_ready(off)
    a, b = tsim_ops.copy_operands(off, z)
    assert tsim_ops.copies == before + 1 and b is z, "only the misaligned operand"
    assert tsim_kernel.copy_ready(a) and torch.equal(a, z)
    col_major = z.T.contiguous().T
    a, b = tsim_ops.copy_operands(z, col_major)
    assert tsim_ops.copies == before + 2 and a is z
    assert b.is_contiguous() and torch.equal(b, z)
    a, b = tsim_ops.copy_operands(z[:, :11], z[:5, :11])
    assert tsim_ops.copies == before + 4 and a.shape == (24, 12) and b.shape == (5, 12)
    assert torch.equal(a[:, :11], z[:, :11]) and not a[:, 11:].any()
    # the kernel's k-ordered chain gives the same bits on the padded copy
    # (tests/test_torch_cuda.py); the CPU BLAS may block the longer product
    # differently, so here the plain version agrees to fp32 rounding
    for normalized in (False, True):
        np.testing.assert_allclose(similarity_ref(a, b, normalized=normalized).numpy(),
                                   similarity_ref(z[:, :11], z[:5, :11], normalized=normalized).numpy(),
                                   rtol=0, atol=1e-6)
    # inputs the kernel refuses pass through to its checks untouched
    h = z.half()
    assert tsim_ops.copy_operands(h, h)[0] is h and tsim_ops.copies == before + 4


def test_the_kernel_source_entry_points_match_the_bindings():
    """Each ctypes binding names a C entry point of ``csrc/similarity.cu``
    with as many parameters as it declares, and every entry point there is
    a binding or the launch's shared-memory report."""
    import re
    from pathlib import Path

    src = (Path(tsim_kernel.__file__).parents[2] / "csrc" / "similarity.cu").read_text()
    entries = {name: [p for p in params.split(",") if p.strip()]
               for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    bound = {name: tsim_kernel._ARGTYPES for name in tsim_kernel._ENTRY.values()}
    for name, argtypes in bound.items():
        assert len(entries[name]) == len(argtypes), name
    assert set(entries) == set(bound) | {"similarity_smem_bytes"}
