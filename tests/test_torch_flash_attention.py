"""Port parity: the flash-attention kernel module of ``repro_torch`` against
the JAX reference.

On the CPU the port's dispatch takes its plain version; it is held against
the reference's oracle (``gqa_attention_ref``) and against its Pallas kernel
run in interpret mode (as ``tests/test_kernels.py`` runs it), over that
file's sweep — MHA, GQA, a ragged length, cross-length causal, one query
against a long cache — and non-causal, in f32 and bf16, at the reference's
tolerances.  The CUDA kernel itself is held against the plain version on the
card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention.ref import gqa_attention_ref as jref
from repro_torch.kernels.flash_attention import flash_attention as tfa_kernel
from repro_torch.kernels.flash_attention import ops as tfa_ops
from repro_torch.kernels.flash_attention.ref import gqa_attention_ref as tref

torch.set_num_threads(1)

# tests/test_kernels.py:91-118
SWEEP = [
    (1, 4, 4, 64, 64, 32),      # MHA
    (2, 8, 2, 128, 128, 32),    # GQA
    (2, 8, 2, 200, 200, 32),    # ragged seq
    (1, 4, 1, 64, 256, 64),     # cross-length causal (prefix)
    (4, 8, 4, 1, 333, 32),      # decode: 1 query vs long KV
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype_name):
    # the reference's kernel tolerances (tests/test_kernels.py:22)
    return dict(rtol=2e-2, atol=2e-2) if dtype_name == "bfloat16" else dict(rtol=1e-4, atol=2e-4)


def _qkv(seed, b, hq, hkv, sq, sk, d, dtype_name):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    jd, td = DTYPES[dtype_name]
    return [jnp.asarray(a, jd) for a in arrs], [torch.from_numpy(a).to(td) for a in arrs]


def _f32(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x.astype(jnp.float32))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", SWEEP)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
def test_flash_attention_plain_matches_reference(b, hq, hkv, sq, sk, d, dtype_name):
    (qj, kj, vj), (qt, kt, vt) = _qkv(sq * 3 + sk + d, b, hq, hkv, sq, sk, d, dtype_name)
    pallas = jfa_ops.flash_attention(qj, kj, vj, causal=True, interpret=True)
    oracle = jref(qj, kj, vj, causal=True).astype(qj.dtype)
    before = tfa_kernel.launches
    out = tfa_ops.flash_attention(qt, kt, vt, causal=True)
    assert tfa_kernel.launches == before, "a CPU tensor never launches the kernel"
    assert out.dtype == qt.dtype and tuple(out.shape) == (b, hq, sq, d)
    np.testing.assert_allclose(_f32(out), _f32(pallas), **_tol(dtype_name))
    np.testing.assert_allclose(_f32(out), _f32(oracle), **_tol(dtype_name))
    # the plain version in f32 is the reference's oracle to f32 rounding
    np.testing.assert_allclose(tref(qt, kt, vt, causal=True).numpy(),
                               np.asarray(jref(qj, kj, vj, causal=True)), rtol=1e-4, atol=2e-4)


def test_flash_attention_noncausal():
    (qj, kj, vj), (qt, kt, vt) = _qkv(7, 1, 2, 2, 100, 150, 16, "float32")
    out = tfa_ops.flash_attention(qt, kt, vt, causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(jfa_ops.flash_attention(
        qj, kj, vj, causal=False, interpret=True)), rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref(qj, kj, vj, causal=False)),
                               rtol=1e-4, atol=2e-4)


def test_flash_attention_reads_strided_inputs():
    """The model hands (B, S, H, D) activations over as transposed views: the
    result equals that of contiguous copies."""
    _, (qt, kt, vt) = _qkv(3, 2, 8, 2, 40, 40, 16, "float32")
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (qt, kt, vt)]
    assert not views[0].is_contiguous()
    np.testing.assert_array_equal(tfa_ops.flash_attention(*views).numpy(),
                                  tfa_ops.flash_attention(qt, kt, vt).numpy())


def test_flash_attention_use_pallas_false_is_the_plain_version():
    _, (qt, kt, vt) = _qkv(5, 1, 4, 2, 33, 33, 16, "bfloat16")
    np.testing.assert_array_equal(
        tfa_ops.flash_attention(qt, kt, vt, use_pallas=False).float().numpy(),
        tref(qt, kt, vt).to(torch.bfloat16).float().numpy())
