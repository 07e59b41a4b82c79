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


# ---------------------------------------------------------------------------
# The bf16 CUDA kernel's arithmetic, emulated here where the kernel cannot run
# ---------------------------------------------------------------------------

def _bf16_kernel_arithmetic(q, k, v, *, causal=True, p_parts=2):
    """What ``flash_attention_bf16`` computes, step for step in plain PyTorch
    (a test helper, on no path): 64-row warpgroup blocks, 128-key tiles in
    order, each ending at the block's last causal key; f32 scores (bf16
    products are exact in f32); online softmax with the masked logit -1e30;
    l summed from the f32 p; p·v with f32 accumulation, p as the kernel
    feeds it (``p_parts=2``: p_hi = bf16(p) plus p_lo = bf16(p - p_hi)), as
    one bf16 value (1) or in f32 (0).  Returns acc / max(l, 1e-30) in f32,
    before the output's own bf16 rounding."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    vf = v.float().repeat_interleave(hq // hkv, dim=1)
    scale, off = 1.0 / d ** 0.5, sk - sq
    out = torch.empty(b, hq, sq, d)
    for r0 in range(0, sq, 64):
        r = torch.arange(r0, min(r0 + 64, sq))
        wend = min(sk, int(r[-1]) + off + 1) if causal else sk
        m = torch.full((b, hq, len(r)), -1e30)
        l = torch.zeros(b, hq, len(r))
        acc = torch.zeros(b, hq, len(r), d)
        for k0 in range(0, wend, 128):
            c = torch.arange(k0, min(k0 + 128, sk))
            s = (q[:, :, r].float() @ kf[:, :, c].transpose(-1, -2)) * scale
            if causal:
                s = s.masked_fill(c[None, :] > r[:, None] + off, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = alpha * l + p.sum(-1)
            if p_parts:
                p_hi = p.bfloat16().float()
                p = p_hi + (p - p_hi).bfloat16().float() if p_parts == 2 else p_hi
            acc = acc * alpha[..., None] + p @ vf[:, :, c]
            m = m_new
        out[:, :, r] = acc / l.clamp_min(1e-30)[..., None]
    return out


@pytest.mark.parametrize("sq,sk", [(300, 300), (200, 457)])
def test_bf16_kernel_p_rounding_within_the_tolerance_argument(sq, sk):
    """yi-6b's heads (32 query, 4 kv, D 128) over a few hundred tokens, bf16
    inputs.  With p kept in f32 the emulation is the plain version to f32
    rounding.  One bf16 p (relative error <= 2^-8 on p in [0, 1]) moves
    acc / l by at most 2^-8 * max|v|, and the errors of different keys mostly
    cancel: the mean error stays below 1/20 of that worst case.  The
    kernel's two parts (relative error <= 2^-16) move it by at most
    2^-16 * max|v|."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(sq + 7 * sk, 1, 32, 4, sq, sk, 128, "bfloat16")
    ref = tref(qt, kt, vt)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref(qj, kj, vj)), rtol=1e-4, atol=2e-4)
    exact_p = _bf16_kernel_arithmetic(qt, kt, vt, p_parts=0)
    assert float((exact_p - ref).abs().max()) < 1e-5
    vmax = float(vt.float().abs().max())
    one = (_bf16_kernel_arithmetic(qt, kt, vt, p_parts=1) - ref).abs()
    assert float(one.max()) <= 2.0 ** -8 * vmax + 1e-5, (float(one.max()), vmax)
    assert float(one.mean()) <= 2.0 ** -8 * vmax / 20, (float(one.mean()), vmax)
    kernel = _bf16_kernel_arithmetic(qt, kt, vt)
    two = (kernel - ref).abs()
    assert float(two.max()) <= 2.0 ** -16 * vmax + 1e-5, (float(two.max()), vmax)
    # well inside the reference's bf16 tolerance (rtol = atol = 2e-2)
    np.testing.assert_allclose(kernel.numpy(), ref.numpy(), **_tol("bfloat16"))


# ---------------------------------------------------------------------------
# What the dispatch hands the bf16 kernel's TMA maps (device-independent)
# ---------------------------------------------------------------------------

def test_tma_operands_pass_the_models_views_through():
    """The model's (B, S, H, D) activations, seen as (B, H, S, D) views, and
    contiguous tensors are taken in place: no copy."""
    _, (qt, kt, vt) = _qkv(11, 2, 8, 2, 40, 40, 64, "bfloat16")
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (qt, kt, vt)]
    for args in ((qt, kt, vt), views):
        before = tfa_ops.copies
        out = tfa_ops.tma_operands(*args)
        assert tfa_ops.copies == before
        assert all(a is b for a, b in zip(out, args))
        assert all(tfa_kernel.tma_ready(t) for t in out)


def test_tma_operands_copy_a_misaligned_base_exactly():
    _, (qt, kt, vt) = _qkv(12, 1, 4, 2, 33, 33, 64, "bfloat16")
    flat = torch.empty(1 + qt.numel(), dtype=torch.bfloat16)
    qu = flat[1:].view(qt.shape)
    qu.copy_(qt)
    assert qu.data_ptr() % 16 and not tfa_kernel.tma_ready(qu)
    before = tfa_ops.copies
    q2, k2, v2 = tfa_ops.tma_operands(qu, kt, vt)
    assert tfa_ops.copies == before + 1 and k2 is kt and v2 is vt
    assert tfa_kernel.tma_ready(q2) and torch.equal(q2, qt)


def test_tma_operands_zero_pad_a_head_dim_off_a_multiple_of_8():
    """D = 36: all three become (.., 40) with zero columns, which add nothing
    to q·kᵀ (the dispatch passes the scale of D = 36 and slices the output)."""
    _, (qt, kt, vt) = _qkv(13, 1, 4, 2, 20, 20, 36, "bfloat16")
    before = tfa_ops.copies
    out = tfa_ops.tma_operands(qt, kt, vt)
    assert tfa_ops.copies == before + 3
    for o, t in zip(out, (qt, kt, vt)):
        assert o.shape[-1] == 40 and tfa_kernel.tma_ready(o)
        assert torch.equal(o[..., :36], t) and not o[..., 36:].any()
    np.testing.assert_allclose(tref(*out, scale=1 / 6.0)[..., :36].numpy(),
                               tref(qt, kt, vt).numpy(), rtol=1e-5, atol=1e-6)
