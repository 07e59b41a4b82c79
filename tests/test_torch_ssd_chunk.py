"""Port parity: the SSD chunk kernel module of ``repro_torch`` against the
JAX reference.

The plain chunk against the reference's oracle (``ssd_chunk_ref``) and its
Pallas kernel in interpret mode, over ``tests/test_ssd_kernel.py``'s sweep;
``ops.ssd_scan`` against the reference's ``ops.ssd_scan`` and the model's
``_ssd_chunk_scan`` at ragged lengths (the port runs a short last chunk
instead of padding it); the state carry composes.  Tolerance 1e-4, as in
``tests/test_ssd_kernel.py``.  The CUDA kernel itself is held against the
plain version on the card by ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_chunk import ops as jops
from repro.kernels.ssd_chunk.ref import ssd_chunk_ref as jref
from repro.kernels.ssd_chunk.ssd_chunk import ssd_chunk_pallas
from repro.models.ssm import _ssd_chunk_scan as j_scan
from repro_torch.kernels.ssd_chunk import ops as tops
from repro_torch.kernels.ssd_chunk import ssd_chunk as tkernel
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref as tref
from repro_torch.models.ssm import _ssd_chunk_scan as t_scan

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, B, L, H, P, N):
    rng = np.random.default_rng(seed)
    arrs = (
        rng.normal(size=(B, L, H, P)).astype(np.float32),
        rng.uniform(0.6, 1.0, size=(B, L, H)).astype(np.float32),
        rng.normal(size=(B, L, N)).astype(np.float32),
        rng.normal(size=(B, L, N)).astype(np.float32),
        rng.normal(size=(B, H, N, P)).astype(np.float32) * 0.1,
    )
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("B,L,H,P,N,bh", [
    (1, 8, 4, 4, 4, 4),
    (2, 16, 8, 8, 6, 4),
    (1, 32, 8, 4, 8, 8),
    (1, 64, 16, 16, 16, 8),     # the smoke configuration's widths
])
def test_ssd_chunk_plain_matches_reference(B, L, H, P, N, bh):
    jin, tin = _inputs(L * 7 + H + P + N, B, L, H, P, N)
    y_p, h_p = ssd_chunk_pallas(*jin, block_h=bh, interpret=True)
    y_r, h_r = jax.vmap(jref)(*jin)
    before = tkernel.launches
    y, h = tops.ssd_chunk(*tin)
    assert tkernel.launches == before, "a CPU tensor never launches the kernel"
    for ours, ref in ((y, y_p), (y, y_r), (h, h_p), (h, h_r)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("S,chunk", [(40, 8), (37, 16), (16, 16), (5, 8)])
def test_ssd_scan_matches_reference_scans(S, chunk):
    B, H, P, N = 2, 8, 4, 6
    (x, a, b, c, _), tin = _inputs(S + chunk, B, S, H, P, N)
    y_ref, h_ref = j_scan(x, a, b, c, chunk=chunk, return_state=True)
    y_p, h_p = jops.ssd_scan(x, a, b, c, chunk=chunk, use_pallas=True, block_h=4, interpret=True)
    y, h = tops.ssd_scan(*tin[:4], chunk=chunk)
    y_m, h_m = t_scan(*tin[:4], chunk=chunk, return_state=True)
    assert tuple(y.shape) == (B, S, H, P) and tuple(h.shape) == (B, H, N, P)
    for ours in ((y, h), (y_m, h_m)):
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(y_ref), **TOL)
        np.testing.assert_allclose(ours[1].numpy(), np.asarray(h_ref), **TOL)
        np.testing.assert_allclose(ours[0].numpy(), np.asarray(y_p), **TOL)
        np.testing.assert_allclose(ours[1].numpy(), np.asarray(h_p), **TOL)


def test_ssd_chunk_state_carry_composes():
    """Two chunks of the plain version == one double-length reference chunk."""
    B, L, H, P, N = 1, 8, 4, 4, 4
    jin, (x, a, b, c, h0) = _inputs(11, B, 2 * L, H, P, N)
    y_full, h_full = jax.vmap(jref)(*jin)
    y1, h1 = tref(x[:, :L], a[:, :L], b[:, :L], c[:, :L], h0)
    y2, h2 = tref(x[:, L:], a[:, L:], b[:, L:], c[:, L:], h1)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(), np.asarray(y_full), **TOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h_full), **TOL)


def test_short_last_chunk_equals_reference_padding():
    """The port runs a ragged last chunk as a shorter chunk; the reference
    pads it with a = 1 and b = c = x = 0.  Both give the same outputs."""
    B, L, H, P, N = 1, 16, 4, 4, 5
    _, (x, a, b, c, h0) = _inputs(13, B, 11, H, P, N)
    pad = L - 11
    xp = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
    ap = torch.nn.functional.pad(a, (0, 0, 0, pad), value=1.0)
    bp, cp = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (b, c))
    y_pad, h_pad = tref(xp, ap, bp, cp, h0)
    y, h = tref(x, a, b, c, h0)
    np.testing.assert_allclose(y.numpy(), y_pad[:, :11].numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(h.numpy(), h_pad.numpy(), rtol=1e-6, atol=1e-6)
