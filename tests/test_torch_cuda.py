"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without a card: a CUDA kernel
has no CPU mode.  The file imports torch, numpy and ``repro_torch`` only, so
it runs on a machine without JAX::

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import similarity as tsim
from repro_torch.kernels.similarity import ops as sim_ops
from repro_torch.kernels.similarity import similarity as sim_kernel
from repro_torch.kernels.similarity.ref import similarity_ref

# the sweep of tests/test_kernels.py plus the main path's ragged tile
SWEEP = [(64, 64, 16), (256, 256, 64), (300, 517, 48), (8, 1024, 128), (904, 5000, 768)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype_name):
    # the reference's kernel tolerances (tests/test_kernels.py)
    return dict(rtol=2e-2, atol=2e-2) if dtype_name == "bfloat16" else dict(rtol=1e-4, atol=2e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rows(rng, m, d, normalized, dev, dtype):
    z = rng.normal(size=(m, d)).astype(np.float32)
    if normalized:
        z /= np.linalg.norm(z, axis=1, keepdims=True)
    return torch.from_numpy(z).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("mq,mk,d", SWEEP)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("normalized", [False, True])
def test_similarity_kernel_matches_plain(cuda_device, mq, mk, d, dtype_name, normalized):
    rng = np.random.default_rng(mq + mk + d)
    zq = _rows(rng, mq, d, normalized, cuda_device, DTYPES[dtype_name])
    zk = _rows(rng, mk, d, normalized, cuda_device, DTYPES[dtype_name])
    before = sim_kernel.launches
    out = sim_ops.similarity(zq, zk, normalized=normalized)
    torch.cuda.synchronize()
    assert sim_kernel.launches == before + 1
    ref = similarity_ref(zq, zk, normalized=normalized)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(), **_tol(dtype_name))


@pytest.mark.cuda
def test_similarity_kernel_writes_into_strided_out(cuda_device):
    rng = np.random.default_rng(0)
    zq = _rows(rng, 70, 40, True, cuda_device, torch.float32)
    zk = _rows(rng, 130, 40, True, cuda_device, torch.float32)
    big = torch.full((128, 256), -1.0, device=cuda_device)
    sim_ops.similarity(zq, zk, normalized=True, out=big[:70, :130])
    ref = similarity_ref(zq, zk, normalized=True)
    np.testing.assert_allclose(big[:70, :130].cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=2e-4)
    assert (big[70:] == -1).all() and (big[:, 130:] == -1).all(), "nothing outside the view"


@pytest.mark.cuda
def test_similarity_kernel_rejects_bad_inputs(cuda_device):
    z = torch.ones((8, 4), device=cuda_device)
    with pytest.raises(TypeError):
        sim_ops.similarity(z.half(), z.half())
    with pytest.raises(ValueError):
        sim_ops.similarity(z.T, z)
    with pytest.raises(ValueError):
        sim_ops.similarity(z, z, out=torch.empty((8, 8), device=cuda_device).T)


@pytest.mark.cuda
def test_gram_blocked_kernel_route_matches_plain(cuda_device):
    z = torch.from_numpy(np.random.default_rng(4).normal(size=(700, 96)).astype(np.float32))
    z = z.to(cuda_device)
    before = sim_kernel.launches
    a = tsim.gram_matrix_blocked(z, block=256, use_pallas=True, n_pad=1024)
    assert sim_kernel.launches == before + 3
    b = tsim.gram_matrix_blocked(z, block=256, use_pallas=False, n_pad=1024)
    torch.cuda.synchronize()
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-4, atol=2e-4)
    assert not a[700:].any() and not a[:, 700:].any()
