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


# ---------------------------------------------------------------------------
# the fl_gains family (csrc/fl_gains.cu) against its plain versions
# ---------------------------------------------------------------------------

from repro_torch.kernels.fl_gains import fl_gains as fl_kernel  # noqa: E402
from repro_torch.kernels.fl_gains import ops as fl_ops  # noqa: E402
from repro_torch.kernels.fl_gains import ref as fl_ref  # noqa: E402

# (n, n_cand, d): singletons, ragged tiles, odd depth, several 256-row chunks
FL_SWEEP = [(1, 1, 8), (65, 130, 7), (300, 517, 48), (257, 1, 100), (1000, 333, 768),
            (5000, 700, 100)]


def _fl_tol(n_rows):
    """fp32 sums of up to n_rows terms ≤ 1 in two orders (the kernel's
    chunked fp32 sum, the plain version's float64 running sum), each term's
    similarity from a different product order: rtol 1e-4 plus 2^-20 per row."""
    return dict(rtol=1e-4, atol=max(1e-5, n_rows * 2.0**-20))


def _fl_inputs(rng, n, n_cand, d, dev):
    z = _rows(rng, n, d, True, dev, torch.float32)
    zc = _rows(rng, n_cand, d, True, dev, torch.float32)
    c = torch.from_numpy(rng.uniform(size=n).astype(np.float32)).to(dev)
    c[torch.from_numpy(rng.random(n) < 0.2).to(dev)] = float("inf")
    c_new = torch.maximum(c, torch.from_numpy(rng.uniform(size=n).astype(np.float32)).to(dev))
    return z, zc, c, c_new


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_cand,d", FL_SWEEP)
def test_fl_gains_kernels_match_plain(cuda_device, n, n_cand, d):
    rng = np.random.default_rng(n * 7 + n_cand + d)
    z, zc, c, c_new = _fl_inputs(rng, n, n_cand, d, cuda_device)
    before = dict(fl_kernel.launches)
    g = fl_ops.fl_gains_gram_free(z, zc, c)
    dg = fl_ops.fl_gains_gram_free_delta(z, zc, c, c_new)
    K = fl_ref._sim(z, zc)
    gk = fl_ops.fl_gains(K, c)
    torch.cuda.synchronize()
    assert {k: fl_kernel.launches[k] - before[k] for k in before} == dict.fromkeys(before, 1)
    tol = _fl_tol(n)
    np.testing.assert_allclose(g.cpu().numpy(), fl_ref.fl_gains_gram_free_ref(z, zc, c).cpu().numpy(), **tol)
    np.testing.assert_allclose(dg.cpu().numpy(),
                               fl_ref.fl_gains_gram_free_delta_ref(z, zc, c, c_new).cpu().numpy(), **tol)
    np.testing.assert_allclose(gk.cpu().numpy(), fl_ref.fl_gains_ref(K, c).cpu().numpy(), **tol)
    assert not torch.isnan(dg).any() and (dg <= 0).all()


@pytest.mark.cuda
def test_fl_gains_kernels_order_properties(cuda_device):
    """Bit-identity the engines rely on: repeated launches, gains_at against
    gathered gains, the delta on a candidate slice against the full call,
    trailing +inf rows (two-level gathers), and a batch against single runs."""
    rng = np.random.default_rng(1)
    z, _, c, c_new = _fl_inputs(rng, 700, 1, 40, cuda_device)
    full = fl_ops.fl_gains_gram_free(z, z, c)
    assert torch.equal(full, fl_ops.fl_gains_gram_free(z, z, c))
    cand = torch.tensor([699, 0, 5, 5, 300, 64, 63], device=cuda_device)
    assert torch.equal(fl_ops.fl_gains_gram_free(z, z[cand], c), full[cand])
    rows = torch.arange(3, 700, 5, device=cuda_device)
    d_full = fl_ops.fl_gains_gram_free_delta(z[rows], z, c[rows], c_new[rows])
    assert torch.equal(fl_ops.fl_gains_gram_free_delta(z[rows], z[100:451], c[rows], c_new[rows]),
                       d_full[100:451])
    inf = torch.full((300,), float("inf"), device=cuda_device)
    padded = fl_ops.fl_gains_gram_free_delta(torch.cat([z[rows], z[:300]]), z,
                                             torch.cat([c[rows], inf]), torch.cat([c_new[rows], inf]))
    assert torch.equal(padded, d_full)
    covers = torch.stack([c, c_new])
    batch_cand = torch.stack([cand, cand.flip(0)])
    batched = fl_ops.fl_gains_gram_free(z, z[batch_cand], covers)
    assert torch.equal(batched[1], fl_ops.fl_gains_gram_free(z, z[batch_cand[1]], c_new))
    K = fl_ref._sim(z, z)
    dense = fl_ops.fl_gains(K, c)
    assert torch.equal(fl_ops.fl_gains(K[:, cand].contiguous(), c), dense[cand])
    assert torch.equal(fl_ops.fl_gains(K[:, :300], c), dense[:300]), "a row-strided K"


@pytest.mark.cuda
def test_fl_gains_kernels_reject_bad_inputs(cuda_device):
    z = torch.ones((8, 4), device=cuda_device)
    c = torch.zeros(8, device=cuda_device)
    with pytest.raises(TypeError):
        fl_ops.fl_gains_gram_free(z.double(), z.double(), c.double())
    with pytest.raises(ValueError):
        fl_ops.fl_gains_gram_free(z, z.T, c)
    with pytest.raises(ValueError):
        fl_ops.fl_gains_gram_free_delta(z, z, c[:3], c[:3])
    with pytest.raises(ValueError):
        fl_ops.fl_gains(torch.ones((8, 8), device=cuda_device).T[:, :4], c)


@pytest.mark.cuda
def test_lazy_engine_on_the_card(cuda_device):
    """The slice's engine on the card: two-level gathers are bit-identical,
    verify_argmax is index-exact against eager greedy, and the unverified
    cached gains follow eager greedy's gain sequence.  Their picks are not
    demanded index-exact: the cache drifts by ulps of the first gain
    (~500 here), enough to swap near-tied picks (rtol 1e-5 plus 4 such
    ulps on the gains)."""
    from repro_torch.core import greedy, gram_free

    rng = np.random.default_rng(2)
    z = _rows(rng, 1000, 64, True, cuda_device, torch.float32)
    fn = gram_free.make_gram_free_facility_location(use_pallas=True)
    eager = greedy.greedy(fn, z, 250)
    a = greedy.lazy_greedy(fn, z, 250, budget=125)
    b = greedy.lazy_greedy(fn, z, 250, budget=125, two_level=True)
    v = greedy.lazy_greedy(fn, z, 250, budget=125, two_level=True, verify_argmax=True)
    assert torch.equal(a.indices, b.indices) and torch.equal(a.gains, b.gains)
    assert torch.equal(v.indices, eager.indices)
    ulps = 4 * float(np.spacing(np.float32(eager.gains[0].item())))
    np.testing.assert_allclose(a.gains.cpu().numpy(), eager.gains.cpu().numpy(), rtol=1e-5, atol=ulps)


# ---------------------------------------------------------------------------
# the fixed FMA and summation order B1 and B3 keep bit for bit: B1 against
# B2's tile values, B3's two instances against each other and against the
# plain order sum over B2-built tile values
# ---------------------------------------------------------------------------


LEVELS = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024]


def _tiles(z, zc):
    """B2's tile values 0.5 + 0.5 <z_i, zc_j>: with one ground row at cover
    0 the gram-free kernel returns that row's similarities themselves."""
    zero = torch.zeros((1,), device=z.device)
    return torch.stack([fl_ops.fl_gains_gram_free(z[i:i + 1], zc, zero) for i in range(len(z))])


def _misaligned(t):
    """An equal copy of ``t`` whose base is 4 bytes off 16-byte alignment."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mq,mk,d", [(300, 517, 48), (129, 130, 100), (70, 1000, 37),
                                     (2048, 640, 768)])
def test_similarity_kernel_equals_gram_free_tiles(cuda_device, mq, mk, d):
    """B1 (fp32, normalized rows) into a row-strided out, ragged mq, mk and
    d (d = 37 through the dispatch's counted copy): every row bit-equal to
    B2's tile values, the same fmaf chain in k order."""
    rng = np.random.default_rng(mq + d)
    zq = _rows(rng, mq, d, True, cuda_device, torch.float32)
    zk = _rows(rng, mk, d, True, cuda_device, torch.float32)
    big = torch.full((mq + 3, mk + 29), -1.0, device=cuda_device)
    copies = sim_ops.copies
    sim_ops.similarity(zq, zk, normalized=True, out=big[:mq, :mk])
    assert sim_ops.copies == copies + (2 if d % 4 else 0)
    rows = torch.tensor(sorted({0, 1, mq // 2, mq - 1}), device=cuda_device)
    assert torch.equal(big[rows, :mk], _tiles(zq[rows], zk))
    assert (big[mq:] == -1).all() and (big[:, mk:] == -1).all(), "nothing outside the view"


@pytest.mark.cuda
@pytest.mark.parametrize("normalized", [False, True])
def test_similarity_bf16_equals_fp32_on_the_rounded_rows(cuda_device, normalized):
    rng = np.random.default_rng(11)
    zq = _rows(rng, 200, 72, normalized, cuda_device, torch.bfloat16)
    zk = _rows(rng, 333, 72, normalized, cuda_device, torch.bfloat16)
    assert torch.equal(sim_kernel.similarity_cuda(zq, zk, normalized=normalized),
                       sim_kernel.similarity_cuda(zq.float(), zk.float(), normalized=normalized))


@pytest.mark.cuda
@pytest.mark.parametrize("normalized", [False, True])
def test_similarity_copies_what_the_kernel_cannot_address_exactly(cuda_device, normalized):
    """A misaligned base, a column-major view and d % 4 != 0 each go
    through one counted copy, and give the kernel's output on an aligned
    (zero-padded) copy made by hand, bit for bit; the wrapper itself
    refuses them."""
    rng = np.random.default_rng(12)
    zq = _rows(rng, 150, 64, normalized, cuda_device, torch.float32)
    zk = _rows(rng, 90, 64, normalized, cuda_device, torch.float32)
    want = sim_kernel.similarity_cuda(zq, zk, normalized=normalized)
    copies = sim_ops.copies
    assert torch.equal(sim_ops.similarity(_misaligned(zq), zk, normalized=normalized), want)
    assert torch.equal(sim_ops.similarity(zq, zk.T.contiguous().T, normalized=normalized), want)
    assert sim_ops.copies == copies + 2
    with pytest.raises(ValueError):
        sim_kernel.similarity_cuda(_misaligned(zq), zk, normalized=normalized)
    q, k = zq[:, :61].contiguous(), zk[:, :61].contiguous()
    padded = sim_kernel.similarity_cuda(torch.nn.functional.pad(q, (0, 3)),
                                        torch.nn.functional.pad(k, (0, 3)), normalized=normalized)
    assert torch.equal(sim_ops.similarity(q, k, normalized=normalized), padded)
    assert sim_ops.copies == copies + 4
    with pytest.raises(ValueError):
        sim_kernel.similarity_cuda(q, k, normalized=normalized)


@pytest.mark.cuda
@pytest.mark.parametrize("b", LEVELS + [3, 17, 63, 65])
def test_delta_instances_bit_equal_across_the_edge(cuda_device, b):
    """B3 at b touched rows: the instance the C entry point launches (it
    reports small-b up to 64, tiled above) equals the other instance (a
    misaligned zc or z takes the tiled one), the same rows padded with +inf
    rows to every larger gather level and to the 1024 budget, a candidate
    slice, and the plain order sum over B2-built tile values — bit for bit."""
    rng = np.random.default_rng(b)
    d, n_cand = 100, 777
    z, zc, c, c_new = _fl_inputs(rng, b, n_cand, d, cuda_device)

    def launched(*args):
        before = dict(fl_kernel.delta_launches)
        out = fl_ops.fl_gains_gram_free_delta(*args)
        return out, [k for k in before if fl_kernel.delta_launches[k] - before[k] == 1]

    base, inst = launched(z, zc, c, c_new)
    assert inst == (["small_b"] if b <= 64 else ["tiled"])
    for args in ((z, _misaligned(zc), c, c_new), (_misaligned(z), zc, c, c_new)):
        other, inst = launched(*args)
        assert inst == ["tiled"]
        assert torch.equal(base, other)
    for size in [lv for lv in LEVELS if lv > b]:
        pad = size - b
        inf = torch.full((pad,), float("inf"), device=cuda_device)
        padded = fl_ops.fl_gains_gram_free_delta(torch.cat([z, zc.repeat(2, 1)[:pad]]), zc,
                                                 torch.cat([c, inf]), torch.cat([c_new, inf]))
        assert torch.equal(padded, base), size
    assert torch.equal(fl_ops.fl_gains_gram_free_delta(z, zc[100:451], c, c_new), base[100:451])
    K = _tiles(z, zc)
    terms = torch.relu(K - c_new[:, None]) - torch.relu(K - c[:, None])
    assert torch.equal(fl_ref.delta_order_sum(terms.cpu()), base.cpu())


# ---------------------------------------------------------------------------
# B2's ring instance against its tiled instance, bit for bit: the tiled
# instance is reached by a z 4 bytes off 16-byte alignment or by d % 4 != 0
# ---------------------------------------------------------------------------


def _gram_free(z, zc, c):
    """B2's gains and the instance its C entry point reported launching."""
    before = dict(fl_kernel.gram_free_launches)
    out = fl_ops.fl_gains_gram_free(z, zc, c)
    return out, [k for k in before if fl_kernel.gram_free_launches[k] - before[k] == 1]


def _ring_equals_tiled(z, zc, c):
    """B2 on the ring instance, held bit-equal to the tiled instance on a
    misaligned copy of z; returns the ring instance's gains."""
    ring, inst = _gram_free(z, zc, c)
    assert inst == ["ring"]
    tiled, inst = _gram_free(_misaligned(z), zc, c)
    assert inst == ["tiled"]
    assert torch.equal(ring, tiled)
    return ring


def _dead(c, rows):
    """A copy of the covers ``c`` ([B,] n) with ``rows`` set to +inf."""
    c = c.clone()
    c[..., rows] = float("inf")
    return c


# (n, n_cand, d): n = 1 (as ``_tiles`` calls it), one chunk (n <= 256: no
# scratch), several chunks with a ragged last tile; ragged n_cand against the
# 128 candidates of a block; d = 36 and 100 run past a 32-deep slab and end
# in a partial one, 768 is the path's depth
B2_SHAPES = [(1, 1, 36), (1, 300, 100), (200, 517, 36), (256, 130, 100), (257, 129, 36),
             (700, 333, 100), (1000, 1000, 768)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_cand,d", B2_SHAPES)
def test_gram_free_ring_instance_equals_tiled(cuda_device, n, n_cand, d):
    rng = np.random.default_rng(n + 3 * n_cand + d)
    z, zc, c, _ = _fl_inputs(rng, n, n_cand, d, cuda_device)
    out = _ring_equals_tiled(z, zc, c)
    np.testing.assert_allclose(out.cpu().numpy(),
                               fl_ref.fl_gains_gram_free_ref(z, zc, c).cpu().numpy(), **_fl_tol(n))


@pytest.mark.cuda
def test_gram_free_tiled_instance_at_odd_depth_equals_ring_on_padded_rows(cuda_device):
    """d = 37 takes the tiled instance; the same rows zero-padded to d = 40
    take the ring instance and give the same bits (zero k add fmaf(0, 0,
    acc) = acc)."""
    rng = np.random.default_rng(37)
    z, zc, c, _ = _fl_inputs(rng, 700, 333, 37, cuda_device)
    odd, inst = _gram_free(z, zc, c)
    assert inst == ["tiled"]
    pad = torch.nn.functional.pad
    even, inst = _gram_free(pad(z, (0, 3)), pad(zc, (0, 3)), c)
    assert inst == ["ring"]
    assert torch.equal(odd, even)


# all-+inf 128-row tiles (rows) in a ground set of 1280 rows (5 chunks of two
# tiles): the first tile of a chunk with live rows after it, a chunk's last
# tile, a whole chunk, the bucketed padding past 1000 live rows (zero rows at
# +inf, as the gram-free path pads a class), all of these at once, and a run
# of +inf rows that covers no whole tile (nothing is left out)
DEAD = {"chunk_first_tile": list(range(256, 384)), "chunk_last_tile": list(range(640, 768)),
        "whole_chunk": list(range(512, 768)), "bucket_padding": list(range(1000, 1280)),
        "all": list(range(256, 384)) + list(range(512, 768)) + list(range(1000, 1280)),
        "no_whole_tile": list(range(300, 500))}


@pytest.mark.cuda
@pytest.mark.parametrize("placement", sorted(DEAD))
def test_gram_free_ring_instance_leaves_out_dead_tiles_exactly(cuda_device, placement):
    """The ring instance leaves out the k-loop of a tile whose covers are all
    +inf; the tiled instance contracts it.  Both agree bit for bit, with the
    plain fixed-order sum over B2's tile values, with gains_at and with each
    cover of a batch (a shared and a batched zc) run alone."""
    rng = np.random.default_rng(len(DEAD[placement]))
    n, d = 1280, 100
    z, _, c, _ = _fl_inputs(rng, n, 1, d, cuda_device)
    rows = torch.tensor(DEAD[placement], device=cuda_device)
    if placement in ("bucket_padding", "all"):
        z[1000:] = 0.0
    c = _dead(c, rows)
    full = _ring_equals_tiled(z, z, c)
    K = _tiles(z, z)
    assert torch.equal(fl_ref.delta_order_sum(torch.relu(K - c[:, None]).cpu()), full.cpu())
    cand = torch.tensor([1279, 0, 5, 5, 300, 1000, 999, 128, 127], device=cuda_device)
    assert torch.equal(_ring_equals_tiled(z, z[cand], c), full[cand])
    covers = torch.stack([c, _dead(c, torch.arange(0, 384, device=cuda_device))])
    shared = _ring_equals_tiled(z, z[cand], covers)
    batched = _ring_equals_tiled(z, torch.stack([z[cand], z[cand.flip(0)]]), covers)
    assert torch.equal(shared[0], full[cand]) and torch.equal(batched[0], full[cand])
    assert torch.equal(shared[1], _ring_equals_tiled(z, z[cand], covers[1]))
    assert torch.equal(batched[1], _ring_equals_tiled(z, z[cand.flip(0)], covers[1]))


@pytest.mark.cuda
def test_gram_free_chunk_without_a_finite_cover_is_plus_zero(cuda_device):
    """A ground set whose covers are all +inf: every chunk is left out and
    writes +0.f, as the tiled instance sums its exact zeros."""
    rng = np.random.default_rng(5)
    z, zc, c, _ = _fl_inputs(rng, 600, 200, 36, cuda_device)
    out = _ring_equals_tiled(z, zc, torch.full_like(c, float("inf")))
    assert not out.any() and not torch.signbit(out).any()


# ---------------------------------------------------------------------------
# flash attention (csrc/flash_attention.cu) and the SSD chunk
# (csrc/ssd_chunk.cu) against their plain versions
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention import flash_attention as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import gqa_attention_ref  # noqa: E402
from repro_torch.kernels.ssd_chunk import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd_chunk import ssd_chunk as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref, ssd_scan_ref  # noqa: E402

# tests/test_kernels.py's sweep, plus D = 128 at a ragged length and one
# query row against a long cache with the model's head counts; then the bf16
# kernel's tile edges (128 query rows, 128-key tiles, 64-column panels):
# lengths on either side of one and two tiles, causal query blocks that start
# mid key tile (Sk > Sq), and a head dim that is not a multiple of 8 (bf16:
# zero-padded to 40 by three counted copies)
FA_SWEEP = [(1, 4, 4, 64, 64, 32), (2, 8, 2, 128, 128, 32), (2, 8, 2, 200, 200, 32),
            (1, 4, 1, 64, 256, 64), (4, 8, 4, 1, 333, 32), (1, 32, 4, 301, 301, 128),
            (1, 8, 1, 5, 130, 128),
            (1, 4, 2, 127, 127, 64), (1, 4, 2, 128, 128, 128), (1, 4, 2, 129, 129, 128),
            (2, 4, 1, 255, 255, 64), (1, 8, 2, 257, 257, 128), (1, 4, 2, 129, 257, 128),
            (1, 8, 4, 200, 255, 64), (1, 4, 2, 100, 100, 36)]


def _qkv(rng, b, hq, hkv, sq, sk, d, dev, dtype):
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev, dtype)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", FA_SWEEP)
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel_matches_plain(cuda_device, b, hq, hkv, sq, sk, d, dtype_name,
                                              causal):
    rng = np.random.default_rng(sq * 3 + sk + d)
    q, k, v = _qkv(rng, b, hq, hkv, sq, sk, d, cuda_device, DTYPES[dtype_name])
    before, copies = fa_kernel.launches, fa_ops.copies
    out = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_kernel.launches == before + 1 and out.dtype == q.dtype
    assert tuple(out.shape) == (b, hq, sq, d)
    padded = dtype_name == "bfloat16" and d % 8
    assert fa_ops.copies == copies + (3 if padded else 0), "only a padded head dim copies"
    ref = gqa_attention_ref(q, k, v, causal=causal).to(q.dtype)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol(dtype_name))
    assert torch.equal(out, fa_ops.flash_attention(q, k, v, causal=causal)), "repeat bit-equal"


@pytest.mark.cuda
def test_flash_attention_kernel_strided_and_refusals(cuda_device):
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, 2, 8, 2, 70, 70, 64, cuda_device, torch.bfloat16)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    out = fa_ops.flash_attention(*views)
    assert torch.equal(out, fa_ops.flash_attention(q, k, v))
    assert out.transpose(1, 2).is_contiguous(), "the output is laid out like q"
    with pytest.raises(ValueError):
        fa_ops.flash_attention(*_qkv(rng, 1, 2, 2, 8, 8, 256, cuda_device, torch.float32))
    with pytest.raises(ValueError):
        fa_ops.flash_attention(*_qkv(rng, 1, 2, 2, 9, 8, 16, cuda_device, torch.float32))
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.half(), k.half(), v.half())


@pytest.mark.cuda
def test_flash_attention_kernel_copies_views_tma_cannot_take(cuda_device):
    """A bf16 view whose base is off 16-byte alignment goes through one
    counted contiguous copy and still launches the kernel; the kernel itself
    refuses it."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 4, 2, 70, 70, 64, cuda_device, torch.bfloat16)
    flat = torch.empty(1 + q.numel(), dtype=torch.bfloat16, device=cuda_device)
    qu = flat[1:].view(q.shape)
    qu.copy_(q)
    assert qu.data_ptr() % 16 and not fa_kernel.tma_ready(qu)
    before, copies = fa_kernel.launches, fa_ops.copies
    out = fa_ops.flash_attention(qu, k, v)
    torch.cuda.synchronize()
    assert fa_kernel.launches == before + 1 and fa_ops.copies == copies + 1
    assert torch.equal(out, fa_ops.flash_attention(q, k, v)), "the copy is exact"
    ref = gqa_attention_ref(q, k, v).to(torch.bfloat16)
    np.testing.assert_allclose(out.float().cpu().numpy(), ref.float().cpu().numpy(),
                               **_tol("bfloat16"))
    with pytest.raises(ValueError):
        fa_kernel.flash_attention_cuda(qu, k, v)


def _ssd_inputs(rng, B, L, H, P, N, dev):
    arrs = (rng.normal(size=(B, L, H, P)), rng.uniform(0.6, 1.0, size=(B, L, H)),
            rng.normal(size=(B, L, N)), rng.normal(size=(B, L, N)),
            rng.normal(size=(B, H, N, P)) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,N", [(1, 8, 4, 4, 4), (2, 16, 8, 8, 6), (1, 64, 16, 16, 16),
                                       (1, 100, 6, 64, 128), (2, 256, 9, 33, 70)])
def test_ssd_chunk_kernel_matches_plain(cuda_device, B, L, H, P, N):
    rng = np.random.default_rng(L + H + P + N)
    x, a, b, c, h = _ssd_inputs(rng, B, L, H, P, N, cuda_device)
    before = ssd_kernel.launches
    y, h_out = ssd_ops.ssd_chunk(x, a, b, c, h)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + 1
    y_r, h_r = ssd_chunk_ref(x, a, b, c, h)
    np.testing.assert_allclose(y.cpu().numpy(), y_r.cpu().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h_out.cpu().numpy(), h_r.cpu().numpy(), rtol=1e-4, atol=1e-4)
    y2, h2 = ssd_ops.ssd_chunk(x, a, b, c, h)
    assert torch.equal(y, y2) and torch.equal(h_out, h2), "repeat bit-equal"


@pytest.mark.cuda
@pytest.mark.parametrize("S,chunk", [(40, 8), (37, 16), (300, 64), (5, 8)])
def test_ssd_scan_kernel_matches_plain(cuda_device, S, chunk):
    rng = np.random.default_rng(S + chunk)
    x, a, b, c, _ = _ssd_inputs(rng, 2, S, 8, 16, 12, cuda_device)
    before = ssd_kernel.launches
    y, h = ssd_ops.ssd_scan(x, a, b, c, chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_kernel.launches == before + -(-S // chunk)
    y_r, h_r = ssd_scan_ref(x, a, b, c, chunk=chunk)
    np.testing.assert_allclose(y.cpu().numpy(), y_r.cpu().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h.cpu().numpy(), h_r.cpu().numpy(), rtol=1e-4, atol=1e-4)


# the SSD chunk's instances: mma (3xTF32 on the tensor cores) for every call
# whose loads cp.async can address, simt (today's CUDA-core kernel) else.
# Edges of the mma instance: L on either side of its 64-row tiles and at its
# 256-row cap, a ragged 245, head counts that are not a multiple of its
# 8-head groups, P 16 and 64, N 64 and 128, B 2
SSD_MMA_CASES = [(1, 1, 8, 64, 128), (1, 63, 10, 64, 128), (1, 64, 8, 16, 64),
                 (1, 65, 12, 64, 128), (1, 245, 16, 64, 128), (1, 256, 8, 64, 128),
                 (2, 256, 10, 16, 128), (2, 65, 3, 64, 64), (2, 200, 17, 16, 64)]


def _ssd_run(args, instance):
    """One launch on ``args``: the instance it reported must be ``instance``;
    the outputs match the plain version at the reference's 1e-4 and a second
    launch gives the same bits."""
    before = dict(ssd_kernel.instance_launches)
    y, h_out = ssd_kernel.ssd_chunk_cuda(*args)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in ssd_kernel.instance_launches.items()}
    assert ran == {k: int(k == instance) for k in ran}, ran
    y_r, h_r = ssd_chunk_ref(*args)
    np.testing.assert_allclose(y.cpu().numpy(), y_r.cpu().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h_out.cpu().numpy(), h_r.cpu().numpy(), rtol=1e-4, atol=1e-4)
    y2, h2 = ssd_kernel.ssd_chunk_cuda(*args)
    assert torch.equal(y, y2) and torch.equal(h_out, h2), "repeat bit-equal"
    return y, h_out


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,P,N", SSD_MMA_CASES)
def test_ssd_chunk_mma_instance_matches_plain(cuda_device, B, L, H, P, N):
    rng = np.random.default_rng(3 * L + H + P + N + B)
    _ssd_run(_ssd_inputs(rng, B, L, H, P, N, cuda_device), "mma")


@pytest.mark.cuda
def test_ssd_chunk_mma_instance_on_the_models_views(cuda_device):
    """b and c as the two halves of one (B, S, 2N) projection, chunk slices
    of a longer sequence (the last one ragged), y written into the whole
    sequence's output: every launch on the mma instance."""
    rng = np.random.default_rng(5)
    B, S, H, P, N = 2, 600, 10, 64, 128
    x, a, _, _, _ = _ssd_inputs(rng, B, S, H, P, N, cuda_device)
    bc = torch.from_numpy(rng.normal(size=(B, S, 2 * N)).astype(np.float32)).to(cuda_device)
    b, c = bc.chunk(2, dim=-1)
    h = torch.from_numpy(0.1 * rng.normal(size=(B, H, N, P)).astype(np.float32)).to(cuda_device)
    for t0 in (0, 256, 512):
        sl = slice(t0, t0 + 256)
        _ssd_run((x[:, sl], a[:, sl], b[:, sl], c[:, sl], h), "mma")
    before = dict(ssd_kernel.instance_launches)
    y, h_fin = ssd_ops.ssd_scan(x, a, b, c, chunk=256)
    torch.cuda.synchronize()
    assert ssd_kernel.instance_launches["mma"] - before["mma"] == 3
    assert ssd_kernel.instance_launches["simt"] == before["simt"]
    y_r, h_r = ssd_scan_ref(x, a, b, c, chunk=256)
    np.testing.assert_allclose(y.cpu().numpy(), y_r.cpu().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(h_fin.cpu().numpy(), h_r.cpu().numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ssd_chunk_views_cp_async_cannot_address_run_the_simt_instance(cuda_device):
    """A base 4 bytes off 16-byte alignment, or a row stride that is not a
    multiple of 4 floats, reaches the simt instance, which the report says;
    the two instances agree at the tolerance."""
    rng = np.random.default_rng(6)
    x, a, b, c, h = _ssd_inputs(rng, 1, 100, 8, 64, 128, cuda_device)
    y, h_out = _ssd_run((x, a, b, c, h), "mma")
    for args in ((_misaligned(x), a, b, c, h), (x, a, b, c, _misaligned(h))):
        y_s, h_s = _ssd_run(args, "simt")
        np.testing.assert_allclose(y_s.cpu().numpy(), y.cpu().numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(h_s.cpu().numpy(), h_out.cpu().numpy(), rtol=1e-4, atol=1e-4)
    wide = torch.zeros((1, 100, 130), device=cuda_device)
    wide[..., :128] = b
    _ssd_run((x, a, wide[..., :128], c, h), "simt")


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["normal", "large_c", "small_products", "spread_exponents",
                                    "zero_c"])
def test_tensor_core_sum_equals_its_model(cuda_device, regime):
    """One ``mma.sync.m16n8k8`` TF32 per tile on the card equals
    ``tf32.mma_sum`` bit for bit: the terms cut toward zero to 2^(E − 25),
    the sum rounded toward zero (not to nearest)."""
    from repro_torch.kernels.ssd_chunk import tf32

    rng = np.random.default_rng(["normal", "large_c", "small_products", "spread_exponents",
                                 "zero_c"].index(regime))
    T = 512
    a, b, c = rng.normal(size=(T, 16, 8)), rng.normal(size=(T, 8, 8)), rng.normal(size=(T, 16, 8))
    if regime == "large_c":
        c = 100 * c
    elif regime == "small_products":
        a = 1e-3 * a
    elif regime == "spread_exponents":
        a, b, c = (u * 2.0 ** rng.integers(-12, 12, size=u.shape) for u in (a, b, c))
    elif regime == "zero_c":
        c = 0 * c
    a, b = tf32.tf32(a.astype(np.float32)), tf32.tf32(b.astype(np.float32))
    c = c.astype(np.float32)
    d = ssd_kernel.mma_probe_cuda(*(torch.from_numpy(u).to(cuda_device) for u in (a, b, c)))
    np.testing.assert_array_equal(d.cpu().numpy().view(np.uint32),
                                  tf32.mma_sum(a, b, c).view(np.uint32))
