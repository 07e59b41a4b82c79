"""Dispatch for the SSD chunk kernel: the chunk loop of the reference's
``ssd_scan`` (``repro/kernels/ssd_chunk/ops.py``), one kernel launch per
chunk for a tensor on the card, the plain version for a CPU tensor (or
``use_pallas=False``).

**On DTensor shards** (a mesh ambient in the models) ``ssd_scan`` runs on
each rank's local shard.  The scan is independent across the batch and the
heads (b and c are shared by the heads), so those splits stay; a split of
the time axis, of P or of N, or a pending partial sum, is redistributed
first, and a and b, c follow x's batch and head splits.

**Fake tensors** (the dry run's ``FakeTensorMode``) take the kernel's meta
form, the custom op ``repro_torch::ssd_chunk``, once per chunk: its fake
implementation gives the shapes, and its FLOP formula
(``torch.utils.flop_counter``) is the bound's, B·(2L²N + L(L+1)·H·P +
4·L·N·H·P) a chunk.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.device import has_data
from repro_torch.kernels import _shards
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref, ssd_scan_ref
from repro_torch.kernels.ssd_chunk.ssd_chunk import ssd_chunk_cuda


def ssd_chunk(x, a, b, c, h_in, *, use_pallas: bool = True):
    """One chunk, batched: x (B, L, H, P), a (B, L, H), b and c (B, L, N),
    h_in (B, H, N, P) → (y, h_out)."""
    if not use_pallas or x.device.type == "cpu":
        return ssd_chunk_ref(x, a, b, c, h_in)
    return ssd_chunk_cuda(x, a, b, c, h_in)


def ssd_scan(x, a, b, c, *, chunk: int = 256, use_pallas: bool = True):
    """The whole sequence chunk by chunk (the semantics of the model's
    ``_ssd_chunk_scan``): x (B, S, H, P), a (B, S, H), b and c (B, S, N) →
    y (B, S, H, P) f32 and the final state (B, H, N, P) f32.

    On the card the state is carried in one preallocated pair of buffers
    (a chunk reads one and writes the other) and each chunk writes its rows
    of y in place; a short last chunk is masked by the kernel, not padded.
    DTensors run on their local shards, fake tensors take the meta form
    (module docstring).
    """
    if any(isinstance(t, DTensor) for t in (x, a, b, c)):
        return _on_shards(x, a, b, c, chunk=chunk, use_pallas=use_pallas)
    if use_pallas and not has_data(x):
        h = x.new_zeros((x.shape[0], x.shape[2], b.shape[-1], x.shape[3]), dtype=torch.float32)
        ys = []
        for t0 in range(0, x.shape[1], chunk):
            sl = slice(t0, t0 + chunk)
            y, h = torch.ops.repro_torch.ssd_chunk(x[:, sl], a[:, sl], b[:, sl], c[:, sl], h)
            ys.append(y)
        return torch.cat(ys, dim=1), h
    if not use_pallas or x.device.type == "cpu":
        return ssd_scan_ref(x, a, b, c, chunk=chunk)
    B, S, H, P = x.shape
    N = b.shape[-1]
    x, a, b, c = (t.float() for t in (x, a, b, c))
    y = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    h = torch.zeros((2, B, H, N, P), dtype=torch.float32, device=x.device)
    for i, t0 in enumerate(range(0, S, chunk)):
        sl = slice(t0, t0 + chunk)
        ssd_chunk_cuda(x[:, sl], a[:, sl], b[:, sl], c[:, sl], h[i % 2],
                       y=y[:, sl], h_out=h[(i + 1) % 2])
    return y, h[-(-S // chunk) % 2]


def _on_shards(x, a, b, c, *, chunk: int, use_pallas: bool):
    """``ssd_scan`` on each rank's local shard (module docstring): x (B, S,
    H, P), a (B, S, H), b and c (B, S, N) DTensors (a plain one counts as
    replicated).  Returns y (B, S, H, P) and the final state (B, H, N, P)."""
    mesh = next(t.device_mesh for t in (x, a, b, c) if isinstance(t, DTensor))
    x, a, b, c = (_shards.as_dtensor(t, mesh) for t in (x, a, b, c))
    xp = _shards.keep(x.placements, (0, 2))
    ap = _shards.follow(xp, {0: 0, 2: 2})
    bp = _shards.follow(xp, {0: 0})
    x, a = x.redistribute(mesh, xp), a.redistribute(mesh, ap)
    b, c = b.redistribute(mesh, bp), c.redistribute(mesh, bp)
    # b and c serve every head: where x's heads are split, each rank's
    # gradient of them is its own heads' part of a sum
    bg = _shards.partial_where_split(bp, xp, 2)
    y, h = ssd_scan(x.to_local(), a.to_local(), b.to_local(grad_placements=bg),
                    c.to_local(grad_placements=bg), chunk=chunk, use_pallas=use_pallas)
    return (_shards.to_global(y, mesh, xp),
            _shards.to_global(h, mesh, _shards.follow(xp, {0: 0, 2: 1})))


@torch.library.custom_op("repro_torch::ssd_chunk", mutates_args=())
def _ssd_chunk_op(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                  h_in: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """B6 as an operator: what ``ssd_chunk`` computes on real tensors."""
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, a, b, c, h_in)
    return ssd_chunk_cuda(x, a, b, c, h_in)


@_ssd_chunk_op.register_fake
def _(x, a, b, c, h_in):
    return (x.new_empty(x.shape, dtype=torch.float32),
            h_in.new_empty(h_in.shape, dtype=torch.float32))


def chunk_flops(bsz: int, length: int, heads: int, p: int, n: int) -> int:
    """FLOPs of one chunk (the bound's count): C·Bᵀ (2L²N), the decayed
    scores against X over the causal triangle (L(L+1)·H·P), and the two
    state products (4·L·N·H·P), for each batch row."""
    return bsz * (2 * length * length * n + length * (length + 1) * heads * p
                  + 4 * length * n * heads * p)


@register_flop_formula(torch.ops.repro_torch.ssd_chunk)
def _ssd_flops(x_shape, a_shape, b_shape, c_shape, h_shape, *args, out_shape=None,
               **kwargs) -> int:
    bsz, length, heads, p = x_shape
    return chunk_flops(bsz, length, heads, p, b_shape[-1])
