"""Dispatch for the SSD chunk kernel: the chunk loop of the reference's
``ssd_scan`` (``repro/kernels/ssd_chunk/ops.py``), one kernel launch per
chunk for a tensor on the card, the plain version for a CPU tensor (or
``use_pallas=False``)."""
from __future__ import annotations

import torch

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
    """
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
