"""Plain PyTorch version of the SSD chunk kernel (Mamba-2 form): the CPU
path, the model's ``ssm_impl="chunked"`` route, and the oracle the CUDA
kernel is held against on the card."""
from __future__ import annotations

import torch


def ssd_chunk_ref(x, a, b, c, h_in):
    """One SSD chunk, batched: h_t = a_t h + b_t x_tᵀ, y_t = c_tᵀ h_t.

    x (B, L, H, P) values (dt pre-multiplied); a (B, L, H) per-head decay
    in (0, 1]; b, c (B, L, N) shared across heads; h_in (B, H, N, P).
    Returns y (B, L, H, P) and h_out (B, H, N, P), float32.
    """
    x, a, b, c, h_in = (t.float() for t in (x, a, b, c, h_in))
    L = x.shape[1]
    cum = torch.cumsum(torch.log(torch.clamp_min(a, 1e-20)), dim=1)      # (B, L, H)
    dt_mat = cum[:, :, None, :] - cum[:, None, :, :]                      # (B, L, L, H) t,s
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    decay = torch.where(tri[None, :, :, None], torch.exp(dt_mat), torch.zeros((), device=x.device))
    scores = torch.einsum("btn,bsn->bts", c, b)                           # (B, L, L)
    w = scores[..., None] * decay                                         # (B, L, L, H)
    y_intra = torch.einsum("btsh,bshp->bthp", w, x)
    y_inter = torch.einsum("btn,bhnp->bthp", c, h_in) * torch.exp(cum)[..., None]
    tot = cum[:, -1, :]                                                   # (B, H)
    rem = torch.exp(tot[:, None, :] - cum)                                # (B, L, H)
    h_out = torch.exp(tot)[..., None, None] * h_in + torch.einsum(
        "bsn,bshp->bhnp", b, x * rem[..., None])
    return y_intra + y_inter, h_out


def ssd_scan_ref(x, a, b, c, *, chunk: int = 256, h0=None):
    """The whole sequence, chunk by chunk, carrying the state: x (B, S, H, P),
    a (B, S, H), b, c (B, S, N) → y (B, S, H, P), final state (B, H, N, P).

    The last chunk is simply shorter: the reference pads it with a = 1 and
    b = c = x = 0, which adds exact zeros to the state and leaves cum alone.
    """
    B, S, H, P = x.shape
    N = b.shape[-1]
    h = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device) if h0 is None else h0
    ys = []
    for t0 in range(0, S, chunk):
        sl = slice(t0, t0 + chunk)
        y, h = ssd_chunk_ref(x[:, sl], a[:, sl], b[:, sl], c[:, sl], h)
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else x.new_zeros((B, 0, H, P), dtype=torch.float32)
    return y, h
