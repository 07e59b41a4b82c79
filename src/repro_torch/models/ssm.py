"""State-space mixer: Mamba in the SSD (Mamba-2) form — the port of the
Mamba part of ``repro/models/ssm.py``, forward only.

Recurrence (per head h, chunk length L):
    h_t = a_t h_{t-1} + (dt_t b_t) x_tᵀ        a_t = exp(-softplus(A) dt_t)
    y_t = c_tᵀ h_t

Prefill runs the chunked form: the plain version (``ssm_impl="chunked"``)
or the hand-written CUDA kernel, one launch per chunk (``"pallas"``).
Decode is the sequential one-token update, as in the reference.  mLSTM and
sLSTM are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.kernels.ssd_chunk.ref import ssd_scan_ref
from repro_torch.models.layers import init_dense


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + eˣ) as ``jax.nn.softplus`` computes it (logaddexp(x, 0))."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def init_mamba(gen, d_model: int, *, expand: int = 2, head_dim: int = 64, d_state: int = 128,
               dtype=torch.bfloat16) -> dict:
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    dev = gen.device
    return {
        "w_in": init_dense(gen, d_model, 2 * d_inner, dtype),       # x and gate z
        "w_bc": init_dense(gen, d_model, 2 * d_state, dtype),       # B and C
        "w_dt": init_dense(gen, d_model, n_heads, dtype),
        "a_log": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "w_out": init_dense(gen, d_inner, d_model, dtype),
        "norm": torch.ones((d_inner,), dtype=torch.float32, device=dev),
    }


def _ssd_chunk_scan(x, a, b, c, *, chunk: int, return_state: bool = False):
    """Chunked linear recurrence, plain version: x (B, S, H, P) values,
    a (B, S, H) decay in (0, 1], b and c (B, S, N) shared across heads.
    Returns y (B, S, H, P), and the final state (B, H, N, P) if asked."""
    y, h = ssd_scan_ref(x, a, b, c, chunk=chunk)
    return (y, h) if return_state else y


def mamba(params, x: torch.Tensor, *, chunk: int = 256, state: torch.Tensor | None = None,
          mode: str = "train", impl: str = "chunked") -> tuple[torch.Tensor, torch.Tensor | None]:
    """Mamba/SSD mixer over x (B, S, D).

    ``mode='decode'``: S == 1, one sequential state update against ``state``
    (B, H, N, P); returns (y, new_state).  ``prefill`` returns the final
    state, ``train`` None.
    """
    if impl not in ("chunked", "pallas"):
        raise ValueError(f"unknown ssm impl {impl!r}")
    B, S, D = x.shape
    d_inner = params["w_in"].shape[-1] // 2
    n_heads = params["w_dt"].shape[-1]
    P = d_inner // n_heads

    xz = x @ params["w_in"]
    xi, z = xz.chunk(2, dim=-1)
    bc = (x @ params["w_bc"]).float()
    b_proj, c_proj = bc.chunk(2, dim=-1)
    dt = _softplus((x @ params["w_dt"]).float() + params["dt_bias"])
    a = torch.exp(-_softplus(params["a_log"])[None, None, :] * dt)         # (B, S, H)
    xh = xi.reshape(B, S, n_heads, P).float() * dt[..., None]

    if mode == "decode":
        if state is None or S != 1:
            raise ValueError("decode mode takes one token and a state")
        h_new = a[:, 0, :, None, None] * state + torch.einsum("bn,bhp->bhnp", b_proj[:, 0], xh[:, 0])
        y = torch.einsum("bn,bhnp->bhp", c_proj[:, 0], h_new)[:, None]    # (B, 1, H, P)
        new_state = h_new
    elif impl == "pallas":
        y, h_fin = ssd_ops.ssd_scan(xh, a, b_proj, c_proj, chunk=chunk, use_pallas=True)
        new_state = h_fin if mode == "prefill" else None
    elif mode == "prefill":
        y, new_state = _ssd_chunk_scan(xh, a, b_proj, c_proj, chunk=chunk, return_state=True)
    else:
        y = _ssd_chunk_scan(xh, a, b_proj, c_proj, chunk=chunk)
        new_state = None

    y = y.reshape(B, S, d_inner)
    # gated RMS norm (Mamba-2 style)
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * params["norm"]
    y = y * F.silu(z.float())
    return y.to(x.dtype) @ params["w_out"], new_state


def mamba_state_shape(d_model: int, *, expand: int = 2, head_dim: int = 64, d_state: int = 128,
                      batch: int = 1):
    d_inner = expand * d_model
    h = d_inner // head_dim
    return (batch, h, d_state, head_dim)


def mlstm(*args, **kwargs):
    raise NotImplementedError("the mLSTM mixer is not ported yet (ROADMAP A12)")


def slstm(*args, **kwargs):
    raise NotImplementedError("the sLSTM mixer is not ported yet (ROADMAP A12)")
