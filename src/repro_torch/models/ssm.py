"""State-space and recurrent mixers — the port of ``repro/models/ssm.py``:
Mamba in the SSD (Mamba-2) form, xLSTM's mLSTM and sLSTM.

Recurrence (per head h, chunk length L):
    h_t = a_t h_{t-1} + (dt_t b_t) x_tᵀ        a_t = exp(-softplus(A) dt_t)
    y_t = c_tᵀ h_t

Mamba's prefill runs the chunked form: the plain version
(``ssm_impl="chunked"``) or the hand-written CUDA kernel, one launch per
chunk (``"pallas"``).  The mLSTM's matrix memory C_t = f_t C + i_t v kᵀ is
the same recurrence with N = P and b, c per head; it runs the plain chunked
scan, as in the reference (no kernel).  The sLSTM is a sequential
recurrence, a Python loop over time here (the reference's ``lax.scan``).
Decode is the sequential one-token update of each, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import _shards
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
    if impl == "pallas" and mode != "decode" and torch.is_grad_enabled() and (
            x.requires_grad or any(t.requires_grad for t in params.values())):
        raise NotImplementedError(
            "ssm_impl='pallas' has no backward (the CUDA SSD chunk kernel is forward only); "
            "train with 'chunked'")
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
    elif impl == "pallas" or isinstance(xh, DTensor):
        # DTensors (under a mesh) scan each rank's local shard, by either route
        y, h_fin = ssd_ops.ssd_scan(xh, a, b_proj, c_proj, chunk=chunk,
                                    use_pallas=impl == "pallas")
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


# --- xLSTM ------------------------------------------------------------------

def init_mlstm(gen, d_model: int, *, expand: int = 2, head_dim: int = 64,
               dtype=torch.bfloat16) -> dict:
    """The reference's ``init_mlstm``: the gate matrices are f32."""
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    dev = gen.device
    return {
        "wq": init_dense(gen, d_model, d_inner, dtype),
        "wk": init_dense(gen, d_model, d_inner, dtype),
        "wv": init_dense(gen, d_model, d_inner, dtype),
        "w_fgate": init_dense(gen, d_model, n_heads, torch.float32),
        "w_igate": init_dense(gen, d_model, n_heads, torch.float32),
        "w_z": init_dense(gen, d_model, d_inner, dtype),   # output gate source
        "w_out": init_dense(gen, d_inner, d_model, dtype),
        "norm": torch.ones((d_inner,), dtype=torch.float32, device=dev),
    }


def _ssd_chunk_scan_per_head(x, a, b, c, *, chunk: int):
    """``_ssd_chunk_scan`` with b and c per head: x (B, S, H, P), a (B, S, H),
    b, c (B, S, H, N).  The heads fold into the batch (the reference vmaps
    the scan over them).  Returns y (B, S, H, P) and the final state
    (B, H, N, P)."""
    B, S, H, P = x.shape
    N = b.shape[-1]

    def fold(t):  # (B, S, H, ...) -> (B·H, S, ...)
        return t.transpose(1, 2).reshape(B * H, S, *t.shape[3:])

    y, h = ssd_scan_ref(fold(x)[:, :, None], fold(a)[:, :, None], fold(b), fold(c), chunk=chunk)
    return y[:, :, 0].reshape(B, H, S, P).transpose(1, 2), h[:, 0].reshape(B, H, N, P)


def _mlstm_step(vals, f, k, q, *, state):
    """One mLSTM token (S == 1) from ``state`` (B, H, P, P): (y (B, 1, H,
    P), the new state)."""
    h_new = f[:, 0, :, None, None] * state + torch.einsum("bhn,bhp->bhnp", k[:, 0], vals[:, 0])
    return torch.einsum("bhn,bhnp->bhp", q[:, 0], h_new)[:, None], h_new


def mlstm(params, x: torch.Tensor, *, chunk: int = 256, state: torch.Tensor | None = None,
          mode: str = "train") -> tuple[torch.Tensor, torch.Tensor | None]:
    """mLSTM matrix-memory mixer over x (B, S, D): C_t = f_t C_{t-1} +
    i_t v_t k_tᵀ, y_t = C_t q_t — the linear recurrence with a = f (a
    sigmoid), values i·v, b = k (scaled by 1/√P), c = q, per head, N = P.

    ``mode='decode'``: S == 1, one update of ``state`` (B, H, P, P).
    ``prefill`` returns the final state, ``train`` None."""
    B, S, D = x.shape
    d_inner = params["wq"].shape[-1]
    n_heads = params["w_fgate"].shape[-1]
    P = d_inner // n_heads
    q = (x @ params["wq"]).reshape(B, S, n_heads, P)
    k = (x @ params["wk"]).reshape(B, S, n_heads, P) / (P ** 0.5)
    v = (x @ params["wv"]).reshape(B, S, n_heads, P)
    x32 = x.float()
    f = torch.sigmoid(x32 @ params["w_fgate"])                              # (B, S, H)
    i = torch.exp(-_softplus(-(x32 @ params["w_igate"])))
    vals = v.float() * i[..., None]
    if mode == "decode":
        if state is None or S != 1:
            raise ValueError("decode mode takes one token and a state")
        y, new_state = _on_local(_mlstm_step, vals, f, k.float(), q.float(), state=state,
                                 state_dims={0: 0, 2: 1})
    else:
        y, st = _on_local(lambda *t: _ssd_chunk_scan_per_head(*t, chunk=chunk),
                          vals, f, k.float(), q.float(), state_dims={0: 0, 2: 1})
        new_state = st if mode == "prefill" else None
    y = y.reshape(B, S, d_inner)
    var = torch.mean(y * y, dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-6) * params["norm"]
    y = y * F.silu((x @ params["w_z"]).float())
    return y.to(x.dtype) @ params["w_out"], new_state


def init_slstm(gen, d_model: int, *, dtype=torch.bfloat16) -> dict:
    """The reference's ``init_slstm``: the three gate matrices are f32."""
    return {
        "w_z": init_dense(gen, d_model, d_model, dtype),
        "w_i": init_dense(gen, d_model, d_model, torch.float32),
        "w_f": init_dense(gen, d_model, d_model, torch.float32),
        "w_o": init_dense(gen, d_model, d_model, torch.float32),
        "w_out": init_dense(gen, d_model, d_model, dtype),
    }


def slstm_state(batch: int, d_model: int, device) -> tuple[torch.Tensor, ...]:
    """The sLSTM's zero state (c, n, m), each (B, D) f32; m, the log-space
    stabiliser, starts at -1e30."""
    z = torch.zeros((batch, d_model), dtype=torch.float32, device=device)
    # c and n apart: a serving pool's slot is written into each in place
    return (z, z.clone(), torch.full((batch, d_model), -1e30, dtype=torch.float32, device=device))


def _slstm_step(carry, zt, it, ft, ot):
    c, n, m = carry
    m_new = torch.maximum(ft + m, it)           # log-space stabilisation
    i_s = torch.exp(it - m_new)
    f_s = torch.exp(ft + m - m_new)
    c_new = f_s * c + i_s * zt
    n_new = f_s * n + i_s
    h = ot * c_new / torch.clamp_min(n_new, 1e-6)
    return (c_new, n_new, m_new), h


def _slstm_scan(z, ig, fg, og):
    """The sLSTM's loop over the tokens of (B, S, D) gates from the zero
    state: (y (B, S, D), the final (c, n, m))."""
    carry = slstm_state(z.shape[0], z.shape[2], z.device)
    hs = []
    for t in range(z.shape[1]):
        carry, h = _slstm_step(carry, z[:, t], ig[:, t], fg[:, t], og[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1), carry


def _slstm_token(z, ig, fg, og, *, state):
    """One sLSTM token (S == 1) from ``state`` (c, n, m): (y (B, 1, D), the
    new state)."""
    carry, h = _slstm_step(state, z[:, 0], ig[:, 0], fg[:, 0], og[:, 0])
    return h[:, None], carry


def _on_local(scan, *xs, state=None, state_dims: dict[int, int]):
    """``scan(*xs[, state=])`` — a recurrence over dim 1 of inputs laid out
    alike (batch at dim 0, an independent channel or head dim at 2)
    returning (y, state) — as it is for plain tensors, and on each rank's
    local shard for DTensors: the batch and dim-2 splits of the first input
    kept, the time axis whole, the others laid out as the first; y laid out
    as the inputs, each state tensor (a tensor or a tuple of them, given or
    returned) by ``state_dims`` (an input dim -> its dim)."""
    kw = {} if state is None else {"state": state}
    if not any(isinstance(t, DTensor) for t in xs + (state if isinstance(state, tuple)
                                                          else (state,))):
        return scan(*xs, **kw)
    mesh = next(t.device_mesh for t in xs if isinstance(t, DTensor))
    xs = [_shards.as_dtensor(t, mesh) for t in xs]
    pls = _shards.keep(xs[0].placements, (0, 2))
    sp = _shards.follow(pls, state_dims)

    def each(st, fn):
        return tuple(fn(t) for t in st) if isinstance(st, tuple) else fn(st)

    if state is not None:
        kw["state"] = each(state, lambda t: _shards.as_dtensor(t, mesh).redistribute(
            mesh, sp).to_local())
    y, st = scan(*(t.redistribute(mesh, pls).to_local() for t in xs), **kw)
    return _shards.to_global(y, mesh, pls), each(st, lambda t: _shards.to_global(t, mesh, sp))


def slstm(params, x: torch.Tensor, *, state=None,
          mode: str = "train") -> tuple[torch.Tensor, tuple | None]:
    """sLSTM over x (B, S, D): the sequential scalar-memory LSTM with
    exponential gating, one step per token (a Python loop over S).  State
    (c, n, m): cell, normaliser and log-max stabiliser, each (B, D) f32.

    ``mode='decode'``: S == 1, one step from ``state``.  ``prefill``
    returns the final state, ``train`` None."""
    B, S, D = x.shape
    x32 = x.float()
    z = torch.tanh((x @ params["w_z"]).float())
    ig = x32 @ params["w_i"]
    fg = x32 @ params["w_f"]
    og = torch.sigmoid(x32 @ params["w_o"])
    if mode == "decode":
        if state is None or S != 1:
            raise ValueError("decode mode takes one token and a state")
        y, new_state = _on_local(_slstm_token, z, ig, fg, og, state=tuple(state),
                                 state_dims={0: 0, 2: 1})
    else:
        y, carry = _on_local(_slstm_scan, z, ig, fg, og, state_dims={0: 0, 2: 1})
        new_state = carry if mode == "prefill" else None
    return y.to(x.dtype) @ params["w_out"], new_state


def mlstm_state_shape(d_model: int, *, expand: int = 2, head_dim: int = 64, batch: int = 1):
    d_inner = expand * d_model
    h = d_inner // head_dim
    return (batch, h, head_dim, head_dim)
