"""Top-k routed Mixture-of-Experts with capacity-based GShard dispatch: the
port of ``repro/models/moe.py``, forward only.

Token groups of ``group_size`` are routed independently; each expert takes
at most ``capacity = group_size / E * k * capacity_factor`` tokens per
group (overflow drops).  Capacity is claimed in the reference's order: the
first choices of all the group's tokens, in token order, before any second
choice.  Dispatch and combine are the reference's one-hot contractions; the
expert FFNs are one batched product per weight, over the expert stack as it
lies in memory (no weight is copied).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import ambient_mesh, batch_entry, constrain
from repro_torch.models.layers import init_dense


def init_moe(gen, d_model: int, d_ff: int, n_experts: int, dtype=torch.bfloat16) -> dict:
    """Router (D, E) in f32 and the expert stacks (E, D, F), (E, D, F),
    (E, F, D); each expert is drawn on its own, so the f32 temporaries stay
    one expert's size."""
    def expert_stack(din, dout):
        out = torch.empty((n_experts, din, dout), dtype=dtype, device=gen.device)
        for e in range(n_experts):
            out[e] = init_dense(gen, din, dout, dtype)
        return out

    return {
        "router": init_dense(gen, d_model, n_experts, torch.float32),
        "w_gate": expert_stack(d_model, d_ff),
        "w_up": expert_stack(d_model, d_ff),
        "w_down": expert_stack(d_ff, d_model),
    }


def _router(params, x: torch.Tensor, top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Softmax router over f32 logits: the top-k probabilities, renormalised
    to sum to 1, and their expert indices (..., k).  Ties go to the lower
    expert index, as ``jax.lax.top_k`` breaks them (``torch.topk`` promises
    no order): padding tokens (all-zero rows) tie across every expert and
    claim capacity like any other token."""
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :top_k], topi[..., :top_k]
    return topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9), topi


def _experts(params, xe: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its own rows: xe (E, T, D) → (E, T, D)."""
    h = torch.bmm(xe, params["w_gate"])
    u = torch.bmm(xe, params["w_up"])
    return torch.bmm(F.silu(h) * u, params["w_down"])


def moe_dropless(params, x: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """Dense dropless MoE: every expert computed for every token, combined
    by the renormalised top-k router weights (the decode step's route)."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    topv, topi = _router(params, x, top_k)
    gate = torch.sum(F.one_hot(topi, e).float() * topv[..., None], dim=-2)   # (b, s, e)
    tokens = x.reshape(1, b * s, d).expand(e, b * s, d)
    y = _experts(params, tokens)                                              # (e, b*s, d)
    out = torch.einsum("etd,te->td", y, gate.reshape(b * s, e).to(x.dtype))
    return out.reshape(b, s, d)


def moe(params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
        group_size: int = 1024, dropless: bool = False) -> torch.Tensor:
    """Apply the MoE to (B, S, D); returns (B, S, D)."""
    if dropless:
        return moe_dropless(params, x, top_k=top_k)
    b, s, d = x.shape
    e = params["router"].shape[-1]
    tokens = x.reshape(-1, d)
    t = tokens.shape[0]
    gs = min(group_size, t)
    pad = (-t) % gs
    if pad:  # padded tokens route too, and are cut off at the end
        tokens = F.pad(tokens, (0, 0, 0, pad))
    g = tokens.shape[0] // gs
    xg = constrain(tokens.reshape(g, gs, d), "batch", None, None)

    topv, topi = _router(params, xg, top_k)                                  # (g, gs, k)
    cap = max(1, int(gs / e * top_k * capacity_factor))
    # position of each (token, choice) in its expert's buffer: the k choices
    # are flattened choice-major before the cumsum, so every token's first
    # choice claims capacity before any token's second choice
    onehot = F.one_hot(topi, e).float()                                      # (g, gs, k, e)
    flat = onehot.transpose(1, 2).reshape(g, top_k * gs, e)
    pos = torch.cumsum(flat, dim=1) - flat
    pos = pos.reshape(g, top_k, gs, e).transpose(1, 2)                      # (g, gs, k, e)
    keep = ((pos < cap) * onehot).to(x.dtype)                                # drop overflow
    pos_idx = torch.sum(pos * onehot, dim=-1)                                # (g, gs, k)
    # one-hot over the capacity slots; a position past the end is all zero
    cap_onehot = (pos_idx[..., None] == torch.arange(cap, device=x.device)).to(x.dtype)
    dispatch = torch.einsum("gske,gskc->gsec", keep, cap_onehot)
    combine = torch.einsum("gske,gskc,gsk->gsec", keep, cap_onehot, topv.to(x.dtype))

    xe = torch.bmm(dispatch.reshape(g, gs, e * cap).transpose(1, 2), xg)     # (g, e*cap, d)
    xe = constrain(xe.reshape(g, e, cap, d), "batch", "model", None, None)  # EP: to the experts
    xe = xe.transpose(0, 1).reshape(e, g * cap, d)
    ye = _experts(params, xe).reshape(e, g, cap, d).transpose(0, 1)         # (g, e, cap, d)
    ye = constrain(ye, "batch", "model", None, None)
    yg = constrain(torch.bmm(combine.reshape(g, gs, e * cap), ye.reshape(g, e * cap, d)),
                   "batch", None, None)
    y = yg.reshape(-1, d)[:t]
    mesh = ambient_mesh()
    if mesh is not None:  # the tokens split as the batch rows they came from
        y = constrain(y, batch_entry(mesh, b), None)
    return y.reshape(b, s, d)
