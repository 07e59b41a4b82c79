"""Top-k routed Mixture-of-Experts: the capacity route (GShard dispatch, the
port of ``repro/models/moe.py``) and the dropless route (``moe_routed``,
the port's own, for the ``sigmoid_bias`` router).

Token groups of ``group_size`` are routed independently; each expert takes
at most ``capacity = group_size / E * k * capacity_factor`` tokens per
group (overflow drops).  Capacity is claimed in the reference's order: the
first choices of all the group's tokens, in token order, before any second
choice.  Dispatch and combine are the reference's one-hot contractions; the
expert FFNs are one batched product per weight, over the expert stack as it
lies in memory (no weight is copied).

The dropless route drops nothing, whatever the load.  Its router scores
every expert with a sigmoid over f32 logits and chooses the top-k of score
+ ``expert_bias`` (a ``tree.Buffer``: read, never trained), ties to the
lower index; the chosen scores, renormalised (``/ (Σ + 1e-6)``) and scaled,
weight the experts' outputs.  The layer holds a contiguous share of the
experts (``w_gate`` (H, D, F) and the rest are experts ``offset`` ..
``offset + H - 1``; the router keeps all E outputs): the (token, choice)
pairs whose expert is held are sorted by expert, in token order within one,
their rows gathered, and each held expert's SwiGLU runs over its contiguous
rows.  On the card that is ``torch._grouped_mm`` with the groups' ends on
the device, over a buffer of every pair's row (the held rows first), so no
count is read back; elsewhere a loop over the experts reads the ends to
the host.  The combine writes each weighted row to its (token, choice) slot
and sums the k slots in order, and the gather's backward sums them the same
way: no atomics, so repeats are bit-equal.  Pairs routed to experts held
elsewhere add nothing here: the layer's output is this share's part of the
sum over the expert-parallel ranks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.distributed.sharding import ambient_mesh, batch_entry, constrain
from repro_torch.models.layers import init_dense, swiglu
from repro_torch.tree import Buffer


def init_moe(gen, d_model: int, d_ff: int, n_experts: int, dtype=torch.bfloat16, *,
             held: int | None = None, expert_bias: bool = False) -> dict:
    """Router (D, E) in f32 and the expert stacks (H, D, F), (H, D, F),
    (H, F, D) of the ``held`` experts (all E by default); each expert is
    drawn on its own, so the f32 temporaries stay one expert's size.  With
    ``expert_bias``, a zero (E,) f32 ``Buffer`` beside them."""
    held = n_experts if held is None else held

    def expert_stack(din, dout):
        out = torch.empty((held, din, dout), dtype=dtype, device=gen.device)
        for e in range(held):
            out[e] = init_dense(gen, din, dout, dtype)
        return out

    p = {
        "router": init_dense(gen, d_model, n_experts, torch.float32),
        "w_gate": expert_stack(d_model, d_ff),
        "w_up": expert_stack(d_model, d_ff),
        "w_down": expert_stack(d_ff, d_model),
    }
    if expert_bias:
        p["expert_bias"] = Buffer(torch.zeros((n_experts,), dtype=torch.float32,
                                              device=gen.device))
    return p


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


def _sigmoid_router(params, x: torch.Tensor, top_k: int,
                    scale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Sigmoid scores over f32 logits; the experts of the top-k of score +
    ``expert_bias`` (ties to the lower index); their scores renormalised
    and scaled.  x (T, D) → (weights (T, k) f32, expert ids (T, k))."""
    scores = torch.sigmoid(x.float() @ params["router"])
    choice = scores.detach() + params["expert_bias"].value
    ids = torch.sort(choice, dim=-1, descending=True, stable=True).indices[:, :top_k]
    w = torch.gather(scores, -1, ids)
    return w / (w.sum(-1, keepdim=True) + 1e-6) * scale, ids


class _GatherRows(torch.autograd.Function):
    """Rows ``x[order // k]``: the token row of each (token, choice) pair in
    the sorted order.  The backward keeps the rows below ``n_rows`` (the
    held experts' rows), puts each back in its pair's slot and sums each
    token's k slots in order: no atomics."""

    @staticmethod
    def forward(ctx, x, order, inverse, n_rows, k):
        ctx.save_for_backward(inverse, n_rows)
        ctx.k = k
        return x.index_select(0, torch.div(order, k, rounding_mode="floor"))

    @staticmethod
    def backward(ctx, g):
        inverse, n_rows = ctx.saved_tensors
        rows = torch.arange(g.shape[0], device=g.device)
        g = torch.where((rows < n_rows)[:, None], g, 0)
        gx = g.index_select(0, inverse).view(-1, ctx.k, g.shape[-1]).sum(1)
        return gx, None, None, None, None


def _grouped_route(xs: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the held experts run as ``torch._grouped_mm`` products: bf16
    on the card, widths the product's tiles align to."""
    return (hasattr(torch, "_grouped_mm") and xs.device.type == "cuda"
            and xs.dtype == w.dtype == torch.bfloat16
            and all(n % 16 == 0 for n in w.shape[1:]))


def held_experts(params, xs: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Each held expert's SwiGLU over its rows of ``xs`` (P, D): expert e
    takes rows ``ends[e-1]`` .. ``ends[e] - 1``; the rows past ``ends[-1]``
    come out zero (on the grouped route their gradient is undefined: the
    caller's gather drops it)."""
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if _grouped_route(xs, wg):
        offs = ends.to(torch.int32)
        h = torch._grouped_mm(xs, wg, offs=offs)
        u = torch._grouped_mm(xs, wu, offs=offs)
        ye = torch._grouped_mm(F.silu(h) * u, wd, offs=offs)
        # rows past the last group are not written by the products
        rows = torch.arange(xs.shape[0], device=xs.device)
        return torch.where((rows < ends[-1])[:, None], ye, 0)
    bounds = [0] + ends.tolist()
    parts = [swiglu(xs[a:b], wg[e], wu[e], wd[e]) for e, (a, b) in
             enumerate(zip(bounds[:-1], bounds[1:]))]
    parts.append(xs.new_zeros((xs.shape[0] - bounds[-1], wd.shape[-1])))
    return torch.cat(parts)


def moe_routed(params, x: torch.Tensor, *, top_k: int, offset: int = 0,
               scale: float = 1.0) -> torch.Tensor:
    """The dropless route over (B, S, D) (module docstring): this share's
    part of the layer's output, (B, S, D)."""
    b, s, d = x.shape
    held = params["w_gate"].shape[0]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    with obs.span("lm.moe.route") as sp:
        xt = sp.input(xt)
        w, ids = _sigmoid_router(params, xt, top_k, scale)
        local = (ids - offset).reshape(-1)
        mine = (local >= 0) & (local < held)
        key = torch.where(mine, local, held)
        skey, order = torch.sort(key, stable=True)
        inverse = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.shape[0], device=order.device))
        # each held expert's end in the sorted pairs, found on the device (a
        # histogram would read its size back to the host: one wait a layer)
        ends = torch.searchsorted(skey, torch.arange(1, held + 1, device=skey.device))
        xs = sp.output(_GatherRows.apply(xt, order, inverse, ends[-1], top_k))
        if obs.recording():
            obs.count("moe.rows_routed", t * top_k)
            obs.count("moe.rows_held", ends[-1])
            obs.count("moe.rows_max", torch.diff(ends, prepend=ends.new_zeros(1)).max())
    with obs.span("lm.moe.experts") as sp:
        ye = sp.output(held_experts(params, sp.input(xs), ends))
    with obs.span("lm.moe.combine") as sp:
        w_mine = torch.where(mine, w.reshape(-1), 0)
        yp = sp.input(ye).index_select(0, inverse).float() * w_mine[:, None]
        y = sp.output(yp.view(t, top_k, d).sum(1).to(x.dtype))
    return y.reshape(b, s, d)
