"""Plain reference of LFM2-8B-A1B's training step at one expert-parallel
rank's share, the weights the cell draws from the seed, and the judge of
the cell's training numbers.

The layers as published (LiquidAI/LFM2-8B-A1B's ``config.json`` and model
card), float32 with TF32 off:

- ``conv``: ``(B, C, x) = h·in_proj``, ``y = out_proj(C ⊙ conv(B ⊙ x))``,
  the convolution depthwise and causal over 3 taps (``F.conv1d``), no bias;
- ``full_attention``: GQA (32/8 heads of 64), per-head RMSNorm of q and k
  before the rotary embedding (θ 1e6, the halves of a head paired), a
  causal softmax, computed in blocks of query rows;
- FFN: SwiGLU (``num_dense_layers`` 2 at 7,168), then MoE: sigmoid scores,
  the top 4 of score + ``expert_bias``, the chosen scores renormalised
  (``/ (Σ + 1e-6)``) and scaled by ``routed_scaling_factor``, each chosen
  expert's SwiGLU (1,792) over the tokens routed to it;
- pre-norm RMSNorm (ε 1e-5), a final norm, the tied head and the weighted
  next-token cross entropy (``bench/reference/lm.py``'s), the head and the
  loss in blocks of rows; each layer and each block recomputed in backward.

Departures, all the cell's cut and all shared by the program: the layer
holds experts ``expert_offset`` .. ``+ num_experts - 1`` (8 of the router's
32), and pairs routed elsewhere add nothing; the head is tied;
``expert_bias`` is a fixed buffer (``bias``), never updated.

The choices of experts are the program's, replayed (``replay``): a near
tie that bf16 rounding flips would otherwise move the loss and the
gradients by more than the rounding itself.  The reference judges the
choices on its own: ``route_err`` is the largest amount by which the
reference's score + bias of a chosen expert lies below the reference's
k-th best for that token, over every MoE layer of the first step (after
it, the program's bf16 weights have rounded their updates and no longer
equal the reference's f32 ones, and the activations drift apart by more
than the choices' rounding).  Without ``replay`` the reference routes by
itself and returns its choices.

Nothing here imports the program.
"""
from __future__ import annotations

import math
import statistics
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.reference.lm import cosine_lr, plain_mm, rms_norm

ROW_BLOCK = 1024      # query rows of attention per block
HEAD_BLOCK = 4096     # tokens of the head and the loss per block


def layer_kinds(model: dict) -> list[tuple[str, str]]:
    """(mixer, ffn) of each layer: ``conv`` or ``attn``, ``dense`` or ``moe``."""
    return [("attn" if t == "full_attention" else "conv",
             "dense" if i < model["num_dense_layers"] else "moe")
            for i, t in enumerate(model["layer_types"])]


def moe_layers(model: dict) -> list[int]:
    return [i for i, (_, f) in enumerate(layer_kinds(model)) if f == "moe"]


def bias(model: dict) -> dict[int, torch.Tensor]:
    """Each MoE layer's expert bias (the configuration's ``expert_bias``):
    0.05·Φ⁻¹((((e + 5·l) mod E) + 0.5)/E) for the l-th MoE layer, the same in
    every run."""
    e = model["router_experts"]
    scale = model["expert_bias"]["scale"]
    nd = statistics.NormalDist()
    return {i: torch.tensor([scale * nd.inv_cdf((((j + 5 * l) % e) + 0.5) / e)
                             for j in range(e)], dtype=torch.float32)
            for l, i in enumerate(moe_layers(model))}


def leaf_specs(model: dict) -> list[tuple[str, tuple[int, ...], str, float]]:
    """(name, shape, kind, scale) of every trained weight (``kind``:
    ``normal`` at ``scale``, ``uniform`` in ±``scale``, ``ones``)."""
    d, v = model["hidden_size"], model["vocab_size"]
    f, fe = model["intermediate_size"], model["moe_intermediate_size"]
    h, hkv = model["num_attention_heads"], model["num_key_value_heads"]
    hd, e, held = d // h, model["router_experts"], model["num_experts"]
    k = model["conv_L_cache"]

    def normal(din, dout):
        return (2.0 / (din + dout)) ** 0.5

    specs = [("embed", (v, d), "normal", 0.02)]
    for i, (mixer, ffn) in enumerate(layer_kinds(model)):
        p = f"layers.{i}."
        specs.append((p + "norm1", (d,), "ones", 1.0))
        if mixer == "conv":
            specs += [(p + "in_proj", (d, 3 * d), "normal", normal(d, 3 * d)),
                      (p + "conv", (d, k), "uniform", k ** -0.5),
                      (p + "out_proj", (d, d), "normal", normal(d, d))]
        else:
            specs += [(p + "wq", (d, h, hd), "normal", normal(d, h * hd)),
                      (p + "wk", (d, hkv, hd), "normal", normal(d, hkv * hd)),
                      (p + "wv", (d, hkv, hd), "normal", normal(d, hkv * hd)),
                      (p + "wo", (h, hd, d), "normal", normal(h * hd, d)),
                      (p + "q_norm", (hd,), "ones", 1.0), (p + "k_norm", (hd,), "ones", 1.0)]
        specs.append((p + "norm2", (d,), "ones", 1.0))
        if ffn == "dense":
            specs += [(p + "w_gate", (d, f), "normal", normal(d, f)),
                      (p + "w_up", (d, f), "normal", normal(d, f)),
                      (p + "w_down", (f, d), "normal", normal(f, d))]
        else:
            specs += [(p + "router", (d, e), "normal", normal(d, e)),
                      (p + "w_gate", (held, d, fe), "normal", normal(d, fe)),
                      (p + "w_up", (held, d, fe), "normal", normal(d, fe)),
                      (p + "w_down", (held, fe, d), "normal", normal(fe, d))]
    specs.append(("final_norm", (d,), "ones", 1.0))
    return specs


def weights(model: dict, seed: int, device, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """Every weight of ``leaf_specs`` by name, drawn on the device: the
    matrices of one scale as views of one buffer filled by one ``normal_``
    call (scales in the order they first appear), then the convolutions
    by one ``uniform_`` call, all in ``dtype``; norm scales are f32 ones, and
    the routers and the convolutions' taps are held in f32 (their draws,
    widened), as the program holds them."""
    specs = leaf_specs(model)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    groups: dict[tuple[str, float], list] = {}
    for name, shape, kind, scale in specs:
        if kind != "ones":
            groups.setdefault((kind, scale), []).append((name, shape))
    out: dict[str, torch.Tensor] = {}
    for (kind, scale), members in sorted(groups.items(), key=lambda g: g[0][0] == "uniform"):
        total = sum(int(np.prod(s)) for _, s in members)
        buf = torch.empty((total,), dtype=dtype, device=device)
        if kind == "normal":
            buf.normal_(0.0, scale, generator=gen)
        else:
            buf.uniform_(-scale, scale, generator=gen)
        off = 0
        for name, shape in members:
            n = int(np.prod(shape))
            out[name] = buf[off:off + n].view(shape)
            off += n
    for name, shape, kind, _ in specs:
        if kind == "ones":
            out[name] = torch.ones(shape, dtype=torch.float32, device=device)
        elif name.endswith((".router", ".conv")):
            out[name] = out[name].float()
    return out


def _linear(x: torch.Tensor, w: torch.Tensor, mm: Callable) -> torch.Tensor:
    lead = x.shape[:-1]
    return mm(x.reshape(-1, x.shape[-1]), w.reshape(x.shape[-1], -1)).reshape(*lead, -1)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated at positions 0 .. S-1, the halves paired."""
    s, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / (float(theta) ** (torch.arange(0, d, 2, dtype=torch.float32,
                                                  device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attn_rows(q, k, v, r0: int):
    """Causal softmax attention of the query rows r0.. (q (B, R, H, D)) over
    the keys 0 .. r0 + R - 1."""
    r, hd = q.shape[1], q.shape[-1]
    kk, vv = k[:, :r0 + r], v[:, :r0 + r]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kk) / math.sqrt(hd)
    causal = (torch.arange(r0 + r, device=q.device)[None, :]
              <= torch.arange(r0, r0 + r, device=q.device)[:, None])
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vv)


def attention(w: dict, h: torch.Tensor, model: dict, mm: Callable) -> torch.Tensor:
    b, s, d = h.shape
    nh, nkv = model["num_attention_heads"], model["num_key_value_heads"]
    hd, eps, theta = d // nh, model["norm_eps"], model["rope_theta"]
    q = rope(rms_norm(_linear(h, w["wq"], mm).view(b, s, nh, hd), w["q_norm"], eps), theta)
    k = rope(rms_norm(_linear(h, w["wk"], mm).view(b, s, nkv, hd), w["k_norm"], eps), theta)
    v = _linear(h, w["wv"], mm).view(b, s, nkv, hd)
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.repeat_interleave(nh // nkv, dim=2)
    o = torch.cat([checkpoint(_attn_rows, q[:, r0:r0 + ROW_BLOCK], k, v, r0, use_reentrant=False)
                   for r0 in range(0, s, ROW_BLOCK)], dim=1)
    return _linear(o.reshape(b, s, nh * hd), w["wo"], mm)


def short_conv(w: dict, h: torch.Tensor, mm: Callable) -> torch.Tensor:
    b, s, d = h.shape
    bb, c, x = _linear(h, w["in_proj"], mm).chunk(3, dim=-1)
    k = w["conv"].shape[1]
    y = F.conv1d((bb * x).transpose(1, 2), w["conv"][:, None, :], padding=k - 1,
                 groups=d)[..., :s]
    return _linear(c * y.transpose(1, 2), w["out_proj"], mm)


def swiglu(x, w_gate, w_up, w_down, mm):
    return _linear(F.silu(_linear(x, w_gate, mm)) * _linear(x, w_up, mm), w_down, mm)


class _Routes:
    """The choices of experts of one step: replayed from ``replay`` (one
    (T, k) array per MoE layer) or made here and kept, so that a layer's
    recompute in backward routes as its forward did; ``route_err`` over
    every call."""

    def __init__(self, replay: list | None):
        self.replay = replay
        self.made: dict[int, torch.Tensor] = {}
        self.route_err = 0.0

    def choose(self, choice: torch.Tensor, k: int, index: int) -> torch.Tensor:
        """``choice`` (T, E) = score + bias of MoE layer ``index``: its (T, k)
        experts."""
        top = torch.sort(choice, dim=-1, descending=True, stable=True)
        theirs = None if self.replay is None or index >= len(self.replay) else self.replay[index]
        if self.replay is not None and (theirs is None or tuple(theirs.shape) != (len(choice), k)):
            self.route_err = math.inf       # the program routed other tokens, or fewer layers
            theirs = top.indices[:, :k]
        if self.replay is not None:
            ids = torch.as_tensor(theirs, device=choice.device).long()
        else:
            ids = self.made.setdefault(index, top.indices[:, :k])
        gap = top.values[:, k - 1:k] - torch.gather(choice, -1, ids)
        self.route_err = max(self.route_err, float(gap.max().clamp_min(0.0)))
        return ids

    def made_arrays(self) -> list[np.ndarray]:
        return [self.made[i].to(torch.uint8).cpu().numpy() for i in sorted(self.made)]


def moe(w: dict, h: torch.Tensor, model: dict, mm: Callable, routes: _Routes,
        expert_bias: torch.Tensor, index: int) -> torch.Tensor:
    """The held experts' part of the layer over h (B, S, D): each held
    expert's SwiGLU over the tokens routed to it, weighted by its score."""
    b, s, d = h.shape
    x = h.reshape(-1, d)
    k, off = model["num_experts_per_tok"], model["expert_offset"]
    scores = torch.sigmoid(x @ w["router"])
    ids = routes.choose(scores.detach() + expert_bias, k, index)
    g = torch.gather(scores, -1, ids)
    g = g / (g.sum(-1, keepdim=True) + 1e-6) * model["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for j in range(w["w_gate"].shape[0]):
        tok, slot = torch.nonzero(ids == off + j, as_tuple=True)
        if tok.numel():
            out = swiglu(x[tok], w["w_gate"][j], w["w_up"][j], w["w_down"][j], mm)
            y = y.index_add(0, tok, out * g[tok, slot][:, None])
    return y.reshape(b, s, d)


def _layer(x, ws: dict, kinds, model, mm, routes, expert_bias, index):
    mixer, ffn = kinds
    eps = model["norm_eps"]
    h = rms_norm(x, ws["norm1"], eps)
    x = x + (short_conv(ws, h, mm) if mixer == "conv" else attention(ws, h, model, mm))
    h = rms_norm(x, ws["norm2"], eps)
    if ffn == "dense":
        return x + swiglu(h, ws["w_gate"], ws["w_up"], ws["w_down"], mm)
    return x + moe(ws, h, model, mm, routes, expert_bias, index)


def _head_rows(x, norm, embed, labels, mask, eps, mm):
    logits = _linear(rms_norm(x, norm, eps), embed.T, mm)
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None])[..., 0]
    return (nll * mask).sum()


def loss_fn(params: dict, batch: dict, model: dict, routes: _Routes, biases: dict,
            mm: Callable = plain_mm) -> torch.Tensor:
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    wts = torch.as_tensor(batch["weights"], device=dev).float()
    x = params["embed"][tokens]
    moe_index = {i: l for l, i in enumerate(moe_layers(model))}
    for i, kinds in enumerate(layer_kinds(model)):
        pre = f"layers.{i}."
        ws = {n[len(pre):]: t for n, t in params.items() if n.startswith(pre)}
        names = list(ws)

        def run(x, *vals, kinds=kinds, names=names, i=i):
            return _layer(x, dict(zip(names, vals)), kinds, model, mm, routes, biases.get(i),
                          moe_index.get(i))

        x = checkpoint(run, x, *ws.values(), use_reentrant=False)
    b, s, d = x.shape
    x, labels = x.reshape(-1, d), labels.reshape(-1)
    mask = wts[:, None].expand(b, s).reshape(-1)
    total = sum(checkpoint(_head_rows, x[r:r + HEAD_BLOCK], params["final_norm"],
                           params["embed"], labels[r:r + HEAD_BLOCK], mask[r:r + HEAD_BLOCK],
                           model["norm_eps"], mm, use_reentrant=False)
                for r in range(0, b * s, HEAD_BLOCK))
    return total / torch.clamp_min(mask.sum(), 1.0)


def train(model: dict, seed: int, batches: list[dict], *, lr: float, total_steps: int,
          device, replay: list | None = None, weight_decay: float = 0.01, clip: float = 1.0,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          mm: Callable = plain_mm) -> dict:
    """The first ``len(batches)`` steps from the seed's weights, as
    ``bench/reference/lm.py``'s ``train``, routed by ``replay`` (one list of
    (T, k) choices per step) or by the reference itself; adds ``route_err``
    and, routed here, ``routes`` (the choices made)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w0 = weights(model, seed, device)
    names = list(w0)
    params = {n: w0[n].float().clone().requires_grad_(True) for n in names}
    del w0
    biases = {i: t.to(device) for i, t in bias(model).items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, grad1, route_err, made = [], None, 0.0, []
    for step, batch in enumerate(batches):
        routes = _Routes(None if replay is None else replay[step])
        loss = loss_fn(params, batch, model, routes, biases, mm)
        # a layer whose held experts were routed no token has no gradient
        # into its experts or its router: zeros
        grads = [torch.zeros_like(params[n]) if g is None else g for n, g in zip(
            names, torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True))]
        if step == 0:   # the program's weights equal the reference's only here
            route_err = routes.route_err
        made.append(routes.made_arrays())
        losses.append(float(loss.detach()))
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
        scale = min(1.0, clip / max(float(norm), 1e-12))
        lr_t = cosine_lr(lr, total_steps, step)
        t = step + 1
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        if step == 0:
            grad1 = {n: float(torch.linalg.vector_norm(g.double()) * scale)
                     for n, g in zip(names, grads)}
        with torch.no_grad():
            for n, g in zip(names, grads):
                g = g * scale
                m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                upd = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + eps) + weight_decay * params[n]
                params[n].sub_(lr_t * upd)
        del grads
    w0 = weights(model, seed, device)
    change = {n: float(torch.linalg.vector_norm((params[n].detach() - w0[n].float()).double()))
              for n in names}
    out = {"losses": losses, "grad1": grad1, "change": change, "route_err": route_err}
    if replay is None:
        out["routes"] = made
    return out
