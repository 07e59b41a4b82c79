"""Plain float32 reference of LFM2-8B-A1B's layers, its loss and (through
autograd) its gradients, as the model card and its ``config.json`` describe
them.  It uses ``torch`` operations only and imports nothing of the port,
so the port's CPU tests hold ``repro_torch.models`` against it.

Per layer, pre-norm (RMSNorm, f32 statistics, eps ``norm_eps``):

- ``conv`` (gated short convolution): ``(B, C, x) = h·in_proj`` split in
  that order, ``y = out_proj(C ⊙ conv(B ⊙ x))``, the convolution depthwise
  and causal over ``conv_kernel`` taps (``F.conv1d`` with ``groups=D`` and
  ``K - 1`` zeros in front), no biases;
- ``attn``: GQA, a per-head RMSNorm of q and of k (a scale of ``head_dim``)
  before the rotary embedding (θ ``rope_theta``, the two halves of a head
  paired), causal softmax at 1/√head_dim;
- FFN ``dense``: SwiGLU; ``moe``: sigmoid scores of ``h·router``, experts
  chosen by the top-k of score + ``expert_bias`` (ties to the lower index),
  their scores renormalised (``/ (Σ + 1e-6)``) and scaled, each chosen
  expert's SwiGLU weighted by its score; computed here densely, every held
  expert on every token.

A final RMSNorm, the head tied to the embedding, and the next-token cross
entropy weighted per row (``Σ nll·w / max(Σ w, 1)``).

Departures from the published model, each the benchmark's cut or the
port's, shared by the port: only the experts ``offset`` ..
``offset + H - 1`` are held (the weights' expert stacks), and pairs routed
to other experts add nothing (one expert-parallel rank's part of the
layer's output); the head is tied (the port always ties);
``expert_bias`` is never updated (the published training updates it
between steps by the experts' load).

Weights (``params``): ``embed`` (V, D), ``final_norm`` (D,), and ``layers``,
one dict per layer: ``norm1``, ``mixer`` (``in_proj``, ``conv`` (D, K),
``out_proj``; or ``wq`` (D, H, Dh), ``wk``, ``wv``, ``wo`` (H, Dh, D),
``q_norm``, ``k_norm``), and ``norm2``, ``ffn`` (``w_gate``, ``w_up``,
``w_down``; an MoE layer's as (H, ...) stacks, with ``router`` (D, E) and
``expert_bias`` (E,)).  ``spec``: ``kinds`` (the (mixer, ffn) of each
layer), ``num_heads``, ``num_kv_heads``, ``head_dim``, ``norm_eps``,
``rope_theta``, ``top_k``, ``expert_offset``, ``routed_scaling_factor``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated at positions 0..S-1, the halves paired."""
    s, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / (float(theta) ** (torch.arange(0, d, 2, dtype=torch.float32) / d))
    ang = torch.arange(s, dtype=torch.float32)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def short_conv(p: dict, h: torch.Tensor) -> torch.Tensor:
    b, s, d = h.shape
    bb, c, x = (h @ p["in_proj"]).chunk(3, dim=-1)
    k = p["conv"].shape[1]
    u = (bb * x).transpose(1, 2)                                      # (B, D, S)
    y = F.conv1d(u, p["conv"][:, None, :], padding=k - 1, groups=d)[..., :s]
    return (c * y.transpose(1, 2)) @ p["out_proj"]


def attention(p: dict, h: torch.Tensor, spec: dict) -> torch.Tensor:
    b, s, d = h.shape
    nh, nkv, hd = spec["num_heads"], spec["num_kv_heads"], spec["head_dim"]
    eps = spec["norm_eps"]
    q = (h @ p["wq"].reshape(d, nh * hd)).view(b, s, nh, hd)
    k = (h @ p["wk"].reshape(d, nkv * hd)).view(b, s, nkv, hd)
    v = (h @ p["wv"].reshape(d, nkv * hd)).view(b, s, nkv, hd)
    q = rope(rms_norm(q, p["q_norm"], eps), spec["rope_theta"])
    k = rope(rms_norm(k, p["k_norm"], eps), spec["rope_theta"])
    k = k.repeat_interleave(nh // nkv, dim=2)
    v = v.repeat_interleave(nh // nkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones((s, s), dtype=torch.bool).tril()
    prob = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", prob, v).reshape(b, s, nh * hd)
    return o @ p["wo"].reshape(nh * hd, d)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def route(p: dict, h: torch.Tensor, spec: dict) -> tuple[torch.Tensor, torch.Tensor]:
    """(weights (T, k), expert ids (T, k)) of tokens h (T, D)."""
    scores = torch.sigmoid(h @ p["router"])
    ids = torch.sort(scores.detach() + p["expert_bias"], dim=-1, descending=True,
                     stable=True).indices[:, :spec["top_k"]]
    w = torch.gather(scores, -1, ids)
    return w / (w.sum(-1, keepdim=True) + 1e-6) * spec["routed_scaling_factor"], ids


def moe(p: dict, h: torch.Tensor, spec: dict) -> torch.Tensor:
    """The held experts' part of the MoE layer over h (B, S, D), every held
    expert computed on every token."""
    b, s, d = h.shape
    x = h.reshape(-1, d)
    w, ids = route(p, x, spec)
    n_held, e = p["w_gate"].shape[0], p["router"].shape[1]
    gate = torch.zeros((x.shape[0], e)).scatter_add(1, ids, w)           # (T, E)
    gate = gate[:, spec["expert_offset"]:spec["expert_offset"] + n_held]
    y = sum(gate[:, j:j + 1] * swiglu(x, p["w_gate"][j], p["w_up"][j], p["w_down"][j])
            for j in range(n_held))
    return y.reshape(b, s, d)


def block(p: dict, x: torch.Tensor, kinds: tuple[str, str], spec: dict) -> torch.Tensor:
    mixer, ffn = kinds
    h = rms_norm(x, p["norm1"], spec["norm_eps"])
    x = x + (short_conv(p["mixer"], h) if mixer == "conv" else attention(p["mixer"], h, spec))
    h = rms_norm(x, p["norm2"], spec["norm_eps"])
    return x + (swiglu(h, **p["ffn"]) if ffn == "dense" else moe(p["ffn"], h, spec))


def loss_fn(params: dict, batch: dict, spec: dict) -> torch.Tensor:
    tokens = torch.as_tensor(batch["tokens"]).long()
    labels = torch.as_tensor(batch["labels"]).long()
    x = params["embed"][tokens]
    for p, kinds in zip(params["layers"], spec["kinds"]):
        x = block(p, x, kinds, spec)
    x = rms_norm(x, params["final_norm"], spec["norm_eps"])
    logits = x @ params["embed"].T
    nll = torch.logsumexp(logits, dim=-1) - logits.gather(-1, labels[..., None])[..., 0]
    w = batch.get("weights")
    mask = torch.ones_like(nll) if w is None else torch.as_tensor(w).float()[:, None].expand_as(nll)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
