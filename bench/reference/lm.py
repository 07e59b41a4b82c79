"""Plain reference of a dense decoder's training step (InternLM2's layer
equations as the program states them), the judge that decides a training
cell's ``correct``, and the control.

Float32 throughout with TF32 off: embedding lookup, per layer a pre-norm
GQA attention (RMSNorm with f32 statistics, rotary embedding on the two
halves of each head, a causal softmax) and a pre-norm SwiGLU, a final
RMSNorm, the output head tied to the embedding, and the next-token cross
entropy weighted per row (``Σ nll·w / max(Σ w, 1)`` over every position);
then the global-norm clip, AdamW (decoupled decay on every weight, bias
corrections, the cosine learning rate) and the update.  Each layer is
recomputed in backward, so the reference fits beside nothing else.  The
control takes every projection's and the head's product in fp8 e4m3,
forward and backward (``lowp.Fp8Matmul``).

Nothing here imports the program.  The judge compares, by the worst
weight ("leaf"): each of the first steps' loss; the norm of the first
gradient as the optimizer gets it (after clipping); the norm of each
weight's change over the first steps.  A gap of norms is measured against
the reference's norm of that leaf or of the median leaf, whichever is
larger.  Leaves whose reference gradient is under a thousandth of the
median leaf's move by round-off alone and are left out of the change.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from bench import data
from bench.reference.lowp import Fp8Matmul


def plain_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return Fp8Matmul.apply(a, b)


def _linear(x: torch.Tensor, w: torch.Tensor, mm: Callable) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) as one 2-D product."""
    lead = x.shape[:-1]
    return mm(x.reshape(-1, x.shape[-1]), w).reshape(*lead, w.shape[-1])


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated at positions 0..S-1, the halves paired."""
    s, d = x.shape[1], x.shape[-1]
    freqs = 1.0 / (float(theta) ** (torch.arange(0, d, 2, dtype=torch.float32,
                                                  device=x.device) / d))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _layer(x, norm1, wq, wk, wv, wo, norm2, w_gate, w_up, w_down, *, model, mm):
    b, s, d = x.shape
    h, hkv = model["num_attention_heads"], model["num_key_value_heads"]
    hd = d // h
    eps, theta = model["rms_norm_eps"], model["rope_theta"]
    a = rms_norm(x, norm1, eps)
    q = rope(_linear(a, wq.reshape(d, h * hd), mm).view(b, s, h, hd), theta)
    k = rope(_linear(a, wk.reshape(d, hkv * hd), mm).view(b, s, hkv, hd), theta)
    v = _linear(a, wv.reshape(d, hkv * hd), mm).view(b, s, hkv, hd)
    k = k.repeat_interleave(h // hkv, dim=2)
    v = v.repeat_interleave(h // hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, s, h * hd)
    x = x + _linear(o, wo.reshape(h * hd, d), mm)
    f = rms_norm(x, norm2, eps)
    g = torch.nn.functional.silu(_linear(f, w_gate, mm)) * _linear(f, w_up, mm)
    return x + _linear(g, w_down, mm)


_PARTS = ("norm1", "wq", "wk", "wv", "wo", "norm2", "w_gate", "w_up", "w_down")


def loss_fn(params: dict, batch: dict, model: dict, mm: Callable = plain_mm) -> torch.Tensor:
    dev = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev).long()
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    w = torch.as_tensor(batch["weights"], device=dev).float()
    x = params["embed"][tokens]
    for i in range(model["num_hidden_layers"]):
        ws = [params[f"layers.{i}.{n}"] for n in _PARTS]
        x = checkpoint(lambda x, *ws: _layer(x, *ws, model=model, mm=mm), x, *ws,
                       use_reentrant=False)
    x = rms_norm(x, params["final_norm"], model["rms_norm_eps"])
    logits = _linear(x, params["embed"].T, mm)
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, labels[..., None])[..., 0]
    mask = w[:, None].expand_as(nll)
    return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def cosine_lr(base: float, total: int, step: int) -> float:
    t = min(max(step / max(total, 1), 0.0), 1.0)
    return 0.5 * base * (1.0 + math.cos(math.pi * t))


def train(model: dict, seed: int, batches: list[dict], *, lr: float, total_steps: int,
          device, weight_decay: float = 0.01, clip: float = 1.0, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8, mm: Callable = plain_mm) -> dict:
    """The first ``len(batches)`` steps from the seed's weights: each step's
    loss, the first step's clipped gradient norm per leaf, and each leaf's
    change over all the steps (norms, float64 on the host)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w0 = data.lm_weights(model, seed, device)
    names = list(w0)
    params = {n: w0[n].float().clone().requires_grad_(True) for n in names}
    del w0
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, grad1 = [], None
    for step, batch in enumerate(batches):
        loss = loss_fn(params, batch, model, mm)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
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
    w0 = data.lm_weights(model, seed, device)
    change = {n: float(torch.linalg.vector_norm((params[n].detach() - w0[n].float()).double()))
              for n in names}
    return {"losses": losses, "grad1": grad1, "change": change}


def judge(prog: dict, ref: dict) -> dict[str, float]:
    """``loss_gap``, ``grad_gap`` and ``update_gap`` of the program's
    readings ``prog`` against the reference's ``ref`` (both as ``train``
    returns them)."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]):
        loss_gap = math.inf
    names = list(ref["grad1"])
    g_ref = np.array([ref["grad1"][n] for n in names])
    g_med = float(np.median(g_ref))
    grad_gap = max(abs(prog["grad1"][n] - ref["grad1"][n]) / max(ref["grad1"][n], g_med)
                   for n in names)
    moving = [n for n in names if ref["grad1"][n] >= 1e-3 * g_med]
    c_med = float(np.median([ref["change"][n] for n in moving]))
    update_gap = max(abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], c_med)
                     for n in moving)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap}
