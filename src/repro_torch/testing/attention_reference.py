"""Plain f32 causal attention and its gradients for long sequences, the
reference that the fused attention pair's checks compare against."""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn


def naive_by_kv_head(qkv, g) -> list[torch.Tensor]:
    """``_naive_attn``'s causal output and dq, dk, dv in f32 for (B, S, H, D)
    ``qkv`` and output gradient ``g``, one batch row and key / value head at
    a time (a long sequence's whole (B, H, S, S) scores would not fit)."""
    q, k, v = (t.detach().float() for t in qkv)
    b, hq, hkv = q.shape[0], q.shape[2], k.shape[2]
    grp = hq // hkv
    out, dq, dk, dv = (torch.empty_like(t) for t in (q, q, k, v))
    for i in range(b):
        for j in range(hkv):
            heads = slice(j * grp, (j + 1) * grp)
            part = [t[i:i + 1, :, hh].clone().requires_grad_() for t, hh in
                    ((q, heads), (k, slice(j, j + 1)), (v, slice(j, j + 1)))]
            o = attn._naive_attn(*part, causal=True)
            grads = torch.autograd.grad(o, part, g[i:i + 1, :, heads].float())
            out[i:i + 1, :, heads] = o.detach()
            dq[i:i + 1, :, heads] = grads[0]
            dk[i:i + 1, :, j:j + 1], dv[i:i + 1, :, j:j + 1] = grads[1], grads[2]
    return [out, dq, dk, dv]
