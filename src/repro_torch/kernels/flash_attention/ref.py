"""Plain PyTorch version of the flash-attention kernel (the CPU path and the
oracle the CUDA kernel is held against on the card)."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import KernelInputError


def gqa_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Grouped-query attention over materialised scores, in f32.

    q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D) with Hq % Hkv == 0.  The causal
    mask is aligned to the *end* of the key axis: query i attends keys
    j <= i + (Sk - Sq).  K and V are not repeated: the query heads are
    grouped onto their kv head (head h reads kv head h // group).
    Returns (B, Hq, Sq, D) float32.
    """
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if hq % hkv:
        raise KernelInputError(f"{hq} query heads are not a multiple of {hkv} kv heads")
    group = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qg = q.float().reshape(b, hkv, group * sq, d)
    logits = (qg @ k.float().transpose(-1, -2)) * scale                # (B, Hkv, G*Sq, Sk)
    logits = logits.reshape(b, hkv, group, sq, sk)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        kj = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(kj > qi, float("-inf"))
    p = torch.softmax(logits, dim=-1).reshape(b, hkv, group * sq, sk)
    return (p @ v.float()).reshape(b, hq, sq, d)
