"""Public dispatch for flash attention: the CUDA kernel for a tensor on the
card, the plain version for a tensor on the CPU (or ``use_pallas=False``).

Unlike the TPU dispatch (``repro/kernels/flash_attention/ops.py``) nothing
is padded: the kernel masks ragged query rows, keys and head dims itself,
and it reads strided q, k and v (so the model's (B, S, H, D) activations go
in without a transpose copy).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import gqa_attention_ref


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    use_pallas: bool = True,
) -> torch.Tensor:
    """Causal (or full) GQA attention: q (B, Hq, Sq, D), k and v (B, Hkv,
    Sk, D) → (B, Hq, Sq, D) in q's dtype.  A CUDA tensor launches the kernel
    (or raises); only a CPU tensor or ``use_pallas=False`` takes the plain
    version."""
    if not use_pallas or q.device.type == "cpu":
        return gqa_attention_ref(q, k, v, causal=causal).to(q.dtype)
    return flash_attention_cuda(q, k, v, causal=causal)
