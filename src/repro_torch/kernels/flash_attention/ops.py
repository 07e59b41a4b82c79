"""Public dispatch for flash attention: the CUDA kernel for a tensor on the
card, the plain version for a tensor on the CPU (or ``use_pallas=False``).

Unlike the TPU dispatch (``repro/kernels/flash_attention/ops.py``) nothing
is padded on the model's path: the kernels mask ragged query rows, keys and
head dims themselves, and read strided q, k and v (so the model's (B, S, H,
D) activations go in without a transpose copy).  Only a bf16 input that the
tensor-core kernel's TMA maps cannot address in place — a base off 16-byte
alignment, a stride that is not a multiple of 8 elements, or D % 8 != 0 —
is copied first: exactly, into a contiguous tensor, with D zero-padded to a
multiple of 8 (zero columns add nothing to q·kᵀ, and the output's pad
columns are sliced off).  Mixed dtypes (a bf16 q against f32 keys and
values, as cross-attention to an f32 context gives them) take what the
reference's kernel computes — every input upcast to f32 in its body, the
output in q's dtype: each bf16 input is copied to f32 and the f32 kernel
runs.  ``copies`` counts all those copies and each one is logged; the
serving path makes none.
"""
from __future__ import annotations

import logging

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.flash_attention import (
    D_MAX,
    flash_attention_cuda,
    tma_ready,
)
from repro_torch.kernels.flash_attention.ref import gqa_attention_ref

copies = 0
_log = logging.getLogger(__name__)


def tma_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> list[torch.Tensor]:
    """q, k and v as the bf16 kernel's TMA maps take them: each one that is
    not ``tma_ready`` (or all three, when D % 8 != 0: zero-padded to the next
    multiple of 8) becomes an exact contiguous copy, counted and logged."""
    global copies
    d = q.shape[-1]
    pad = -d % 8
    out = []
    for name, t in zip("qkv", (q, k, v)):
        if not pad and tma_ready(t):
            out.append(t)
            continue
        why = (f"head dim {d} padded to {d + pad}" if pad else
               f"base {t.data_ptr() % 16} bytes off 16-byte alignment, strides {t.stride()}")
        t = F.pad(t, (0, pad)) if pad else t.clone(memory_format=torch.contiguous_format)
        copies += 1
        _log.warning("flash_attention: copied %s %s for the bf16 kernel's TMA maps (%s)",
                     name, tuple(t.shape), why)
        out.append(t)
    return out


def f32_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> list[torch.Tensor]:
    """q, k and v of mixed bf16/f32 dtypes as f32: each bf16 one becomes an
    exact f32 copy, counted and logged."""
    global copies
    out = []
    for name, t in zip("qkv", (q, k, v)):
        if t.dtype == torch.bfloat16:
            copies += 1
            _log.warning("flash_attention: copied %s %s from bf16 to f32 (mixed input dtypes "
                         "%s, %s, %s)", name, tuple(t.shape), q.dtype, k.dtype, v.dtype)
            t = t.float()
        out.append(t)
    return out


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
    dtypes = {q.dtype, k.dtype, v.dtype}
    if len(dtypes) > 1 and dtypes <= {torch.bfloat16, torch.float32}:
        return flash_attention_cuda(*f32_operands(q, k, v), causal=causal).to(q.dtype)
    d = q.shape[-1]
    if (all(t.dtype == torch.bfloat16 and t.dim() == 4 for t in (q, k, v)) and d <= D_MAX
            and min(q.numel(), k.numel()) > 0):
        out = flash_attention_cuda(*tma_operands(q, k, v), causal=causal, scale=1.0 / d ** 0.5)
        return out if out.shape[-1] == d else out[..., :d]
    return flash_attention_cuda(q, k, v, causal=causal)
