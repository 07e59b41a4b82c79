"""Rounding to the precisions below the ones the configurations state, for
the controls: TF32 (for float32 work) and fp8 e4m3 (for bfloat16 work).
Both are plain tensor arithmetic, so a control computes the same numbers on
the CPU as on the card."""
from __future__ import annotations

import torch

FP8_MAX = 448.0   # largest finite float8_e4m3fn


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10 explicit mantissa bits (to nearest,
    ties away from zero), as the tensor cores round a TF32 operand."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one per-tensor scale (the amax mapped
    to the largest finite value), back in f32."""
    x = x.float()
    scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with both operands in fp8, forward and backward (the
    incoming gradient too), accumulated in f32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a), round_fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg
