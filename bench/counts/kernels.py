"""Operations and bytes of the selection kernels, from the shapes of a call.

Each input byte is read once and each output byte written once; the work is
what the inputs need (B2: the ground rows with a finite cover; B3: the
touched rows, not the padding of the gathered block).  The least time of a
call is the larger of its operations at the fp32 peak of the CUDA cores
(the kernels run IEEE fp32 FMAs, no TF32) and its bytes at HBM bandwidth.
"""
from __future__ import annotations

from bench.counts.peaks import FP32_FLOPS, HBM_BYTES_PER_S

F32 = 4


def b1(mq: int, mk: int, d: int) -> tuple[float, float]:
    """Similarity tile ``0.5 + 0.5·ẑq·ẑkᵀ`` (mq, mk) from (mq, d), (mk, d)
    normalised rows: a multiply-add per (row, column, feature)."""
    ops = 2.0 * mq * mk * d
    nbytes = F32 * (mq * d + mk * d + mq * mk)
    return ops, nbytes


def b2(n_live: int, n: int, n_cand: int, d: int, batch: int = 1) -> tuple[float, float]:
    """Gram-free gains ``Σ_i relu(0.5 + 0.5·z_i·zc_j − c_i)`` over the
    ``n_live`` ground rows with a finite cover: per (row, candidate) a
    d-long dot product and four more operations (scale, shift, subtract
    with relu, add)."""
    ops = batch * n_live * n_cand * (2.0 * d + 4.0)
    nbytes = F32 * (n * d + batch * n_cand * d + batch * n + batch * n_cand)
    return ops, nbytes


def b3(b_live: int, b: int, n_cand: int, d: int) -> tuple[float, float]:
    """Lazy gain correction over the ``b_live`` touched rows of a gathered
    block of ``b``: per (row, candidate) a d-long dot product and eight more
    operations (the similarity, two relus of differences, their difference,
    the sum)."""
    ops = b_live * n_cand * (2.0 * d + 8.0)
    nbytes = F32 * (b * d + n_cand * d + 2 * b + n_cand)
    return ops, nbytes


def bound_s(ops: float, nbytes: float, flops: float = FP32_FLOPS) -> float:
    """The least time of a call: operations at the peak or bytes at the
    bandwidth, whichever is larger."""
    return max(ops / flops, nbytes / HBM_BYTES_PER_S)
