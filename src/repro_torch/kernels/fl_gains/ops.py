"""Public dispatch for the facility-location gain kernels: the CUDA kernel
for a tensor on the card, the plain version for a tensor on the CPU, and
the plain version whenever ``use_pallas=False`` (as the reference's
``repro/kernels/fl_gains/ops.py`` routes it).

Unlike the TPU dispatch nothing is padded: the kernels mask ragged rows,
candidates and depth themselves, so their outputs already equal the
reference's sliced outputs.  ``+inf`` covers are exact zeros in both
versions.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fl_gains import fl_gains as _k
from repro_torch.kernels.fl_gains.ref import (
    fl_gains_gram_free_delta_ref,
    fl_gains_gram_free_ref,
    fl_gains_ref,
)


def _plain(t: torch.Tensor, use_pallas: bool) -> bool:
    return not use_pallas or t.device.type == "cpu"


def fl_gains(K: torch.Tensor, c: torch.Tensor, *, use_pallas: bool = True) -> torch.Tensor:
    """``g_j = Σ_i relu(K_ij − c_i)``; ``K`` ([B,] n, n_cand), ``c`` ([B,] n)."""
    if _plain(K, use_pallas):
        return fl_gains_ref(K, c)
    return _k.fl_gains_cuda(K, c)


def fl_gains_gram_free(z: torch.Tensor, zc: torch.Tensor, c: torch.Tensor, *,
                       use_pallas: bool = True) -> torch.Tensor:
    """Gram-free gains; ``z`` (n, d), ``zc`` ([B,] n_cand, d), ``c`` ([B,] n)."""
    if _plain(z, use_pallas):
        return fl_gains_gram_free_ref(z, zc, c)
    return _k.fl_gains_gram_free_cuda(z, zc, c)


def fl_gains_gram_free_delta(z: torch.Tensor, zc: torch.Tensor, c_old: torch.Tensor,
                             c_new: torch.Tensor, *, use_pallas: bool = True) -> torch.Tensor:
    """Lazy-greedy gain correction over the touched rows ``z`` (b, d).

    ``zc`` need not be the whole ground set: a candidate slice gives the
    slice of the full call's result, bit for bit."""
    if _plain(z, use_pallas):
        return fl_gains_gram_free_delta_ref(z, zc, c_old, c_new)
    return _k.fl_gains_gram_free_delta_cuda(z, zc, c_old, c_new)
