"""WRE sampling (paper §3.1.2): Taylor-softmax probabilities and weighted
sampling without replacement.  Port of ``repro.core.exploration``.

Sampling without replacement uses the Efraimidis–Spirakis race in Gumbel
form, ``top_k(log p + Gumbel)``, one device op over the whole dataset.
"""
from __future__ import annotations

import torch


def taylor_softmax(g: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Second-order Taylor-softmax (paper Eq. 5): p_i ∝ 1 + g_i + g_i²/2.

    Strictly positive for all real g (minimum 0.5 at g = -1), so it is
    defined for the negative marginal gains disparity-min produces.
    """
    w = 1.0 + g + 0.5 * g * g
    return w / w.sum(dim=dim, keepdim=True)


def weighted_sample_without_replacement(
    p: torch.Tensor,
    k: int,
    *,
    generator: torch.Generator | None = None,
    noise=None,
) -> torch.Tensor:
    """Draw k distinct indices with probabilities ∝ ``p`` (Gumbel top-k).

    ``noise`` ((m,) Gumbel draws) replaces the generator's.  Zero-probability
    entries are masked to -inf, so they can never be drawn; ``k`` larger
    than the nonzero support raises.
    """
    support = int((p > 0.0).sum())
    if k > support:
        raise ValueError(
            f"cannot draw k={k} distinct indices from a distribution "
            f"with only {support} nonzero-probability elements"
        )
    if noise is None:
        noise = torch.empty(p.shape, dtype=torch.float32, device=p.device).exponential_(
            generator=generator).log_().neg_()
    else:
        noise = torch.as_tensor(noise, dtype=torch.float32, device=p.device)
    logp = torch.where(p > 0.0, torch.log(p.clamp_min(1e-30)),
                       torch.full_like(p, float("-inf")))
    return (logp + noise).topk(k).indices
