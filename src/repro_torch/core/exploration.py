"""Data-exploration strategies (paper §3.1.2): Taylor-softmax
probabilities, weighted sampling without replacement, the WRE distribution
and the SGE subset bank.  Port of ``repro.core.exploration``.

Sampling without replacement uses the Efraimidis–Spirakis race in Gumbel
form, ``top_k(log p + Gumbel)``, one device op over the whole dataset.
"""
from __future__ import annotations

from typing import NamedTuple

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


class WREDistribution(NamedTuple):
    """Multinomial sampling distribution over the dataset (global indices)."""

    probs: torch.Tensor        # (m,) float32, sums to 1
    importance: torch.Tensor   # (m,) float32 raw greedy gains (diagnostics / metadata)

    def sample(self, k: int, *, generator: torch.Generator | None = None,
               noise=None) -> torch.Tensor:
        return weighted_sample_without_replacement(self.probs, k, generator=generator,
                                                   noise=noise)


class SGEBank(NamedTuple):
    """Pre-selected subset bank from SGE (global indices)."""

    subsets: torch.Tensor  # (n_subsets, k) integer

    @property
    def n_subsets(self) -> int:
        return int(self.subsets.shape[0])

    def subset_for_epoch(self, epoch: int, R: int) -> torch.Tensor:
        """Rotate through the bank every R epochs."""
        return self.subsets[(epoch // max(R, 1)) % self.n_subsets]


def build_wre(importance) -> WREDistribution:
    """The WRE distribution of ``importance`` (a tensor or an array; kept on
    its device): Taylor-softmax probabilities in f32."""
    imp = torch.as_tensor(importance).to(torch.float32)
    return WREDistribution(probs=taylor_softmax(imp), importance=imp)
