"""Kernel-free (feature-based) submodular selection (port of
``repro.core.feature_submodular``) — the paper's stated future work (§5:
"we will investigate feature-based submodular functions to avoid the need
for similarity kernel construction").

Instead of the m×m Gram matrix, every sample is represented by its
similarity row to L ≪ m *landmarks* (k-means++ centres chosen on the
device):

    Φ[i, l] = 0.5 + 0.5 · cos(z_i, c_l)            (m × L, not m × m)

Facility location is then evaluated against the landmark set as the ground
set being covered:  f(S) = Σ_l max_{j∈S} Φ[j, l]  — a Nyström-style
approximation whose gains cost O(L) per candidate instead of O(m), giving
O(m·L·k) total selection (vs O(m²·k)) and O(m·L) memory.

Graph-cut gets the analogous treatment: colsum_j ≈ (m/L) Σ_l Φ[j, l] and the
S×S penalty uses the landmark inner products as a low-rank kernel surrogate
K̂ = Φ Φᵀ / L.

The set functions follow ``core.submodular``'s batched form (a leading run
axis ``B`` on every state) and run on ``core.greedy.greedy``.  The gains are
plain PyTorch, as they are plain ``jnp`` in the reference.

Randomness: k-means++ draws its first centre uniformly and each later one
with probability proportional to the squared distance to the nearest
centre, a Gumbel-max draw.  Both come from a ``torch.Generator`` seeded by
``seed`` on the device; the keyword-only seam ``draws=(first, noise)`` takes
them instead — the first centre's row and the (L-1, m) Gumbel draws, one
row per later centre — which is how the parity tests replay the
reference's JAX draws.

Lloyd's step compares every row with every centre through the per-element
differences ``(z_i - c_l)²`` summed over the width, as the reference does,
but a block of rows at a time (``_LLOYD_ELEMENTS`` elements of the
difference tensor), never the whole (m, L, d) tensor; the expanded form
``|z|² - 2 z·c + |c|²`` would round differently and move ``argmin``'s
near-ties.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.greedy import greedy, gumbel
from repro_torch.core.similarity import normalize_rows
from repro_torch.core.submodular import SetFunction, State
from repro_torch.device import resolve_device

#: elements of Lloyd's (rows, L, d) difference block (512 MiB in fp32)
_LLOYD_ELEMENTS = 1 << 27


def _draws(draws: tuple[int, Any] | None, m: int, n_landmarks: int,
           device: torch.device) -> tuple[int | None, torch.Tensor | None]:
    if draws is None:
        return None, None
    first, noise = draws
    noise = torch.as_tensor(np.asarray(noise), dtype=torch.float32, device=device)
    if tuple(noise.shape) != (n_landmarks - 1, m):
        raise ValueError(f"noise has shape {tuple(noise.shape)}, expected "
                         f"({n_landmarks - 1}, {m})")
    return int(first), noise


def _lloyd_assign(z: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """``argmin_l Σ_d (z_id - c_ld)²`` for every row, a block of rows at a time."""
    m, d = z.shape
    rows = max(1, _LLOYD_ELEMENTS // max(1, centers.shape[0] * d))
    assign = torch.empty((m,), dtype=torch.int64, device=z.device)
    for r0 in range(0, m, rows):
        diff = z[r0:r0 + rows, None, :] - centers[None]
        assign[r0:r0 + rows] = diff.square_().sum(dim=-1).argmin(dim=-1)
    return assign


def kmeans_pp_landmarks(z: torch.Tensor, n_landmarks: int, *, n_iters: int = 8,
                        seed: int = 0, draws: tuple[int, Any] | None = None) -> torch.Tensor:
    """k-means++ init + ``n_iters`` Lloyd iterations on ``z``'s device;
    returns the (n_landmarks, d) float32 centres."""
    z = z.to(torch.float32)
    m, d = z.shape
    dev = z.device
    first, noise = _draws(draws, m, n_landmarks, dev)
    gen = None
    if draws is None:
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        first_t = torch.randint(0, m, (1,), generator=gen, device=dev)
    else:
        first_t = torch.tensor([first], dtype=torch.int64, device=dev)
    centers = torch.zeros((n_landmarks, d), dtype=torch.float32, device=dev)
    c = z.index_select(0, first_t)[0]
    centers[0] = c
    dist2 = (z - c).square().sum(dim=-1)
    for i in range(1, n_landmarks):
        # sample the next centre with probability proportional to dist2
        p = dist2 / torch.clamp(dist2.sum(), min=1e-12)
        g = noise[i - 1] if noise is not None else gumbel((m,), gen, dev)
        idx = (torch.log(torch.clamp(p, min=1e-30)) + g).argmax().reshape(1)
        c = z.index_select(0, idx)[0]
        centers[i] = c
        dist2 = torch.minimum(dist2, (z - c).square().sum(dim=-1))

    for _ in range(n_iters):
        assign = _lloyd_assign(z, centers)
        onehot = torch.nn.functional.one_hot(assign, n_landmarks).to(torch.float32)
        sizes = onehot.sum(0)
        new = (onehot.T @ z) / torch.clamp(sizes, min=1.0)[:, None]
        # keep empty clusters where they were
        centers = torch.where((sizes > 0)[:, None], new, centers)
    return centers


def landmark_features(z: torch.Tensor, n_landmarks: int, *, seed: int = 0,
                      draws: tuple[int, Any] | None = None) -> torch.Tensor:
    """Φ (m, L): rescaled-cosine similarity of every sample to each landmark."""
    centers = kmeans_pp_landmarks(z, n_landmarks, seed=seed, draws=draws)
    zn = normalize_rows(z.to(torch.float32))
    cn = normalize_rows(centers)
    return 0.5 + 0.5 * (zn @ cn.T)


# --- feature-based facility location ---------------------------------------
# state c[b, l] = max_{j in S_b} Φ[j, l]; gains(j) = Σ_l relu(Φ[j, l] - c[l]).
# The "K" argument threaded through the greedy engines is Φ here.

def _ffl_init(phi: torch.Tensor, batch: int) -> State:
    return {"c": torch.zeros((batch, phi.shape[1]), dtype=phi.dtype, device=phi.device)}


def _ffl_gains(state: State, phi: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.relu(phi - c[None, :]).sum(dim=1) for c in state["c"]])


def _ffl_update(state: State, phi: torch.Tensor, j: torch.Tensor) -> State:
    torch.maximum(state["c"], phi.index_select(0, j), out=state["c"])
    return state


def _ffl_eval(mask: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    if not bool(mask.any()):
        return phi.new_zeros(())
    return phi[mask].max(dim=0).values.sum()


feature_facility_location = SetFunction(
    "feature_facility_location", _ffl_init, _ffl_gains, _ffl_update, _ffl_eval)


# --- feature-based graph cut -------------------------------------------------

def make_feature_graph_cut(lam: float = 0.4) -> SetFunction:
    """Graph-cut on the low-rank surrogate K̂ = Φ Φᵀ / L."""

    def init(phi: torch.Tensor, batch: int) -> State:
        L = phi.shape[1]
        colsum = phi @ (phi.sum(dim=0) / L)              # Σ_i K̂[i, j]
        return {"colsum": colsum,
                "acc": torch.zeros((batch, L), dtype=phi.dtype, device=phi.device)}

    def gains(state: State, phi: torch.Tensor) -> torch.Tensor:
        L = phi.shape[1]
        diag = (phi * phi).sum(dim=1) / L
        cur = state["acc"] @ phi.T / L                   # Σ_{i in S} K̂[i, j]
        return state["colsum"] - lam * (2.0 * cur + diag)

    def update(state: State, phi: torch.Tensor, j: torch.Tensor) -> State:
        state["acc"] += phi.index_select(0, j)
        return state

    def evaluate(mask: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
        L = phi.shape[1]
        s = phi.T @ mask.to(phi.dtype)                   # Σ_{j in S} Φ[j]
        total = phi.sum(dim=0)
        return (total @ s) / L - lam * (s @ s) / L

    return SetFunction("feature_graph_cut", init, gains, update, evaluate)


feature_graph_cut = make_feature_graph_cut(0.4)


class FeatureSelection(NamedTuple):
    indices: torch.Tensor
    phi: torch.Tensor


def default_landmarks(m: int, k: int) -> int:
    """The reference's default L: ``max(16, min(4k, m // 2))``."""
    return max(16, min(4 * k, m // 2))


def feature_greedy_select(
    z: Any, k: int, *, n_landmarks: int | None = None,
    fn: SetFunction = feature_facility_location, seed: int = 0,
    draws: tuple[int, Any] | None = None, device: str | torch.device = "cuda",
) -> FeatureSelection:
    """End-to-end kernel-free selection: landmarks -> Φ -> greedy, on
    ``device`` (the card unless the caller asks for the CPU)."""
    z = torch.as_tensor(np.asarray(z) if not torch.is_tensor(z) else z,
                        dtype=torch.float32, device=resolve_device(device))
    if n_landmarks is None:
        n_landmarks = default_landmarks(z.shape[0], k)
    phi = landmark_features(z, n_landmarks, seed=seed, draws=draws)
    res = greedy(fn, phi, k)
    return FeatureSelection(res.indices, phi)
