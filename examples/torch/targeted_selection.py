"""Targeted (query-conditioned) selection over partition winners, on the
PyTorch port.

The auto-labeling / active-learning shape: you hold a handful of exemplar
embeddings of a slice you care about (here: one Gaussian mode of a mixture)
and want the k ground-set rows that best *cover the queries*, not the whole
dataset.  The ``milo_targeted`` registry selector runs query facility
location — f(S) = Σ_q max_{a∈S} sim(a, q) — through the same two-level
partition→greedy→refine pipeline as ``milo_hier``, so it scales to ground
sets where a flat query sweep would not fit.

The script contrasts it with untargeted hierarchical selection: the
targeted subset concentrates on the query mode (high hit-rate), the
untargeted one spreads over all modes.

Run:  PYTHONPATH=src python examples/torch/targeted_selection.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.data.datasets import GaussianMixtureDataset
from repro_torch.selection import build_selector


def _coverage(feats: np.ndarray, idx: np.ndarray, queries: np.ndarray) -> float:
    """Mean over queries of the best cosine similarity inside the subset —
    the (rescaled) query-FL objective the targeted selector maximizes."""
    def unit(a):
        return a / np.linalg.norm(a, axis=1, keepdims=True)
    sim = 0.5 + 0.5 * unit(feats[idx].astype(np.float64)) @ unit(
        queries.astype(np.float64)).T
    return float(sim.max(axis=0).mean())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=4000, help="dataset rows")
    args = ap.parse_args(argv)

    ds = GaussianMixtureDataset(n=args.n, n_classes=8, dim=32, seed=0)
    feats, labs = ds.features(), ds.y

    # the slice we care about: 20 exemplars of class 3.  Keep k below the
    # query count so every pick buys query coverage — query FL saturates
    # once each query has a near-duplicate in the subset, and picks past
    # that point are zero-gain ties
    target = 3
    rng = np.random.default_rng(0)
    q_idx = rng.choice(np.where(labs == target)[0], size=20, replace=False)
    queries = feats[q_idx]
    k = 10

    targeted = build_selector(
        "milo_targeted", features=feats, queries=queries, k=k,
        labels=labs, partition="by_class", refine_factor=4, device=args.device,
    )
    idx_t = targeted.plan(0).indices
    hit = float(np.mean(labs[idx_t] == target))
    cov_t = _coverage(feats, idx_t, queries)
    print(f"milo_targeted: k={k} queries={len(queries)} "
          f"partitions={targeted.info['n_partitions']} "
          f"union={targeted.info['union_size']}")
    print(f"  query coverage={cov_t:.4f}  "
          f"fraction in query class {target}: {hit:.2f}")

    untargeted = build_selector(
        "milo_hier", features=feats, k=k, labels=labs,
        partition="by_class", refine_factor=2, device=args.device,
    )
    idx_u = untargeted.plan(0).indices
    base = float(np.mean(labs[idx_u] == target))
    cov_u = _coverage(feats, idx_u, queries)
    print(f"milo_hier (untargeted): "
          f"query coverage={cov_u:.4f}  "
          f"fraction in query class {target}: {base:.2f}")
    assert cov_t > cov_u
    assert hit > base, "targeted selection must concentrate on the query slice"
    print("ok: targeted plan covers the query slice")
    return {"coverage": cov_t, "untargeted_coverage": cov_u, "hit": hit, "untargeted_hit": base}


if __name__ == "__main__":
    main()
