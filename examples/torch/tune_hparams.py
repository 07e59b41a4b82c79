"""Hyper-parameter tuning example: TPE + Hyperband with MILO subsets through
``MiloSession.tune`` (the paper's 20-75x tuning-speedup pipeline), on the
PyTorch port.

Run:  PYTHONPATH=src python examples/torch/tune_hparams.py [--device cpu]
"""
import argparse
import time

from repro_torch.data.datasets import GaussianMixtureDataset
from repro_torch.selection import MiloSession, MiloSessionConfig

SPACE = {"lr": ("log", 3e-3, 0.3), "hidden": ("choice", [32, 64, 128])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=1200, help="dataset rows")
    ap.add_argument("--max-budget", type=int, default=9, help="Hyperband's largest budget")
    ap.add_argument("--use-pallas", action="store_true",
                    help="build the Gram tiles with the hand-written similarity kernel "
                         "(the default is the plain product, as in the reference)")
    args = ap.parse_args(argv)

    ds = GaussianMixtureDataset(n=args.n, n_classes=6, dim=24, seed=0)
    tr, va, te = ds.split()
    feats, labs = ds.features()[tr], ds.y[tr]
    vx, vy = ds.features()[va], ds.y[va]

    session = MiloSession(MiloSessionConfig(
        subset_fraction=0.1, n_sge_subsets=4, total_epochs=30, eval_every_epochs=10,
        use_pallas=args.use_pallas,
    ), device=args.device)
    session.preprocess(feats, labs)

    out = {}
    for name in ("full", "milo"):
        t0 = time.time()
        res = session.tune(feats, labs, vx, vy, SPACE,
                           selector=name, search="tpe", max_budget=args.max_budget, eta=3)
        wall = time.time() - t0
        print(f"{name:9s} best={res.best_score:.4f} "
              f"config={res.best_config} trials={len(res.trials)} "
              f"wall={wall:.1f}s")
        out[name] = {"best": res.best_score, "trials": len(res.trials), "wall_s": wall}
    return out


if __name__ == "__main__":
    main()
