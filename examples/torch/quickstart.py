"""Quickstart: MILO end-to-end through the ``MiloSession`` facade, on the
PyTorch port.

1. Build a dataset + frozen-encoder features.
2. ``session.preprocess`` — one-time pass producing the shareable artifact.
3. ``session.train`` — a classifier on the easy-to-hard curriculum.
4. Train a SECOND model from the SAME artifact, loaded from disk by a fresh
   session — zero extra selection cost: the model-agnostic claim in action.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""
import argparse
import time

from repro_torch.data.datasets import GaussianMixtureDataset
from repro_torch.selection import MiloSession, MiloSessionConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--artifact", default="/tmp/milo_quickstart.npz")
    ap.add_argument("--n", type=int, default=4000, help="dataset rows")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--use-pallas", action="store_true",
                    help="build the Gram tiles with the hand-written similarity kernel "
                         "(the default is the plain product, as in the reference)")
    args = ap.parse_args(argv)

    ds = GaussianMixtureDataset(n=args.n, n_classes=6, dim=32, seed=0)
    tr, va, te = ds.split()
    feats, labs = ds.features()[tr], ds.y[tr]
    tx, ty = ds.features()[te], ds.y[te]

    cfg = MiloSessionConfig(
        subset_fraction=0.1, n_sge_subsets=6, total_epochs=args.epochs,
        hidden=256, sub_steps=8, use_pallas=args.use_pallas,
        metadata_path=args.artifact,
    )
    session = MiloSession(cfg, device=args.device)

    # --- 1x preprocessing ----------------------------------------------------
    t0 = time.time()
    md = session.preprocess(feats, labs, force=True)
    print(f"preprocessed {len(tr)} samples -> k={md.k} in {time.time()-t0:.1f}s "
          f"(artifact {args.artifact}, config hash {md.config_hash()})")

    # --- full-data skyline ---------------------------------------------------
    full = session.train(feats, labs, test_x=tx, test_y=ty, selector="full")
    print(f"FULL       acc={full.final_acc:.4f}  time={full.train_time:.1f}s")

    # --- model 1 on MILO subsets ---------------------------------------------
    m1 = session.train(feats, labs, test_x=tx, test_y=ty)
    print(f"MILO (10%) acc={m1.final_acc:.4f}  time={m1.train_time:.1f}s  "
          f"speedup={full.train_time/m1.train_time:.1f}x")

    # --- model 2: a FRESH session loads the saved artifact -------------------
    session2 = MiloSession(cfg, device=args.device)
    session2.preprocess(feats, labs)          # loads; does not recompute
    assert session2.loaded_from_artifact, "artifact must be reused, not rebuilt"
    m2 = session2.train(feats, labs, test_x=tx, test_y=ty, seed=1)
    print(f"MILO again acc={m2.final_acc:.4f}  (selection cost: 0 — amortized; "
          f"artifact loaded from disk)")
    return {"k": md.k, "full_acc": full.final_acc, "milo_acc": m1.final_acc,
            "milo_again_acc": m2.final_acc}


if __name__ == "__main__":
    main()
