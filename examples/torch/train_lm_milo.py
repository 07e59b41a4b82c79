"""End-to-end example on the PyTorch port: train an assigned-architecture LM
on MILO-selected data with checkpointing + restart.

Trains the granite-moe smoke config for a few hundred steps on the synthetic
LM corpus, with MILO's curriculum choosing the document subset each epoch,
then kills and resumes from the checkpoint to demonstrate fault tolerance.

Run:  PYTHONPATH=src python examples/torch/train_lm_milo.py [--steps 200] [--device cpu]
"""
import argparse
import shutil
import time

import torch

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.core import MiloPreprocessor
from repro_torch.data.datasets import TokenLMDataset
from repro_torch.data.pipeline import Pipeline
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import cosine
from repro_torch.selection import build_selector
from repro_torch.train.train_state import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-moe-1b-a400m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default="/tmp/milo_lm_ckpt")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--use-pallas", action="store_true",
                    help="build the Gram tiles with the hand-written similarity kernel "
                         "(the default is the plain product, as in the reference)")
    args = ap.parse_args(argv)

    shutil.rmtree(args.ckpt, ignore_errors=True)
    cfg = registry.smoke(args.arch)
    ds = TokenLMDataset(n_docs=256, seq_len=64, vocab=cfg.vocab_size, seed=0)

    # MILO preprocessing over document features (frozen-encoder stand-in)
    pre = MiloPreprocessor(subset_fraction=0.5, n_sge_subsets=4, classwise=False,
                           use_pallas=args.use_pallas, device=args.device)
    md = pre.preprocess(ds.features(), None, 0)

    batch_size = 16
    steps_per_epoch = md.k // batch_size
    epochs = max(1, args.steps // steps_per_epoch)
    sel = build_selector("milo", metadata=md, total_epochs=epochs, kappa=1 / 6, R=1,
                         device=args.device)
    pipe = Pipeline(ds.batch, sel, batch_size, seed=0, device=args.device)

    opt = adamw()
    step_fn = make_train_step(cfg, opt, cosine(1e-3, args.steps, warmup=10))
    state = init_train_state(cfg, opt, seed=0, device=args.device)
    trainer = Trainer(step_fn, pipe, TrainerConfig(
        epochs=epochs, checkpoint_dir=args.ckpt, checkpoint_every_steps=10,
        log_every_steps=10))

    t0 = time.time()
    state = trainer.fit(state)
    losses = [h["loss"] for h in trainer.history if "loss" in h]
    print(f"trained {int(state.step)} steps in {time.time()-t0:.1f}s; "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "loss must decrease"

    # --- simulate failure + restart -----------------------------------------
    print("simulating restart from checkpoint...")
    state2 = init_train_state(cfg, opt, seed=0, device=args.device)  # fresh init
    trainer2 = Trainer(step_fn, pipe, TrainerConfig(
        epochs=epochs, checkpoint_dir=args.ckpt, log_every_steps=10))
    resumed = trainer2.fit(state2, resume=True)
    a, b = tree.leaves(state.params), tree.leaves(resumed.params)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b)), \
        "restart must restore the exact state"
    print("restart OK — resumed to identical parameters")
    return {"steps": int(state.step), "loss_first": float(losses[0]),
            "loss_last": float(losses[-1])}


if __name__ == "__main__":
    main()
