"""End-to-end training launcher: ``--arch <id>`` + MILO-selected data (port
of ``repro.launch.train``).

MILO preprocessing over the corpus's document features → the curriculum
pipeline → the LM train step (adamw, cosine lr, global-norm clip 1.0) →
checkpoints every 20 steps with ``--ckpt`` → restart (a second run with the
same ``--ckpt`` resumes from its newest valid checkpoint).  ``--smoke`` runs
the family's reduced config; ``--device`` (default ``cuda``) says where,
and without a card ``cuda`` raises.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
      --epochs 4 --subset-fraction 0.25 --smoke --device cpu --ckpt /tmp/ckpt

Prints the reference's JSON summary (``arch``, ``selector``, ``subset_k``,
``preprocess_s``, ``steps``, ``final``, ``mean_step_s``, ``stragglers``).
"""
from __future__ import annotations

import argparse
import json
import time


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--subset-fraction", type=float, default=0.25)
    ap.add_argument("--selector", default="milo",
                    choices=["milo", "random", "adaptive_random", "full", "milo_fixed"])
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-docs", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build(args: argparse.Namespace, *, cfg=None, wrap_step=None) -> dict:
    """The launcher's run, assembled but not trained: ``cfg``, ``dataset``,
    ``pipeline``, ``train_step``, ``state``, ``trainer``, ``subset_k`` and
    ``preprocess_s``.  ``cfg`` replaces the arch's config (e.g. one with
    another ``attn_block``); the trainer runs ``wrap_step(train_step)`` when
    ``wrap_step`` is given (e.g. a timing hook)."""
    from repro_torch.configs import registry
    from repro_torch.core.milo import MiloPreprocessor
    from repro_torch.data.datasets import TokenLMDataset
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.device import grow_segments, resolve_device
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import cosine
    from repro_torch.selection import build_selector
    from repro_torch.train.train_state import init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = resolve_device(args.device)
    grow_segments(dev)
    if cfg is None:
        cfg = registry.smoke(args.arch) if args.smoke else registry.get(args.arch)
    ds = TokenLMDataset(n_docs=args.n_docs, seq_len=64, vocab=cfg.vocab_size, seed=args.seed)
    t0 = time.time()
    k = max(1, int(ds.n * args.subset_fraction))
    if args.selector == "milo":
        pre = MiloPreprocessor(subset_fraction=args.subset_fraction, n_sge_subsets=4,
                               classwise=False, device=dev)
        md = pre.preprocess(ds.features(), None, seed=args.seed)
        selector = build_selector("milo", metadata=md, total_epochs=args.epochs,
                                  seed=args.seed, device=dev)
        k = md.k
    elif args.selector == "random":
        selector = build_selector("random", n=ds.n, k=k, seed=args.seed)
    elif args.selector == "adaptive_random":
        selector = build_selector("adaptive_random", n=ds.n, k=k, seed=args.seed)
    elif args.selector == "milo_fixed":
        selector = build_selector("milo_fixed", features=ds.features(), k=k, device=dev)
    else:
        selector = build_selector("full", n=ds.n)
        k = ds.n
    preprocess_s = time.time() - t0

    pipeline = Pipeline(ds.batch, selector, args.batch_size, seed=args.seed, device=dev)
    opt = adamw()
    total_steps = max(1, pipeline.steps_per_epoch() * args.epochs)
    train_step = make_train_step(cfg, opt, cosine(args.lr, total_steps))
    state = init_train_state(cfg, opt, seed=args.seed, device=dev)
    trainer = Trainer(
        train_step if wrap_step is None else wrap_step(train_step), pipeline,
        TrainerConfig(epochs=args.epochs, checkpoint_dir=args.ckpt,
                      checkpoint_every_steps=20 if args.ckpt else 0,
                      log_every_steps=5),
    )
    return dict(cfg=cfg, dataset=ds, pipeline=pipeline, train_step=train_step, state=state,
                trainer=trainer, subset_k=int(k), preprocess_s=preprocess_s)


def summary(args: argparse.Namespace, run: dict, state) -> dict:
    """The reference's JSON summary of a finished run."""
    trainer = run["trainer"]
    trainer.monitor.drain()
    final = trainer.history[-1] if trainer.history else {}
    return {
        "arch": run["cfg"].name, "selector": args.selector, "subset_k": run["subset_k"],
        "preprocess_s": round(run["preprocess_s"], 2),
        "steps": int(state.step), "final": final,
        "mean_step_s": round(trainer.monitor.mean_step_time, 4),
        "stragglers": trainer.monitor.flagged,
    }


def train(args: argparse.Namespace, *, cfg=None, wrap_step=None) -> tuple[dict, object]:
    """Build and train: (the run of ``build`` with ``fit_s``, the host clock
    around ``fit``; the trained state).  The run hands its initial state to
    the trainer and keeps no reference to it, so training holds one state
    and the step's new one."""
    run = build(args, cfg=cfg, wrap_step=wrap_step)
    t0 = time.time()
    state = run["trainer"].fit(run.pop("state"))
    run["fit_s"] = time.time() - t0
    return run, state


def main(argv: list[str] | None = None) -> dict:
    args = parse_args(argv)
    run, state = train(args)
    out = summary(args, run, state)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
