#!/usr/bin/env python3
"""Run ``chip_smoke.py`` of two checkouts of the repo in turn on one card.

    python3 scripts/ab_smoke.py PARENT CHANGE [--order PCCP] [--out build/ab_logs] [--serving | --training]

PARENT and CHANGE are directories that each hold a checkout (for example
``git archive <commit>`` unpacked); the runs go in ``--order`` (P for the
parent, C for the change; the default P, C, C, P interleaves them, so that a
drift of the card over the call shows in both).  Each checkout builds its own
kernels into its own ``build/``.  Each run's whole output goes to
``OUT/<i>_<P|C>.log``; this script prints, per run, the lines that compare
two builds of the port: the gram-free gains kernel's times, the phase 5 and
7 stage times, launches, accuracy and peak memory, the SSD chunk kernel's
phase 10-11 lines, phases 12-13's prefill per request and decode steps, and
the SHA-256 of the importance and bank of every ``MiloMetadata`` artifact
the run saves (phases 5 and 7).  The digests come from a hook on ``MiloMetadata.save`` set
before the checkout's own smoke starts, so a checkout whose smoke prints no
digest is compared the same way.  Exits non-zero if a run fails or if the
runs' artifacts differ.

With ``--serving`` each run drives only phases 1, 2, 12 and 13 of its
checkout's smoke (device, kernel build, yi-6b and Jamba serving through
``ServeEngine``), whose prefill and decode lines are printed; no artifact
is saved, so none is compared.  With ``--training`` each run drives phases
1, 2, 5, 14 and 15 (device; kernel build; the main path at full width, whose artifact
digests are compared; fused training against the step loop; tuning), whose
stage, train and sweep lines are printed.
"""
from __future__ import annotations

import argparse
import hashlib
import runpy
import subprocess
import sys
import time
from pathlib import Path

# lines of a smoke's output that compare two builds
KEYS = ("fl_gains_gram_free (8192, 8192, 768), ", "  on the card alone", "  bound over the",
        "  SM clock", "similarity (2048, 5000, 768) float32 normalized=True: kernel", "== phase",
        "preprocess ", "train ", "launches", "similarity launches", "full recomputes",
        "max_memory_allocated", "sha256 of", "[ab] artifact", "similarity: {",
        "fl_gains_gram_free ring: {", "total ",
        # the SSD chunk (B6): phase 10's instances and errors, the tensor
        # cores' sum against its model, phase 11's times, bounds and clock,
        # the build's per-instance report; phases 12-13's serving: prefill
        # per request, decode steps, launches, Jamba's per-layer route error
        "ssd_chunk: ", "ssd_chunk simt instance: ", "mma.sync TF32 sums", "ssd_chunk jamba",
        "  ssd_chunk", "ssd_chunk mma: {", "ssd_chunk simt: {",
        "yi-6b: served", "jamba-1.5-large-398b: served", "  prefill per request", "  decode steps",
        "  launches: flash_attention", "  ssd_chunk launches expected", "jamba request 0",
        # phases 14-15: the step loop, the fused engine, the three sweeps
        "loop: ", "fused: ", "full: ", "milo: ", "milo_fixed: ")


def run_smoke(tree: Path, mode: str | None = None) -> None:
    """Run ``tree``'s ``chip_smoke.py`` as ``__main__`` with the digest hook,
    or only its serving phases (``mode="serving"``) or its training and
    tuning phases (``mode="training"``, with the hook)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(tree / "src"))
    if mode == "serving":
        smoke = runpy.run_path(str(tree / "chip_smoke.py"), run_name="chip_smoke_ab")
        smoke["phase_device"](False)
        smoke["phase_build"]()
        smoke["phase_lm_serving"](torch.device("cuda"), rehearsal=False)
        return
    from repro_torch.core.metadata import MiloMetadata

    save = MiloMetadata.save

    def save_and_digest(self, path: str) -> None:
        for name in ("wre_importance", "sge_subsets"):
            arr = np.ascontiguousarray(getattr(self, name))
            print(f"[ab] artifact {Path(path).name}: sha256 of {name} "
                  f"{hashlib.sha256(arr.tobytes()).hexdigest()}", flush=True)
        save(self, path)

    MiloMetadata.save = save_and_digest
    if mode == "training":
        smoke = runpy.run_path(str(tree / "chip_smoke.py"), run_name="chip_smoke_ab")
        smoke["phase_device"](False)
        smoke["phase_build"]()
        dev = torch.device("cuda")
        run = smoke["phase_main_path"](dev, n=60000, n_classes=10, dim=768, epochs=12)
        data = [run[k] for k in ("x", "y", "tx", "ty")]
        smoke["phase_fused_training"](dev, *data, run["session"].metadata, epochs=12)
        smoke["phase_tuning"](dev, *data, run["session"].metadata)
        return
    sys.argv = [str(tree / "chip_smoke.py")]
    runpy.run_path(str(tree / "chip_smoke.py"), run_name="__main__")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, nargs="?")
    ap.add_argument("change", type=Path, nargs="?")
    ap.add_argument("--order", default="PCCP")
    ap.add_argument("--out", type=Path, default=Path("build/ab_logs"))
    modes = ap.add_mutually_exclusive_group()
    modes.add_argument("--serving", dest="mode", action="store_const", const="serving",
                       help="phases 1, 2, 12 and 13 only")
    modes.add_argument("--training", dest="mode", action="store_const", const="training",
                       help="phases 1, 2, 5, 14 and 15 only")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)  # one run, in a child process
    args = ap.parse_args()
    if args.run:
        run_smoke(args.run.resolve(), args.mode)
        return 0
    if args.parent is None or args.change is None or set(args.order) - {"P", "C"}:
        ap.error("give PARENT and CHANGE, and an --order of P and C")
    args.out.mkdir(parents=True, exist_ok=True)
    digests: dict[str, set[str]] = {}
    failed = False
    for i, label in enumerate(args.order, 1):
        tree = (args.parent if label == "P" else args.change).resolve()
        log = args.out / f"{i}_{label}.log"
        t0 = time.perf_counter()
        with open(log, "w") as f:
            cmd = [sys.executable, str(Path(__file__).resolve()), "--run", str(tree)]
            rc = subprocess.run(cmd + ([f"--{args.mode}"] if args.mode else []),
                                stdout=f, stderr=subprocess.STDOUT).returncode
        lines = log.read_text().splitlines()
        print(f"== run {i} {label} ({tree}): exit {rc}, {time.perf_counter() - t0:.0f} s, "
              f"log {log}", flush=True)
        for line in lines:
            if line.startswith(KEYS):
                print("  " + line[:400], flush=True)
            if line.startswith("[ab] artifact"):
                key, digest = line.rsplit(" ", 1)
                digests.setdefault(key, set()).add(digest)
        failed = failed or rc != 0
    same = all(len(v) == 1 for v in digests.values())
    for key, values in sorted(digests.items()):
        print(f"{key}: {'the same in every run' if len(values) == 1 else 'DIFFERS: ' + str(values)}")
    serving = args.mode == "serving"
    if not digests and not serving:
        print("no artifact digests were printed")
    return 1 if failed or not same or not (digests or serving) else 0


if __name__ == "__main__":
    sys.exit(main())
