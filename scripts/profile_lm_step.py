#!/usr/bin/env python3
"""Where a training step of the port's LM spends its time on one card.

    python3 scripts/profile_lm_step.py [--arch internlm2-1.8b] [--steps 3] [--out build/profile]

Builds ``launch/train.py``'s run (random weights from seed 0, the arch's
preset: bf16, chunked attention, remat), warms up with two steps, then
times ``--steps`` steps with CUDA events split into loss + gradients, the
global-norm clip and the AdamW update, counts one step's synchronising calls
(``torch.cuda.set_sync_debug_mode``) by source line, and traces one more
step with ``torch.profiler`` (CPU and CUDA activities): the operators by
device time, the device's busy time against the step's wall time, and the
kernel launches.  Prints the card's ``nvidia-smi`` name and power limit; writes
the full operator table to ``OUT/ops.txt``.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "build" / "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_lm_step: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import train as launch
    from repro_torch.optim.optimizers import adamw, clip_by_global_norm
    from repro_torch.optim.schedules import cosine
    from repro_torch.train.train_state import TrainState, _loss_and_grads

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"torch {torch.__version__}, {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    run = launch.build(launch.parse_args(["--arch", args.arch, "--device", "cuda"]))
    cfg, state, pipe = run["cfg"], run.pop("state"), run["pipeline"]
    put = run["trainer"].put_batch
    batches = [put(b) for b in pipe.epoch(0)]
    opt, sched = adamw(), cosine(1e-3, 32)

    def step(state, batch, marks=None):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss, grads = _loss_and_grads(state.params, cfg, batch)
        ev[1].record()
        grads, _ = clip_by_global_norm(grads, 1.0)
        ev[2].record()
        params, opt_state = opt.update(grads, state.opt_state, state.params, sched(state.step))
        ev[3].record()
        if marks is not None:
            marks.append(ev)
        return TrainState(params, opt_state, state.step + 1)

    for b in batches[:2]:
        state = step(state, b)
    torch.cuda.synchronize()
    marks = []
    t0 = time.perf_counter()
    for b in batches[2:2 + args.steps]:
        state = step(state, b, marks)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / args.steps * 1e3
    parts = np.array([[a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])] for ev in marks])
    print(f"{args.arch}: {args.steps} steps, wall {wall:.1f} ms a step; device ms (median): "
          f"loss+grads {np.median(parts[:, 0]):.1f}, clip {np.median(parts[:, 1]):.1f}, "
          f"adamw {np.median(parts[:, 2]):.1f}")
    # the step's synchronising calls (each makes the host wait for the card)
    import collections
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state = step(state, batches[2 + args.steps])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in caught
                                if "synchroniz" in str(w.message))
    print(f"synchronising calls in one step: {sum(where.values())} {dict(where.most_common(8))}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = step(state, batches[3 + args.steps])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device-side events only (kernels, copies, sets): their own intervals
    device = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    print(f"traced step: wall {wall:.1f} ms, device busy {busy_ms:.1f} ms "
          f"({100 * busy_ms / wall:.1f}% of the wall), {len(device)} device ops")
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    print(table)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "ops.txt").write_text(events.table(sort_by="self_device_time_total", row_limit=400))
    return 0


if __name__ == "__main__":
    sys.exit(main())
