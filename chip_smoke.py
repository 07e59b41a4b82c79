#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                   # needs a CUDA card; exits non-zero without one
    python3 chip_smoke.py --cpu-rehearsal   # tiny CPU rehearsal of phases 1, 5-9, 12-23 (tests only)

Phases, in order; any failure ends the run with a non-zero exit:

1. device: name, count, ``nvidia-smi`` name and power limit; TF32 off.
2. build: every ``src/repro_torch/csrc/*.cu`` into the git-ignored build
   directory, with the ``-Xptxas -v`` register/shared-memory report.
3. each kernel against its plain version at the main path's shapes (and,
   for the ``fl_gains`` family, at ragged shapes and for the bit-identity
   properties the engines rely on); the similarity kernel's rows against
   the gram-free kernel's tile values, bit for bit.
4. each kernel's time (CUDA events) beside its plain version, one PyTorch
   library call (or, for the fused gram-free kernels, the fp32 product
   alone as a yardstick) and the card's bound; the gram-free gains at the
   path's shape (5,000 live rows of 8,192), with every row live, and at
   (4,096, 4,096, 768) every row live (a rank's block in phase 21b, and
   16c's level-0 shape), and the lazy delta, each also on the card alone (calls queued behind a spin
   kernel) and beside its tiled instance (the kernel its ring or small-b
   instance replaced) on both measures; the delta also cold (L2 flushed
   before each call).
5. MILO's main path at full width through ``MiloSession(use_pallas=True)``:
   CIFAR-10's geometry (50,000 training rows in 10 classes, 10,000 test
   rows, d = 768, the ViT-B embedding width), preprocess with the paper's
   defaults, 12 training epochs; phase times, kernel launch counts, peak
   memory, test accuracy, artifact round trip.
6. kernel route against plain route on one class: Gram, WRE importance,
   SGE graph-cut objective per bank slot.
7. the gram-free path at the same width: ``MiloSession(gram_free=True,
   use_pallas=True, hard_fn="facility_location", lazy_gains=True,
   lazy_two_level=True)`` — no Gram; facility-location importance through
   the lazy engine and the ``fl_gains`` kernels; stage times, launches,
   full recomputes, rows gathered per lazy step, the delta's gather sizes,
   both kernels' launches per instance, peak memory, accuracy, and a
   SHA-256 of the artifact's importance and bank.
8. on class 0 of that path: kernel route against plain route, two-level
   against single-level gathers, and ``verify_argmax`` against eager greedy.
9. ``make_facility_location_pallas`` (the dense-Gram ``fl_gains`` kernel)
   against the plain facility location over class 0's Gram, greedy to 500.
10. flash attention and the SSD chunk against their plain versions at the
    serving path's shapes (yi-6b's and Jamba's heads at S 2048 and 1537,
    cross-length, non-causal, one query; Jamba's chunk, a ragged scan, two
    chunks composed), and at phase 20's shapes (whisper's 12 heads of 64:
    the encoder's 1,500 frames non-causal, a prompt's causal self-attention,
    a prompt and one decode query against the 1,500 frames; llama-vision's
    64/8 heads of 128: a prompt and one query against 1,601 patch tokens,
    its causal self-attention), bf16 and f32, repeated launches bit-equal;
    a bf16 q against f32 keys and values (one counted copy, the f32
    kernel); the bf16 flash kernel's
    worst error beside the CUDA-core kernel's (3.9e-3), held at 1e-2; every
    SSD chunk call on its mma instance (3xTF32 on the tensor cores), and
    its simt instance on the same chunk and scan through a misaligned x;
    the tensor cores' f32 sum (one ``mma.sync`` a tile) against its model
    ``kernels/ssd_chunk/tf32.py``, bit for bit.
11. their times beside their plain versions, their bounds and, for flash
    attention, ``scaled_dot_product_attention`` as the library yardstick,
    with its TFLOP/s and share of the bound at each shape (phase 20's
    shapes too); the SSD chunk
    also on the card alone, beside its simt instance (the kernel the mma
    one replaced, through a misaligned x) on both measures, against the
    f32 bound and the bound of the split's own route, with the SM clock
    while it runs.
12. the LM serving path on yi-6b at full width and depth (bf16, random
    weights, ``attention_impl="pallas"``): ``ServeEngine(max_batch=4,
    max_len=2304)`` serves 8 requests of 256-2048 prompt tokens, 32 new
    tokens each; then, for request 0, decode on the kernel route against the
    plain route's full forward, and the two routes' prefill logits.  Phases
    12-13 make no copy for the bf16 flash kernel's TMA maps.
13. the same traffic on one period of Jamba's pattern (8 layers: 1 attention
    and 7 Mamba, 4 MoE) at published widths with 8 of its 16 experts
    (``ssm_impl="pallas"`` too), every SSD chunk launch on the mma
    instance; then the kernel route against the plain route on request 0,
    with the tokens whose experts changed counted.
14. fused training against the step loop at phase 5's geometry, on its
    artifact (``adopt_metadata``): the ``milo`` selector, 12 epochs,
    ``batch_size=32`` (``benchmarks/bench_training.py``'s), so 156 steps an
    epoch; ``MiloSession(fused_training=True, superstep=32)`` runs them as
    replays of one CUDA graph per segment shape (32 and 28).  Parameters,
    momenta and per-step losses bit-equal to the loop's; both train times,
    steps/s, captures, replays and peak memory.
15. tuning: ``examples/tune_hparams.py``'s flow at phase 5's width (50,000
    training and 10,000 validation rows), a fresh session adopting phase
    5's artifact, ``tune`` with TPE over lr (log 3e-3–0.3) and hidden (32,
    64, 128), Hyperband ``max_budget=9, eta=3``, fused training, for the
    ``full``, ``milo`` and ``milo_fixed`` selectors (``milo_fixed`` rebuilds
    its subset every trial: one build is timed first and its sweep cut to
    ``max_budget=3`` if 22 builds would overrun the phase); wall time,
    trials, total epochs, best score and config, failed trials, graph
    captures and replays, and the full / milo wall-time ratio (reported,
    not asserted); then a sweep ended by ``should_stop`` after its first
    bracket and resumed from its checkpoint gives the uninterrupted run's
    trial stream and best config.
16. the hierarchical path on phase 5's data (k = 5,000): (a) the dense route,
    ``MiloSession(use_pallas=True, partition="balanced_blocks",
    partition_block=2048, refine_factor=2)`` after ``warmup`` (30 blocks,
    bank widths ~333 run at 512, each of the 8 slots' unions of 10,000 rows
    refined to k: B1 for every block's and every union's Gram); (b) phase
    7's gram-free lazy path over ``random_blocks`` of 4096 with rf 2 (13
    blocks: B2 and B3 in every block's WRE pass); (c) ``hierarchical_select``
    (facility location, gram-free, ``use_pallas=True``: B2 every level-0 step,
    B3 in the lazy refine), block 0's level 0 and the refine on both routes
    (index-exact up to a near-tie), and the registry's ``milo_hier`` (the
    plain route); (d) ``milo_targeted`` with 64 queries from class 0, k 500.
    Stage times (Gram, SGE, WRE, refine), time per lazy step, B1-B3
    launches (per instance), peak memory, train time and accuracy; every
    artifact checked, reloaded, and refused by a session with another
    ``refine_factor``; B1 at the union's shape and B2, B3 at block 0's and
    the union's against their plain versions.
17. the encoder step and the paper's baselines on phase 5's data (k = 5,000):
    (a) ``ProxyEncoder(d_hidden=128, epochs=60)`` fit on the training rows,
    ``preprocess_with_encoder(encoder_id="proxy", use_pallas=True)`` over its
    features (B1), the artifact reloaded by a session expecting "proxy" and
    refused by one expecting "vit", ``milo`` trained on the raw rows; (b)
    ViT-B/16 at published widths (random weights, fp32) over 5,000
    class-structured 32×32 images upsampled ×7 to 224 (a cut: not 50,000),
    its encode time, images/s and TFLOP/s, one batch bit-equal twice, four
    images against the CPU; (c) the text encoder at all-distilroberta-v1's
    widths over 2,000 masked sequences of 32–128 tokens, the masked tail
    unmoved; (d) the Fig. 6 rows ``full``, ``el2n``, ``selfsup_prune``,
    ``craig_pb``, ``gradmatch_pb`` and ``glister`` through
    ``MiloSession.train`` (12 epochs, R 10; the bench's last-layer proxy
    gradients of a probe MLP; EL2N from a probe trained 2 epochs), each
    row's train and selection time, accuracy, speedup and accuracy loss
    against ``full`` and peak memory; CRAIG's greedy launches B4 once a step
    over the (50,000, 50,000) gradient Gram (its route against the plain
    one on the first 8,192 rows first; R cut to 12 if its first selection
    passes 20 s), and B4 is timed at that shape beside its bound.
    Phases 14 and 17 read ``memory_allocated`` (garbage collected, cuBLAS's
    per-stream workspaces dropped) before each session, after its work and
    after ``del``: the last must come back within 8 MiB of the first, and
    the largest tensors still alive are named when it does not.
18. LM training with checkpoints, restart and the divergence guard (no
    kernel of the table lies on this path: training runs chunked attention,
    which the reference's Pallas kernel cannot replace under autograd —
    asserted by the flash and SSD launch counts staying 0): (a)
    ``launch/train.py``'s flow on internlm2-1.8b at full width and depth
    (24 layers, d_model 2048, 16/8 heads, vocab 92,544; bf16, chunked
    attention, remat): MILO over 512 documents, k = 128, batch 16 × 64
    tokens, 4 epochs (32 steps), adamw with cosine lr from 1e-3, ``--ckpt``
    (steps 20 and 32); median step, steps/s and tokens/s over the steps'
    device time, loss first → last (must decrease), peak memory, the
    checkpoint's bytes and its save split into host snapshot, write+fsync
    and sha256, validate+restore (bit-equal); then the chunked route (4 KV
    blocks of 16) against naive attention on one batch, loss and every
    gradient leaf within ``ROUTE_TOL``; (b) ``examples/train_lm_milo.py``'s
    kill-and-resume on granite-moe-1b-a400m at full width and depth (24
    layers, 32 experts top-8): 24 steps with checkpoints at 16 and 24, step
    24's shard corrupted by one byte, ``latest_valid_step`` skipping it, a
    fresh ``Trainer`` resuming at 16 and replaying to 24 — parameters, both
    Adam moments and the replayed history bit-equal to the uninterrupted
    run's; (c) the guard on the fused path at phase 14's geometry (CUDA
    graphs): ``skip_step`` on healthy data bit-equal to unguarded with as
    many synchronising calls (``torch.cuda.set_sync_debug_mode``), a NaN
    plan weight skipped with the counter advanced (unguarded, the
    parameters go non-finite), ``rollback`` replaying to ``skip_step``'s
    state.  Checkpoints go under the git-ignored ``build/phase18/`` and are
    removed at the end of each sub-phase.
19. selection as a service: (a) ``MiloServer(use_pallas=True,
    fused_training=True, firewall="quarantine", num_workers=2)`` over a store
    under the git-ignored ``build/phase19/`` on phase 5's training rows with
    32 of them poisoned (8 NaN, 8 inf, 16 zero, fixed indices): ``warm`` with
    phase 15's search space (the one artifact build, B1), 3 ``MiloClient``
    tenants tuning at once (max_budget 9, seeds 100-102), every row from
    memory, then a repeat request with no new graph capture, no kernel
    library build or load, no B1 launch and no new buffer placement; the
    quarantined rows equal the planted ones and none is selected; tenant 0
    bit-equal to a cold ``MiloSession`` (preprocess and tune), tenants 1-2 to
    a serial replay on one worker (the artifact from disk), memory released
    after ``shutdown``; (b) at ``examples/serve_selection.py``'s size, a
    transient build failure retried once, a deterministic one opening the
    breaker (the cached key still serves, ``health()`` degraded, then ok
    after the cooldown's probe), a kernel wrapper's refusal neither retried
    nor degraded around, a stale heartbeat degrading ``health()``; (c) a
    degenerate ``milo`` falling back to ``adaptive_random`` with the hop in
    the plan's provenance, and B1's refusal in a primary propagating; (d)
    landmark facility location per class (k 500, L 2,000) and, on class 0,
    at least 0.9 of exact greedy facility location's value on its Gram.
20. the last LM families, random weights from seed 0 at published widths in
    bf16: (a) xlstm-125m at full width and depth (10 mLSTM of 8 heads of
    192, 2 sLSTM, d_model 768) through ``ServeEngine(max_batch=4,
    max_len=2304)`` with phase 12's traffic: prefill per request, median
    decode step, tokens/s, wall, peak; no B5 or B6 launch (asserted);
    request 0's decode against the full forward, reported in bf16 and held
    in f32 on the same weights (1e-3); each mixer's time at its prefill;
    (b) whisper-small at full width and depth (12 encoder layers, 24
    decoder blocks, 12 heads of 64, ``attention_impl="pallas"``), 4
    requests of ``default_rng(0).integers(32, 449, 4)`` prompt tokens, each
    at batch 1 through ``lm.prefill`` and 31 ``lm.decode_step``s with its
    (1, 1500, 768) bf16 frames (the encoder re-run every step, as in the
    reference); (c) one period of llama-3.2-vision's pattern (4 attn + 1
    xattn, d_model 8192, 64/8 heads, d_ff 28,672, vocab 128,256; 5.33 B
    parameters; a cut: depth 100 -> 5), the first 4 of phase 12's prompts
    against a (1, 1601, 8192) bf16 context.  In (b) and (c): B5 launches per
    shape and instance, prefill and decode apart (counts asserted), 0 copies,
    prefill per request, median decode step, peak; request 0's prefill
    logits on the kernel route against naive attention and its decode
    logits against the full forward (0.02 relative); the encoder's output
    (b) and the cross-attention sublayer (c), kernel route against plain.
21. multi-device selection and multi-host execution on phase 7's data
    (d = 768, class buckets of 8,192): (a) the sharded engines on one rank
    whose collectives are NCCL calls on the card (graph cut and
    disparity-min greedy, the SGE bank, lazy facility location and the
    lazy two-level importance on class 0), each bit-equal to the
    single-device port; (b) two ranks on the one card, started by the
    port's ``launch_hosts`` (gloo: NCCL refuses two ranks on one GPU, and
    asking for it raises; every CUDA tensor a collective moves is staged
    through host memory, counted), each running
    ``MiloSession(shard_selection=True, multihost_init=True)``'s
    preprocess over phase 7's first two classes (a cut: a staged gloo
    step is ~8 ms) with B2 and B3 on its own 4,096 rows: the ranks'
    artifacts bit-equal, the SGE bank phase 7's, each WRE trajectory phase
    7's up to a near-tie, stage times, µs a lazy step, B2
    and B3 launches per rank and instance, ring hops, staged calls and
    bytes, peak memory per rank; ``milo_fixed(shard_selection=True)`` the
    single-device indices; (c) class 0's facility location with int8
    payloads (2 rounds) against the exact sum, then one byte of rank 1's
    payload flipped after its checksum: both ranks raise
    ``CompressionIntegrityError``; (d) two hosts train phase 14's
    classifier (adaptive_random, k 5,000, batch 32, the step loop) with
    heartbeats and two-phase checkpoints every 64 steps; ``KillHost``
    SIGKILLs rank 1 at step 200, the survivor exits with
    ``HostLossError``, the newest valid checkpoint has 2 shards, and the
    restarted pair's parameters are bit-equal to an uninterrupted pair's
    and to one process's.  Scratch files under the git-ignored
    ``build/phase21/``, removed at the end.
22. the LM sharding rules on DTensor: (a) phase 12's yi-6b at full width on
    a (1, 1) ``data x model`` mesh of one NCCL rank, its weights and caches
    as DTensors over the same tensors: ``lm.prefill`` of phase 12's first
    prompt (1,781 tokens) and 8 ``lm.decode_step``s under the ambient mesh,
    logits bit-equal to the plain tensors' (asserted), B5's 32 prefill
    launches on the local-shard route (asserted), prefill ms and the median
    decode ms beside the plain run's (DTensor's dispatch cost, reported);
    (b) one Jamba block (a Mamba mixer and a MoE FFN of all 16 experts) at
    published widths over 2,048 tokens on the same mesh, B6 on the
    local-shard route (8 launches), output and state bit-equal; (c) B5 on
    each rank's query heads of yi-6b's (1, 32/4, 2048, 128) for a model axis
    of 8 (the 4 key/value heads replicated) and of 2 (split), with the
    key/value heads ``ops.local_kv_heads`` gives it, bit-equal to the full
    kernel's rows; (d) the dry run (``launch/dryrun.py``) of yi-6b
    ``train_4k`` and ``decode_32k`` and Jamba ``prefill_32k`` on both
    production meshes (32x8, 2x32x8), each cell a child process on the
    card's host with the card hidden, six at a time, started before 22a
    and run beside 22a-c: every cell ``ok`` (asserted), per-device FLOPs,
    bytes, collective bytes by axis, argument bytes, the H100 spec sheet's
    bound and roofline fraction, seconds.  Records under the git-ignored
    ``build/phase22/``, removed at the end.
23. the port's six examples (``examples/torch/*.py``) in this process
    through their ``main(argv)`` on the card, each with its own asserts
    (every request answered, the artifact reused, targeted coverage above
    untargeted, the loss falling, the resume exact): (a) all six at their
    own sizes, the reference examples' (``serve_lm``, ``serve_selection``,
    ``quickstart``, ``tune_hparams``, ``targeted_selection``,
    ``train_lm_milo``), on the plain routes their defaults take; (b)
    ``quickstart``, ``tune_hparams`` and ``train_lm_milo`` again with
    ``--use-pallas`` (the dense Gram through B1; ``quickstart``'s launches
    asserted).  Wall time, exit status and each kernel's launches per run.
    Paths under the git-ignored ``build/phase23/``, removed at the end.

Then the ``-Xptxas -v`` registers, spills and dynamic shared memory of the
redesigned kernels, one ``{"kernels": [...]}`` line (launches: each kernel's path —
phase 5 for the similarity kernel, 7 for the gram-free kernels, 9 for the
dense ``fl_gains`` kernel, 12 and 20 for flash attention, 13 for the SSD chunk; B1-B3
also carry their phase 16 launches and errors, B4 its phase 17 launches and
its time, bound and error at CRAIG's shape, B1 its phase 19 launches, B5
its phase 20 launches by shape and its times at phase 20's shapes, B2 and
B3 their phase 21 launches per rank, B5 and B6 their phase 22 launches,
every kernel its phase 23 launches per example run),
the card's name and power limit, and, last,
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import hashlib
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
TOL = {torch.float32: dict(rtol=1e-4, atol=2e-4),   # the reference's kernel tolerances
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}  # (tests/test_kernels.py)


def log(*args) -> None:
    print(*args, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


_SPIN: dict[str, float] = {}


def _spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    if "per_ms" not in _SPIN:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _SPIN["per_ms"] = 10_000_000 / start.elapsed_time(end)
    return _SPIN["per_ms"]


def queued_ms(fn, iters: int = 20, warmup: int = 3, flush: torch.Tensor | None = None) -> float:
    """Mean time of one call of ``fn`` on the card alone: the calls are
    issued behind a spin kernel that outlasts their issue, so they run back
    to back on the card, each between its own pair of events.  ``cuda_ms``
    times calls as they are issued, so a kernel shorter than its wrapper's
    Python is timed there at the host's rate; this one is not.  With
    ``flush`` (a buffer larger than the 50 MB L2) the buffer is written
    before each call: the cold time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin = 2 * iters * issue_ms + 2.0
    for _ in range(4):
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        torch.cuda._sleep(int(_spin_cycles_per_ms() * spin))
        for start, end in pairs:
            if flush is not None:
                flush.zero_()
            start.record()
            fn()
            end.record()
        covered = not torch.cuda.current_stream().query()  # the spin still runs
        torch.cuda.synchronize()
        if covered:
            return sum(start.elapsed_time(end) for start, end in pairs) / iters
        spin *= 4
    raise RuntimeError("the spin kernel ended before the timed calls were issued")


def sm_clock_mhz(fn, seconds: float = 1.0) -> tuple[float, float]:
    """Mean SM clock (MHz; ``nvidia-smi`` samples it every 50 ms) while
    ``fn`` runs back to back for about ``seconds``, and the card's maximum."""
    query = ["nvidia-smi", "-i", "0", "--format=csv,noheader,nounits"]
    top = float(subprocess.run(query + ["--query-gpu=clocks.max.sm"], capture_output=True,
                               text=True, timeout=60, check=True).stdout)
    proc = subprocess.Popen(query + ["--query-gpu=clocks.sm", "-lms", "50"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        proc.stdout.readline()  # the first sample: the sampler runs
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=60)
    mhz = [float(v) for v in out.split()]
    return (sum(mhz) / len(mhz) if mhz else float("nan")), top


def rows(gen: torch.Generator, m: int, d: int, dev, dtype, normalized: bool) -> torch.Tensor:
    z = torch.randn((m, d), generator=gen, device=dev)
    if normalized:
        z = z / z.norm(dim=1, keepdim=True)
    return z.to(dtype)


def similarity_bound_ms(mq: int, mk: int, d: int, dtype: torch.dtype) -> tuple[float, str]:
    """Least time for the Gram tile: operations at the peak for the input
    type, or bytes (inputs read once, fp32 output written once)."""
    flops = 2.0 * mq * mk * d
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    nbytes = (mq + mk) * d * torch.tensor([], dtype=dtype).element_size() + mq * mk * 4
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fl_bound_ms(kernel: str, n: int, m: int, d: int = 0) -> tuple[float, str]:
    """Least time for an fl_gains call over n ground rows and m candidates:
    operations at the fp32 peak (the fused product's 2·d per pair, plus the
    epilogue's subtract, max and add — six for the delta's two relu terms),
    or bytes (fp32 inputs read once, the (m,) output written once)."""
    if kernel == "fl_gains":                 # materialised K (n, m)
        flops, nbytes = 3.0 * n * m, 4.0 * (n * m + n + m)
    elif kernel == "fl_gains_gram_free":     # z (n, d), zc (m, d), c (n,)
        flops, nbytes = (2.0 * d + 4) * n * m, 4.0 * ((n + m) * d + n + m)
    else:                                    # delta: z (b, d), zc (m, d), two covers
        flops, nbytes = (2.0 * d + 6) * n * m, 4.0 * ((n + m) * d + 2 * n + m)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fl_tol(n_rows: int) -> dict:
    """Kernel against plain version: sums of up to ``n_rows`` fp32 terms ≤ 1
    in two orders (the kernel's chunked fp32 sum, the plain version's float64
    running sum), each term's similarity from another product order:
    rtol 1e-4 plus 2^-20 per summed row."""
    return dict(rtol=1e-4, atol=max(1e-5, n_rows * 2.0**-20))


def fl_inputs(gen: torch.Generator, n: int, m: int, d: int, dev, *, n_real: int | None = None):
    """Unit rows z (n, d) — rows past ``n_real`` all zero at cover +inf, the
    bucketed padding — candidates zc (m, d), covers c and c_new >= c."""
    z = rows(gen, n, d, dev, torch.float32, True)
    zc = rows(gen, m, d, dev, torch.float32, True)
    c = torch.rand((n,), generator=gen, device=dev)
    c[torch.rand((n,), generator=gen, device=dev) < 0.1] = float("inf")
    if n_real is not None:
        z[n_real:] = 0.0
        c[n_real:] = float("inf")
    c_new = torch.maximum(c, torch.rand((n,), generator=gen, device=dev))
    return z, zc, c, c_new


def phase_device(rehearsal: bool) -> dict:
    log("== phase 1: device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}  "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    if rehearsal:
        log("device: cpu (rehearsal)")
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log(f"device: {kind}  count: {count}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip())
    return {"platform": "gpu", "kind": kind, "count": count, "smi": smi.stdout.strip()}


def phase_build() -> str:
    """Phase 2; returns the compiler's ``-Xptxas -v`` report."""
    from repro_torch.kernels import _build

    log("== phase 2: build")
    t0 = time.perf_counter()
    lib, report = _build.build()
    log(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    log(report)
    return report


def ptxas_stats(report: str, entry: str) -> dict:
    """Registers and spilled bytes of the kernel whose mangled name holds
    ``entry``, from the ``-Xptxas -v`` report."""
    m = re.search(re.escape(entry) + r".*?(\d+) bytes spill stores, (\d+) bytes spill loads"
                  r".*?Used (\d+) registers", report, re.S)
    if m is None:
        raise RuntimeError(f"no -Xptxas -v entry for {entry} in the build report")
    return {"registers": int(m.group(3)), "spill_store_bytes": int(m.group(1)),
            "spill_load_bytes": int(m.group(2))}


def ptxas_instances(report: str, instances: dict[str, str]) -> dict[str, dict]:
    """``ptxas_stats`` of each template instance, by label: ``instances``
    maps a label to a substring of the instance's mangled name."""
    return {label: ptxas_stats(report, entry) for label, entry in instances.items()}


# the mangled names of the redesigned kernels' instances
SIMILARITY_INSTANCES = {
    "f32 normalized": "similarity_kernelIfLb1EE", "f32": "similarity_kernelIfLb0EE",
    "bf16 normalized": "similarity_kernelI13__nv_bfloat16Lb1EE",
    "bf16": "similarity_kernelI13__nv_bfloat16Lb0EE"}
SMALL_B_INSTANCES = {f"b<={bp}": f"delta_small_b_kernelILi{bp}EE" for bp in (1, 2, 4, 8, 16, 32, 64)}


def phase_kernel_checks(dev) -> float:
    from repro_torch.kernels.fl_gains import fl_gains as fk
    from repro_torch.kernels.similarity.ref import similarity_ref
    from repro_torch.kernels.similarity.similarity import similarity_cuda

    log("== phase 3: kernel against plain version")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    zero = torch.zeros((1,), device=dev)
    for mq, mk, d in ((2048, 5000, 768), (904, 5000, 768)):
        for dtype in (torch.float32, torch.bfloat16):
            for normalized in (True, False):
                zq = rows(gen, mq, d, dev, dtype, normalized)
                zk = rows(gen, mk, d, dev, dtype, normalized)
                out = similarity_cuda(zq, zk, normalized=normalized)
                ref = similarity_ref(zq, zk, normalized=normalized)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                ok = torch.allclose(out, ref, **TOL[dtype])
                log(f"similarity ({mq}, {mk}, {d}) {str(dtype)[6:]} normalized={normalized}: "
                    f"max_abs_err={err:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"similarity kernel disagrees with its plain version "
                                         f"at ({mq}, {mk}, {d}) {dtype} normalized={normalized}")
                worst = max(worst, err)
                if dtype == torch.float32 and normalized:
                    # B1 and B2 build each similarity as one fmaf chain in k
                    # order: with one ground row at cover 0 the gram-free
                    # kernel (its ring instance) returns that row's tile
                    # values themselves
                    picked = sorted({0, 1, mq // 2, mq - 1})
                    tiles = torch.stack([gram_free(fk, zq[i:i + 1], zk, zero, "ring")
                                         for i in picked])
                    _bit_equal(f"similarity ({mq}, {mk}, {d}) f32 normalized: rows {picked} "
                               "against the gram-free kernel's tile values", out[picked], tiles)
    return worst


def phase_kernel_timing(dev, smi: str) -> dict:
    from repro_torch.kernels.similarity.ref import similarity_ref
    from repro_torch.kernels.similarity.similarity import similarity_cuda

    log("== phase 4: kernel timing (CUDA events, mean of 20 after 3 warm-up)")
    gen = torch.Generator(device=dev).manual_seed(1)
    mq, mk, d = 2048, 5000, 768
    main = None
    for dtype in (torch.float32, torch.bfloat16):
        for normalized in (True, False):
            zq = rows(gen, mq, d, dev, dtype, normalized)
            zk = rows(gen, mk, d, dev, dtype, normalized)
            ms = cuda_ms(lambda: similarity_cuda(zq, zk, normalized=normalized))
            plain_ms = cuda_ms(lambda: similarity_ref(zq, zk, normalized=normalized))
            bound_ms, bound_by = similarity_bound_ms(mq, mk, d, dtype)
            log(f"similarity ({mq}, {mk}, {d}) {str(dtype)[6:]} normalized={normalized}: "
                f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound_ms:.4f} ms "
                f"({bound_by})  [{smi}]")
            if dtype == torch.float32 and normalized:
                # the main path's call: fp32 rows, normalized; the library
                # yardstick is one fp32 GEMM call (TF32 off) with the same
                # epilogue, 0.5 + 0.5 * zq @ zk^T
                half = torch.full((), 0.5, device=dev)
                library_ms = cuda_ms(lambda: torch.addmm(half, zq, zk.T, alpha=0.5))
                log(f"  library torch.addmm(0.5, zq, zk.T, alpha=0.5): {library_ms:.4f} ms")
                main = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms)
    return main


def _check(name: str, out: torch.Tensor, ref: torch.Tensor, tol: dict) -> float:
    if out.is_cuda:
        torch.cuda.synchronize()
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    ok = torch.allclose(out, ref, **tol) and not torch.isnan(out).any()
    log(f"{name}: max_abs_err={err:.3e} (rtol {tol['rtol']}, atol {tol['atol']:.2e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version")
    return err


def _bit_equal(name: str, a: torch.Tensor, b: torch.Tensor) -> None:
    same = torch.equal(a, b)
    log(f"{name}: {'bit-equal' if same else 'DIFFER'}")
    if not same:
        raise AssertionError(f"{name}: not bit-equal (max diff {float((a - b).abs().max()):.3e})")


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """An equal copy of ``t`` whose base is 4 bytes off 16-byte alignment:
    the fl_gains kernels' C entry points then launch their tiled instance."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def gram_free(fk, z, zc, c, instance: str) -> torch.Tensor:
    """B2's gains, asserting that its C entry point launched ``instance``."""
    before = dict(fk.gram_free_launches)
    out = fk.fl_gains_gram_free_cuda(z, zc, c)
    ran = [k for k in before if fk.gram_free_launches[k] > before[k]]
    if ran != [instance]:
        raise AssertionError(f"fl_gains_gram_free launched {ran}, expected {instance}")
    return out


def gram_free_both(fk, name: str, z, zc, c) -> torch.Tensor:
    """B2 on its ring instance, held bit-equal to its tiled instance (a
    misaligned copy of z); returns the ring instance's gains."""
    out = gram_free(fk, z, zc, c, "ring")
    _bit_equal(f"{name}: ring against tiled instance", out,
               gram_free(fk, misaligned(z), zc, c, "tiled"))
    return out


def phase_fl_kernel_checks(dev) -> dict[str, float]:
    """The fl_gains family against its plain versions (max abs error per
    kernel) at the gram-free path's shapes and at ragged ones, and the
    bit-identity properties the lazy engine and ``gains_at`` rely on."""
    from repro_torch.kernels.fl_gains import fl_gains as fk
    from repro_torch.kernels.fl_gains import ref as fr

    log("== phase 3b: fl_gains kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(2)
    worst = dict.fromkeys(fk.launches, 0.0)
    for n, m, d, n_real in ((8192, 8192, 768, 5000), (5000, 5000, 100, None), (8192, 300, 100, 5000)):
        z, zc, c, c_new = fl_inputs(gen, n, m, d, dev, n_real=n_real)
        tag = f"({n}, {m}, {d}{', ' + str(n_real) + ' real rows' if n_real else ''})"
        out = gram_free_both(fk, f"fl_gains_gram_free {tag}", z, zc, c)
        err = _check(f"fl_gains_gram_free {tag}", out, fr.fl_gains_gram_free_ref(z, zc, c), fl_tol(n))
        worst["fl_gains_gram_free"] = max(worst["fl_gains_gram_free"], err)
        for b in (1, 8, 64, 1024):
            rsel = torch.randperm(n_real or n, generator=gen, device=dev)[:b]
            args = (z[rsel].contiguous(), zc, c[rsel].contiguous(), c_new[rsel].contiguous())
            out = fk.fl_gains_gram_free_delta_cuda(*args)
            err = _check(f"fl_gains_gram_free_delta b={b} {tag}", out,
                         fr.fl_gains_gram_free_delta_ref(*args), fl_tol(b))
            worst["fl_gains_gram_free_delta"] = max(worst["fl_gains_gram_free_delta"], err)
        K = fr._sim(z, zc)
        out = fk.fl_gains_cuda(K, c)
        err = _check(f"fl_gains {tag}", out,
                     fr.fl_gains_ref(K, c), fl_tol(n))
        worst["fl_gains"] = max(worst["fl_gains"], err)
        del K

    log("-- bit-identity properties")
    z, _, c, c_new = fl_inputs(gen, 8192, 1, 768, dev, n_real=5000)
    full = gram_free_both(fk, "fl_gains_gram_free (8192, 8192, 768)", z, z, c)
    _bit_equal("fl_gains_gram_free: two launches", full, gram_free(fk, z, z, c, "ring"))
    cand = torch.randint(0, 8192, (640,), generator=gen, device=dev)
    _bit_equal("fl_gains_gram_free: gains_at (640 candidates) == gathered gains",
               gram_free_both(fk, "fl_gains_gram_free gains_at", z, z[cand].contiguous(), c),
               full[cand])
    covers = torch.stack([c, c_new])
    both = gram_free_both(fk, "fl_gains_gram_free batch of 2 covers", z,
                          z[torch.stack([cand, cand.flip(0)])].contiguous(), covers)
    _bit_equal("fl_gains_gram_free: batch of 2 covers == one call per run",
               both[1], gram_free(fk, z, z[cand.flip(0)].contiguous(), c_new, "ring"))
    shared = gram_free_both(fk, "fl_gains_gram_free batch of 2 covers, shared zc", z,
                            z[cand].contiguous(), covers)
    _bit_equal("fl_gains_gram_free: batch of 2 covers, shared zc == one call per run",
               shared[0], full[cand])
    for b in (1, 8, 64, 1024):
        rsel = torch.randperm(5000, generator=gen, device=dev)[:b]
        args = (z[rsel].contiguous(), z, c[rsel].contiguous(), c_new[rsel].contiguous())
        d_full = fk.fl_gains_gram_free_delta_cuda(*args)
        _bit_equal(f"fl_gains_gram_free_delta b={b}: two launches", d_full,
                   fk.fl_gains_gram_free_delta_cuda(*args))
        _bit_equal(f"fl_gains_gram_free_delta b={b}: candidate slice [1000, 4321) == full call",
                   fk.fl_gains_gram_free_delta_cuda(args[0], z[1000:4321], *args[2:]),
                   d_full[1000:4321])
        pad = 1024 - b
        if pad:
            inf = torch.full((pad,), float("inf"), device=dev)
            _bit_equal(f"fl_gains_gram_free_delta b={b}: padded to 1024 with +inf rows == b rows",
                       fk.fl_gains_gram_free_delta_cuda(
                           torch.cat([args[0], z[:pad]]), z, torch.cat([args[2], inf]),
                           torch.cat([args[3], inf])), d_full)
    # the update column (``gram_free._sim_col``, a cuBLAS product) against
    # the similarities the fused kernels build in their tiles: with one
    # ground row at cover 0 the gram-free kernel returns that row's tile
    # values themselves (one term per sum, added to exact zeros)
    from repro_torch.core.gram_free import _sim_col

    zero = torch.zeros((1,), device=dev)
    n_diff = worst_ulps = 0
    for i in (0, 1, 777, 4999):
        tile = gram_free(fk, z[i:i + 1].contiguous(), z[:5000], zero, "ring")
        col = _sim_col(z[:5000], torch.tensor([i], device=dev))[0]
        n_diff += int((tile != col).sum())
        ulp = torch.from_numpy(np.spacing(col.abs().cpu().numpy())).to(dev)
        worst_ulps = max(worst_ulps, float(((tile - col).abs() / ulp).max()))
    log(f"update column (_sim_col, cuBLAS) against the kernels' tile values, 4 x 5000: "
        f"{n_diff} differ, by at most {worst_ulps:.0f} ulp")
    # the same column from a two-row product (a matrix product in cuBLAS,
    # where a one-row product takes its matrix-vector path)
    two = torch.tensor([777, 777], device=dev)
    col2 = (0.5 + 0.5 * (z[two] @ z[:5000].T))[0]
    tile = gram_free(fk, z[777:778].contiguous(), z[:5000], zero, "ring")
    log(f"  the same column from a two-row product: {int((tile != col2).sum())} of 5000 differ")
    K = fr._sim(z, z)
    dense = fk.fl_gains_cuda(K, c)
    _bit_equal("fl_gains: two launches", dense, fk.fl_gains_cuda(K, c))
    _bit_equal("fl_gains: gains_at (640 columns) == gathered gains",
               fk.fl_gains_cuda(K[:, cand].contiguous(), c), dense[cand])
    return worst


def phase_fl_kernel_timing(dev, smi: str) -> dict[str, dict]:
    """Each fl_gains kernel at the gram-free path's shapes: kernel, plain
    version, bound, and for the fused kernels the fp32 cuBLAS product of the
    same shape as a product-only yardstick (no one PyTorch call computes
    these functions, so ``library_ms`` stays null)."""
    from repro_torch.kernels.fl_gains import fl_gains as fk
    from repro_torch.kernels.fl_gains import ref as fr

    log("== phase 4b: fl_gains kernel timing (CUDA events, mean of 20 after 3 warm-up)")
    gen = torch.Generator(device=dev).manual_seed(3)
    n, d = 8192, 768
    z, _, c, c_new = fl_inputs(gen, n, 1, d, dev, n_real=5000)
    out: dict[str, dict] = {}

    def report(kernel: str, label: str, ms: float, plain_ms: float, bound: tuple, product_ms=None):
        extra = "" if product_ms is None else f"  fp32 product alone (torch.mm) {product_ms:.4f} ms"
        log(f"{kernel} {label}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound[0]:.4f} ms "
            f"({bound[1]}){extra}  [{smi}]")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                    library_ms=None, product_ms=product_ms)

    # B2 at the path's shape (5,000 live rows of the 8,192-row bucket, the
    # rest zero at cover +inf) and with every row live, on both instances
    # (the tiled one through a misaligned z) and on both measures.  bound_ms
    # counts all n rows, as in every PR; live_bound_ms only the rows with a
    # finite cover (the least work the call needs), which the ring
    # instance's skip of all-+inf tiles approaches
    live_gen = torch.Generator(device=dev).manual_seed(4)
    z_live = rows(live_gen, n, d, dev, torch.float32, True)
    c_live = torch.rand((n,), generator=live_gen, device=dev)
    # and at (4096, 4096, 768), every row live: a rank's block in phase
    # 21b (two ranks over the 8,192-row bucket) and 16c's level-0 shape
    z_rank, c_rank = z_live[:4096].contiguous(), c_live[:4096].contiguous()
    for key, zz, cc in (("path", z, c), ("all_live", z_live, c_live),
                        ("rank_4096", z_rank, c_rank)):
        nn = zz.shape[0]
        z_off = misaligned(zz)
        gram_free(fk, zz, zz, cc, "ring")
        gram_free(fk, z_off, zz, cc, "tiled")
        ring = dict(ms=cuda_ms(lambda: fk.fl_gains_gram_free_cuda(zz, zz, cc)),
                    alone_ms=queued_ms(lambda: fk.fl_gains_gram_free_cuda(zz, zz, cc)))
        tiled = dict(ms=cuda_ms(lambda: fk.fl_gains_gram_free_cuda(z_off, zz, cc)),
                     alone_ms=queued_ms(lambda: fk.fl_gains_gram_free_cuda(z_off, zz, cc)))
        plain = cuda_ms(lambda: fr.fl_gains_gram_free_ref(zz, zz, cc), iters=5)
        prod = cuda_ms(lambda: torch.mm(zz, zz.T))
        n_live = int(torch.isfinite(cc).sum())
        live_bound = fl_bound_ms("fl_gains_gram_free", n_live, nn, d)[0]
        row = report("fl_gains_gram_free", f"({nn}, {nn}, {d}), {key} [ring]", ring["ms"], plain,
                     fl_bound_ms("fl_gains_gram_free", nn, nn, d), prod)
        row.update(ring=ring, tiled=tiled, live_rows=n_live, live_bound_ms=live_bound)
        log(f"  on the card alone {ring['alone_ms']:.4f} ms; tiled instance (the kernel the ring "
            f"one replaced) {tiled['ms']:.4f} ms, on the card alone {tiled['alone_ms']:.4f} ms; "
            f"ring {tiled['ms'] / ring['ms']:.2f}x / {tiled['alone_ms'] / ring['alone_ms']:.2f}x "
            f"faster")
        if key == "all_live":
            # the fp32 peak holds at the card's top clock; read the clock the
            # ring instance runs at (132 SMs x 128 FMA lanes x 2 per cycle)
            mhz, top = sm_clock_mhz(lambda: fk.fl_gains_gram_free_cuda(zz, zz, cc))
            at_clock = 2.0 * (n * n * d) / (132 * 128 * 2 * mhz * 1e6) * 1e3
            ring.update(sm_clock_mhz=mhz, max_sm_clock_mhz=top, product_bound_at_clock_ms=at_clock)
            log(f"  SM clock while the ring instance runs {mhz:.0f} MHz (max {top:.0f}): the "
                f"product alone at that clock's fp32 peak takes {at_clock:.4f} ms, "
                f"{at_clock / ring['ms']:.1%} of the ring instance's time")
        share = live_bound / min(ring["ms"], ring["alone_ms"])
        log(f"  bound over the {n_live} rows with a finite cover (the least work this call "
            f"needs): {live_bound:.4f} ms; the ring instance's best time reaches {share:.1%} of it")
        if share > 1.0:
            raise AssertionError(f"the ring instance beats the least work of its call ({share:.1%})")
        out[f"fl_gains_gram_free_{key}"] = row
    out["fl_gains_gram_free"] = out["fl_gains_gram_free_path"]
    # the delta, timed as every kernel is (``cuda_ms``: issued back to back
    # from Python) and on the card alone (``queued_ms``): warm (zc in L2, as
    # in the lazy loop) and cold (a 64 MB write before each call evicts zc
    # from the 50 MB L2: the bound counts zc's bytes from memory).  At
    # b <= 64 also the tiled instance, the kernel the small-b one replaced,
    # reached by a z that is not 16-byte aligned, on both measures
    flush = torch.empty(64 * 2**20 // 4, device=dev)

    def instance(*args) -> str:
        before = dict(fk.delta_launches)
        fk.fl_gains_gram_free_delta_cuda(*args)
        return next(k for k in before if fk.delta_launches[k] > before[k])

    for b in (1, 8, 64, 1024):
        rsel = torch.randperm(5000, generator=gen, device=dev)[:b]
        args = (z[rsel].contiguous(), z, c[rsel].contiguous(), c_new[rsel].contiguous())
        ms = cuda_ms(lambda: fk.fl_gains_gram_free_delta_cuda(*args))
        alone = queued_ms(lambda: fk.fl_gains_gram_free_delta_cuda(*args))
        cold = queued_ms(lambda: fk.fl_gains_gram_free_delta_cuda(*args), flush=flush)
        plain = cuda_ms(lambda: fr.fl_gains_gram_free_delta_ref(*args), iters=5)
        prod = cuda_ms(lambda: torch.mm(args[0], z.T))
        bound = fl_bound_ms("fl_gains_gram_free_delta", b, n, d)
        inst = instance(*args)
        row = report("fl_gains_gram_free_delta", f"b={b} ({b}, {n}, {d}) [{inst}]", ms, plain,
                     bound, prod)
        row.update(instance=inst, alone_ms=alone, cold_ms=cold)
        log(f"  on the card alone: warm {alone:.4f} ms ({bound[0] / alone:.1%} of the bound; zc "
            f"is 25 MB and stays in the 50 MB L2, so a warm time may beat the bound of its bytes "
            f"from memory), cold (L2 flushed) {cold:.4f} ms ({bound[0] / cold:.1%})")
        if inst == "small_b":
            targs = (misaligned(args[0]),) + args[1:]
            assert instance(*targs) == "tiled"
            _bit_equal(f"delta b={b}: small-b against tiled instance",
                       fk.fl_gains_gram_free_delta_cuda(*args),
                       fk.fl_gains_gram_free_delta_cuda(*targs))
            tiled = dict(ms=cuda_ms(lambda: fk.fl_gains_gram_free_delta_cuda(*targs)),
                         alone_ms=queued_ms(lambda: fk.fl_gains_gram_free_delta_cuda(*targs)))
            row["tiled"] = tiled
            log(f"  tiled instance (the kernel the small-b one replaced): {tiled['ms']:.4f} ms, "
                f"on the card alone {tiled['alone_ms']:.4f} ms; small-b "
                f"{tiled['ms'] / ms:.2f}x / {tiled['alone_ms'] / alone:.2f}x faster")
        out[f"fl_gains_gram_free_delta_b{b}"] = row
    out["fl_gains_gram_free_delta"] = out["fl_gains_gram_free_delta_b8"]
    K = fr._sim(z, z)
    ms = cuda_ms(lambda: fk.fl_gains_cuda(K, c))
    plain = cuda_ms(lambda: fr.fl_gains_ref(K, c), iters=5)
    out["fl_gains"] = report("fl_gains", f"({n}, {n})", ms, plain, fl_bound_ms("fl_gains", n, n))
    return out


def _timed(fn, times: dict, key: str, dev):
    """Wrap a preprocessing stage so its wall time (synchronised) adds up."""
    def wrapper(*args, **kwargs):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times[key] = times.get(key, 0.0) + time.perf_counter() - t0
        return out
    return wrapper


def phase_main_path(dev, *, n: int, n_classes: int, dim: int, epochs: int) -> dict:
    from repro_torch.core import milo as milo_mod
    from repro_torch.core.metadata import MiloMetadata
    from repro_torch.data.datasets import GaussianMixtureDataset
    from repro_torch.kernels.similarity import ops as sim_ops
    from repro_torch.kernels.similarity import similarity as sim_kernel
    from repro_torch.selection import MiloSession

    log("== phase 5: main path (MiloSession, use_pallas=True)")
    t0 = time.perf_counter()
    ds = GaussianMixtureDataset(n=n, n_classes=n_classes, dim=dim, seed=0)
    tr, _, te = ds.split(val_frac=0.0, test_frac=1 / 6)
    x, y, tx, ty = ds.x[tr], ds.y[tr], ds.x[te], ds.y[te]
    sizes = np.bincount(y)
    log(f"data: train {x.shape}, test {tx.shape}, class sizes {sizes.tolist()} "
        f"(set-up {time.perf_counter() - t0:.1f} s)")

    # lr 0.01: this mixture's rows have norm ~158, and at the default 0.05
    # the MLP diverges in both packages (the JAX reference too: loss -> inf,
    # test accuracy at chance); 0.01 trains both to ~0.998 on the CPU
    session = MiloSession(use_pallas=True, total_epochs=epochs, lr=0.01, device=dev)
    block = session.config.gram_block
    expected = int(sum(math.ceil(int(s) / block) for s in sizes))
    # time the preprocessing stages by wrapping the functions core.milo calls
    times: dict[str, float] = {}
    stages = {"gram": "gram_matrix_blocked", "sge": "run_sge", "wre": "greedy_importance"}
    originals = {attr: getattr(milo_mod, attr) for attr in stages.values()}
    for key, attr in stages.items():
        setattr(milo_mod, attr, _timed(originals[attr], times, key, dev))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    sim_kernel.launches = 0
    sim_ops.copies = 0
    try:
        t0 = time.perf_counter()
        md = session.preprocess(x, y)
        t_pre = time.perf_counter() - t0
    finally:
        for attr, fn in originals.items():
            setattr(milo_mod, attr, fn)
    t0 = time.perf_counter()
    report = session.train(x, y, test_x=tx, test_y=ty)
    t_train = time.perf_counter() - t0
    launches = sim_kernel.launches
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None

    log(f"preprocess {t_pre:.3f} s: gram {times['gram']:.3f} s, sge bank {times['sge']:.3f} s, "
        f"wre importance {times['wre']:.3f} s")
    log(f"train {t_train:.3f} s ({report.train_time:.3f} s timed loop, {report.steps} steps), "
        f"final test accuracy {report.final_acc:.4f}")
    log(f"similarity launches on the main path: {launches} "
        f"(expected sum_c ceil(n_c/{block}) = {expected}); copies for the kernel's "
        f"asynchronous copies {sim_ops.copies}")
    log(f"max_memory_allocated: {peak if peak is None else f'{peak / 2**20:.1f} MiB'}")

    k = md.k
    assert md.sge_subsets.shape == (session.config.n_sge_subsets, k), md.sge_subsets.shape
    assert all(len(np.unique(s)) == k and s.min() >= 0 and s.max() < len(x)
               for s in md.sge_subsets), "bank slots are subsets of the training set"
    assert np.isfinite(md.wre_importance).all() and np.isfinite(md.wre_probs).all()
    assert (md.wre_probs >= 0).all() and abs(float(md.wre_probs.sum()) - 1.0) < 1e-4
    assert report.final_acc >= 0.5, f"test accuracy {report.final_acc} is near chance"
    assert sim_ops.copies == 0, "the main path hands the similarity kernel rows it takes in place"
    if dev.type == "cuda":
        assert launches == expected, f"{launches} similarity launches, expected {expected}"
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "milo.npz")
        md.save(path)
        back = MiloMetadata.load(path, expected_hash=md.config_hash())
        assert back.config_hash() == md.config_hash()
        np.testing.assert_array_equal(back.sge_subsets, md.sge_subsets)
    log(f"artifact round trip: config_hash {md.config_hash()} reloads equal")
    return dict(x=x, y=y, tx=tx, ty=ty, launches=launches, session=session)


def phase_routes(dev, x: np.ndarray, y: np.ndarray, session) -> None:
    from repro_torch.core import greedy, submodular
    from repro_torch.core.milo import _next_pow2
    from repro_torch.core.similarity import gram_matrix_blocked
    from repro_torch.kernels.similarity import ops as sim_ops

    log("== phase 6: kernel route against plain route on class 0")
    cfg = session.config
    feats = x[y == 0]
    n_c = len(feats)
    k_c = max(1, int(round(cfg.subset_fraction * n_c)))
    n_pad = _next_pow2(n_c)
    k_run = min(n_pad, _next_pow2(k_c))
    z = torch.as_tensor(feats, device=dev)
    copies = sim_ops.copies
    A_k = gram_matrix_blocked(z, block=cfg.gram_block, use_pallas=True, n_pad=n_pad)
    A_p = gram_matrix_blocked(z, block=cfg.gram_block, use_pallas=False, n_pad=n_pad)
    err = float((A_k - A_p).abs().max())
    log(f"gram ({n_c} rows, padded to {n_pad}): max_abs_err {err:.3e}, "
        f"{sim_ops.copies - copies} copies")
    assert sim_ops.copies == copies, "the Gram's tiles need no copy"
    assert torch.allclose(A_k, A_p, **TOL[torch.float32]), "Gram routes disagree"

    valid = torch.arange(n_pad, device=dev) < n_c
    imp_k = greedy.greedy_importance(submodular.disparity_min, A_k, valid=valid).cpu().numpy()
    imp_p = greedy.greedy_importance(submodular.disparity_min, A_p, valid=valid).cpu().numpy()
    diff = np.abs(imp_k - imp_p)
    sorted_diff = np.abs(np.sort(imp_k) - np.sort(imp_p)).max()
    log(f"wre importance: max_abs_diff {diff.max():.3e} ({int((diff > 1e-6).sum())} elements "
        f"> 1e-6), sorted max_abs_diff {sorted_diff:.3e}, range [{imp_p.min():.4f}, {imp_p.max():.4f}]")
    # two Grams a few ulps apart may swap two near-tied picks late in the
    # farthest-point traversal, where gains are ~1e-4: elements may exchange
    # such gains, the sorted gain sequence stays the same
    np.testing.assert_allclose(imp_k, imp_p, rtol=1e-4, atol=5e-4)
    np.testing.assert_allclose(np.sort(imp_k), np.sort(imp_p), rtol=1e-5, atol=1e-5)

    gc = submodular.make_graph_cut(cfg.graph_cut_lambda)
    banks = [greedy.sge(gc, A, k_run, n_subsets=cfg.n_sge_subsets, eps=cfg.eps, valid=valid,
                        generator=torch.Generator(device=dev).manual_seed(0)).cpu().numpy()[:, :k_c]
             for A in (A_k, A_p)]
    worst = 0.0
    for slot in range(cfg.n_sge_subsets):
        vals = []
        for bank in banks:
            mask = torch.zeros(n_pad, dtype=torch.bool, device=dev)
            mask[torch.as_tensor(bank[slot], device=dev)] = True
            vals.append(float(gc.evaluate(mask, A_p)))
        rel = abs(vals[0] - vals[1]) / abs(vals[1])
        worst = max(worst, rel)
        assert rel <= 1e-4, f"slot {slot}: graph-cut objective {vals[0]} vs {vals[1]}"
    same = int((banks[0] == banks[1]).all(axis=1).sum())
    log(f"sge bank: {same}/{cfg.n_sge_subsets} slots index-equal, graph-cut objective "
        f"max rel diff {worst:.3e}")


GRAM_FREE_PATH = dict(gram_free=True, use_pallas=True, hard_fn="facility_location",
                      lazy_gains=True, lazy_two_level=True)


def phase_gram_free_path(dev, x, y, tx, ty, *, epochs: int) -> dict:
    """Phase 7: the gram-free, lazy facility-location path through
    ``MiloSession`` on the same data as phase 5."""
    from repro_torch.core import greedy as greedy_mod
    from repro_torch.core import milo as milo_mod
    from repro_torch.core.metadata import MiloMetadata
    from repro_torch.kernels.fl_gains import fl_gains as fk
    from repro_torch.kernels.similarity import similarity as sim_kernel
    from repro_torch.selection import MiloSession

    log("== phase 7: gram-free path (MiloSession, gram_free, lazy facility-location WRE)")
    session = MiloSession(total_epochs=epochs, lr=0.01, device=dev, **GRAM_FREE_PATH)
    times: dict[str, float] = {}
    runs: list = []
    lazy_orig = greedy_mod.lazy_greedy

    def lazy_recorded(*args, **kwargs):
        before = dict(fk.launches)
        res = lazy_orig(*args, **kwargs)
        runs.append((res, args[1].shape[0], {k: fk.launches[k] - before[k] for k in before}))
        return res

    stages = {"sge": "run_sge", "wre": "greedy_importance"}
    originals = {attr: getattr(milo_mod, attr) for attr in stages.values()}
    for key, attr in stages.items():
        setattr(milo_mod, attr, _timed(originals[attr], times, key, dev))
    greedy_mod.lazy_greedy = lazy_recorded
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    for k in fk.launches:
        fk.launches[k] = 0
    for counts in (fk.gram_free_launches, fk.delta_launches):
        for k in counts:
            counts[k] = 0
    sim_kernel.launches = 0
    try:
        t0 = time.perf_counter()
        md = session.preprocess(x, y)
        t_pre = time.perf_counter() - t0
    finally:
        for attr, fn in originals.items():
            setattr(milo_mod, attr, fn)
        greedy_mod.lazy_greedy = lazy_orig
    launches = dict(fk.launches)
    instances = dict(fk.delta_launches)
    b2_instances = dict(fk.gram_free_launches)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    t0 = time.perf_counter()
    report = session.train(x, y, test_x=tx, test_y=ty)
    t_train = time.perf_counter() - t0

    n_classes = len(np.unique(y))
    steps = [int((r.rows_evaluated > 0).sum()) for r, _, _ in runs]
    full = [int((r.rows_evaluated == n).sum()) for r, n, _ in runs]
    lazy_rows = torch.cat([r.rows_evaluated[(r.rows_evaluated > 0) & (r.rows_evaluated < n)]
                           for r, n, _ in runs]).float()
    log(f"preprocess {t_pre:.3f} s: sge bank {times['sge']:.3f} s, wre importance "
        f"{times['wre']:.3f} s ({sum(steps)} greedy steps, "
        f"{times['wre'] / max(sum(steps), 1) * 1e6:.1f} us per step)")
    log(f"train {t_train:.3f} s ({report.train_time:.3f} s timed loop, {report.steps} steps), "
        f"final test accuracy {report.final_acc:.4f}")
    log(f"launches: fl_gains_gram_free {launches['fl_gains_gram_free']}, "
        f"fl_gains_gram_free_delta {launches['fl_gains_gram_free_delta']}, "
        f"fl_gains {launches['fl_gains']}, similarity {sim_kernel.launches}")
    log(f"full recomputes (rows_evaluated == n): {sum(full)} of {sum(steps)} steps, per class {full}")
    log(f"rows gathered per lazy step: mean {float(lazy_rows.mean()) if len(lazy_rows) else 0:.2f}, "
        f"max {int(lazy_rows.max()) if len(lazy_rows) else 0}, {len(lazy_rows)} lazy steps")
    log(f"max_memory_allocated (preprocess): "
        f"{peak if peak is None else f'{peak / 2**20:.1f} MiB'}")
    # a lazy step's rows_evaluated is its gathered block's size: the delta's b
    sizes, counts = torch.unique(lazy_rows.long(), return_counts=True)
    gathers = dict(zip(sizes.tolist(), counts.tolist()))
    log(f"fl_gains_gram_free_delta gather sizes b (b: calls): {gathers}")
    log(f"fl_gains_gram_free_delta launches per instance: {instances}")
    log(f"fl_gains_gram_free launches per instance: {b2_instances}")
    # the artifact's bits, to compare two builds of the port run for run
    for name in ("wre_importance", "sge_subsets"):
        arr = np.ascontiguousarray(getattr(md, name))
        log(f"sha256 of {name} ({arr.dtype}, {arr.shape}): "
            f"{hashlib.sha256(arr.tobytes()).hexdigest()}")

    k = md.k
    assert len(runs) == n_classes, f"{len(runs)} lazy passes for {n_classes} classes"
    assert md.sge_subsets.shape == (session.config.n_sge_subsets, k)
    assert all(len(np.unique(s)) == k for s in md.sge_subsets)
    assert np.isfinite(md.wre_importance).all() and (md.wre_importance > 0).all()
    assert abs(float(md.wre_probs.sum()) - 1.0) < 1e-4
    assert report.final_acc >= 0.5, f"test accuracy {report.final_acc} is near chance"
    assert sim_kernel.launches == 0, "the gram-free path builds no Gram"
    if dev.type == "cuda":
        # B2 runs at every lazy pass's init (and full recomputes), B3 on its lazy steps
        assert launches["fl_gains_gram_free"] >= n_classes + sum(full), launches
        assert launches["fl_gains_gram_free_delta"] >= n_classes, launches
        assert launches["fl_gains_gram_free_delta"] == len(lazy_rows), launches
        assert sum(instances.values()) == launches["fl_gains_gram_free_delta"], instances
        assert instances["small_b"] > instances["tiled"] > 0, "both instances run, small-b most"
        assert b2_instances == {"ring": launches["fl_gains_gram_free"], "tiled": 0}, b2_instances
        per_class = [(d["fl_gains_gram_free"], d["fl_gains_gram_free_delta"]) for _, _, d in runs]
        log(f"(fl_gains_gram_free, fl_gains_gram_free_delta) launches per class: {per_class}")
        assert all(b2 >= 1 and b3 >= 1 for b2, b3 in per_class), per_class
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "milo_gram_free.npz")
        md.save(path)
        back = MiloMetadata.load(path, expected_hash=md.config_hash())
        np.testing.assert_array_equal(back.wre_importance, md.wre_importance)
        reuse = MiloSession(total_epochs=epochs, lr=0.01, device=dev, metadata_path=path,
                            **GRAM_FREE_PATH)
        assert reuse.preprocess(x, y).config_hash() == md.config_hash() and reuse.loaded_from_artifact
    log(f"artifact round trip: config_hash {md.config_hash()} reloads equal and is reused")
    return dict(launches=launches, session=session, md=md, instances=instances, gathers=gathers,
                b2_instances=b2_instances, preprocess_s=t_pre, stage_s=dict(times),
                peak_mib=None if peak is None else round(peak / 2**20, 1),
                trajectories=[(r.indices.cpu().numpy(), r.gains.cpu().numpy())
                              for r, _, _ in runs])


def _class0(x, y, session, dev):
    from repro_torch.core.milo import _next_pow2

    feats = x[y == 0]
    n_c = len(feats)
    n_pad = _next_pow2(n_c)
    k_c = max(1, int(round(session.config.subset_fraction * n_c)))
    return feats, n_c, n_pad, k_c, torch.arange(n_pad, device=dev) < n_c


def phase_gram_free_routes(dev, x, y, session) -> None:
    """Phase 8: class 0 of the gram-free path — kernel against plain route,
    two-level against single-level gathers, verify_argmax against greedy."""
    import dataclasses

    from repro_torch.core import greedy
    from repro_torch.core.milo import MiloPreprocessor

    log("== phase 8: gram-free routes on class 0")
    cfg = session.config
    feats, n_c, n_pad, k_c, valid = _class0(x, y, session, dev)
    pre = cfg.preprocessor(dev)

    def run(p: MiloPreprocessor):
        t0 = time.perf_counter()
        easy, hard = p._set_fn(p.easy_fn), p._set_fn(p.hard_fn)
        subs, imp = p._class_selection(feats, k_c, bucket=True, easy=easy, hard=hard,
                                       generator=torch.Generator(device=dev).manual_seed(0))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return subs, imp, time.perf_counter() - t0

    subs_k, imp_k, t_k = run(pre)
    plain = dataclasses.replace(pre, use_pallas=False, device=dev)
    subs_p, imp_p, t_p = run(plain)
    np.testing.assert_array_equal(subs_k, subs_p)
    diff = np.abs(imp_k - imp_p)
    sorted_diff = float(np.abs(np.sort(imp_k) - np.sort(imp_p)).max())
    log(f"kernel route {t_k:.3f} s, plain route {t_p:.3f} s: sge bank identical; wre importance "
        f"max_abs_diff {diff.max():.3e} ({int((diff > 1e-6).sum())} elements > 1e-6, "
        f"{int((diff > 5e-4 + 1e-4 * np.abs(imp_p)).sum())} beyond rtol 1e-4 + atol 5e-4), "
        f"sorted max_abs_diff {sorted_diff:.3e}, range [{imp_p.min():.4g}, {imp_p.max():.4g}]")
    np.testing.assert_allclose(np.sort(imp_k), np.sort(imp_p), rtol=1e-5, atol=1e-5)

    # element by element: the two routes round their sums differently (the
    # kernel's chunked fp32 sums, the plain version's float64 running sums),
    # so a near-tied pair may be picked in the other order, and then the
    # later of the pair gains less.  The trajectories must agree until the
    # first parting, where the two picks' gains must be a near-tie; the
    # importance of everything picked before it must agree
    hard = pre._set_fn(pre.hard_fn)
    z = torch.zeros((n_pad, x.shape[1]), device=dev)
    z[:n_c] = torch.as_tensor(feats, device=dev)
    z[:n_c] /= z[:n_c].norm(dim=1, keepdim=True).clamp_min(1e-8)
    budget = pre._lazy_budget(n_pad, hard)
    tr_k = greedy.lazy_greedy(hard, z, n_pad, budget=budget, valid=valid, two_level=True)
    tr_p = greedy.lazy_greedy(plain._set_fn(plain.hard_fn), z, n_pad, budget=budget, valid=valid,
                              two_level=True)
    parted = torch.nonzero(tr_k.indices[:n_c] != tr_p.indices[:n_c])
    t = int(parted[0]) if len(parted) else n_c
    tol = 4 * float(np.spacing(np.float32(float(tr_p.gains[0]))))
    if t < n_c:
        gap = abs(float(tr_k.gains[t]) - float(tr_p.gains[t]))
        log(f"trajectories part at step {t} of {n_c}: kernel picks {int(tr_k.indices[t])} "
            f"(gain {float(tr_k.gains[t])!r}), plain {int(tr_p.indices[t])} "
            f"(gain {float(tr_p.gains[t])!r}): a gap of {gap:.3e} (near-tie bound {tol:.3e}, "
            "4 ulps of the first gain, the cached gains' resolution)")
        assert gap <= tol + 1e-5 * abs(float(tr_p.gains[t])), "the routes part at a clear gap"
    else:
        log(f"trajectories equal over all {n_c} steps")
    before = tr_p.indices[:t].cpu().numpy()
    np.testing.assert_allclose(imp_k[before], imp_p[before], rtol=1e-4, atol=5e-4)
    log(f"importance of the {t} elements picked before the parting: allclose (rtol 1e-4, atol 5e-4)")

    subs_1, imp_1, t_1 = run(dataclasses.replace(pre, lazy_two_level=False, device=dev))
    np.testing.assert_array_equal(subs_1, subs_k)
    np.testing.assert_array_equal(imp_1, imp_k)
    log(f"lazy_two_level False ({t_1:.3f} s) against True: importance bit-identical")

    t0 = time.perf_counter()
    ver = greedy.lazy_greedy(hard, z, k_c, budget=budget, valid=valid,
                             two_level=True, verify_argmax=True)
    eager = greedy.greedy(hard, z, k_c, valid=valid)
    same = torch.equal(ver.indices, eager.indices)
    log(f"verify_argmax lazy against eager greedy ({k_c} picks, {time.perf_counter() - t0:.3f} s): "
        f"indices {'equal' if same else 'DIFFER'}, gains max_abs_diff "
        f"{float((ver.gains - eager.gains).abs().max()):.3e}")
    assert same, "verify_argmax picks differ from eager greedy"


def phase_fl_dense(dev, x, y, session) -> int:
    """Phase 9: ``make_facility_location_pallas`` (the dense fl_gains kernel)
    against the plain facility location, greedy over class 0's Gram built
    by the similarity kernel.  Returns the fl_gains launches of this run."""
    from repro_torch.core import greedy, submodular
    from repro_torch.core.similarity import gram_matrix_blocked
    from repro_torch.kernels.fl_gains import fl_gains as fk

    log("== phase 9: make_facility_location_pallas against facility_location on class 0")
    feats, n_c, n_pad, k_c, valid = _class0(x, y, session, dev)
    A = gram_matrix_blocked(torch.as_tensor(feats, device=dev), block=session.config.gram_block,
                            use_pallas=True, n_pad=n_pad)
    k = min(500, n_c)
    fn_k = submodular.make_facility_location_pallas()
    fk.launches["fl_gains"] = 0
    t0 = time.perf_counter()
    a = greedy.greedy(fn_k, A, k, valid=valid)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_k = time.perf_counter() - t0
    launches = fk.launches["fl_gains"]
    t0 = time.perf_counter()
    b = greedy.greedy(submodular.facility_location, A, k, valid=valid)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_p = time.perf_counter() - t0
    parted = torch.nonzero(a.indices != b.indices)
    log(f"greedy to {k} over the ({n_pad}, {n_pad}) Gram: kernel {t_k:.3f} s ({launches} fl_gains "
        f"launches), plain {t_p:.3f} s; gains max_abs_diff {float((a.gains - b.gains).abs().max()):.3e}")
    if len(parted):
        t = int(parted[0])
        state = fn_k.init(A, 1)
        for j in b.indices[:t]:
            fn_k.update(state, A, j.view(1))
        g = submodular.facility_location.gains(state, A)[0]
        ga, gb = float(g[a.indices[t]]), float(g[b.indices[t]])
        ulps = abs(ga - gb) / float(np.spacing(np.float32(max(ga, gb))))
        log(f"indices part at step {t}: kernel picks {int(a.indices[t])} (plain gain {ga!r}), plain "
            f"picks {int(b.indices[t])} (gain {gb!r}): a gap of {ulps:.1f} fp32 ulps")
        assert ulps <= 4, f"the routes part at step {t} by {ulps:.1f} ulps (> 4)"
    else:
        log("indices equal")
    if dev.type == "cuda":
        assert launches == k, f"{launches} fl_gains launches for {k} greedy steps"
    return launches


# ---------------------------------------------------------------------------
# the LM serving path: flash attention (B5), the SSD chunk (B6), ServeEngine
# ---------------------------------------------------------------------------

def _heads_first(gen, b, s, h, d, dev, dtype) -> torch.Tensor:
    """(B, H, S, D) as the model hands it over: a view of (B, S, H, D)."""
    return torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype).transpose(1, 2)


def flash_flops(hq: int, sq: int, sk: int, d: int, causal: bool) -> float:
    """The two products' operations over the kept (row, key) pairs."""
    off = sk - sq
    pairs = sum(min(sk, i + off + 1) for i in range(sq)) if causal else sq * sk
    return 4.0 * hq * d * pairs


def flash_bound_ms(hq: int, hkv: int, sq: int, sk: int, d: int, causal: bool,
                   dtype: torch.dtype) -> tuple[float, str]:
    """Least time for one attention call: ``flash_flops`` at the peak for
    the input type, or bytes (q, k, v read once, o written once)."""
    flops = flash_flops(hq, sq, sk, d, causal)
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    nbytes = (2 * hq * sq + 2 * hkv * sk) * d * torch.tensor([], dtype=dtype).element_size()
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ssd_bound_ms(L: int, H: int, P: int, N: int) -> tuple[float, str]:
    """Least time for one SSD chunk in f32: c·bᵀ (2L²N), the masked (L, L) by
    (L, P) product of every head (L(L+1)·H·P), c·h_in and bᵀ·x (2·L·N·H·P
    each); bytes: x, a, b, c, h_in read once, y and h_out written once."""
    flops = 2.0 * L * L * N + L * (L + 1) * H * P + 4.0 * L * N * H * P
    nbytes = 4.0 * (2 * L * H * P + L * H + 2 * L * N + 2 * H * N * P)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ssd_split_bound_ms(L: int, H: int, P: int, N: int) -> tuple[float, str]:
    """Least time on the mma instance's own route: its three TF32 products
    for each of ``ssd_bound_ms``'s at the tensor cores' TF32 peak, or the
    same bytes."""
    flops = 3 * (2.0 * L * L * N + L * (L + 1) * H * P + 4.0 * L * N * H * P)
    nbytes = 4.0 * (2 * L * H * P + L * H + 2 * L * N + 2 * H * N * P)
    t_ops, t_bytes = flops / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ssd_inputs(gen, B, S, H, P, N, dev):
    """Decays in [0.6, 1) (as the reference's kernel tests draw them)."""
    x = torch.randn((B, S, H, P), generator=gen, device=dev)
    a = 0.6 + 0.4 * torch.rand((B, S, H), generator=gen, device=dev)
    b = torch.randn((B, S, N), generator=gen, device=dev)
    c = torch.randn((B, S, N), generator=gen, device=dev)
    h = 0.1 * torch.randn((B, H, N, P), generator=gen, device=dev)
    return x, a, b, c, h


SSD_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_ssd_kernel.py

#: B5's shapes on phase 20's path, (label, Hq, Hkv, Sq, Sk, D, causal):
#: whisper-small's 12 heads of 64 (the encoder over 1,500 frames, request
#: 0's 386-token prompt and one decode query against the encoder's output)
#: and llama-3.2-vision's 64/8 heads of 128 (request 0's 1,781-token prompt
#: and one decode query against 1,601 patch tokens, and its self-attention)
B5_PHASE20_SHAPES = [
    ("whisper encoder", 12, 12, 1500, 1500, 64, False),
    ("whisper self, prompt", 12, 12, 386, 386, 64, True),
    ("whisper cross, prompt", 12, 12, 386, 1500, 64, False),
    ("whisper cross, decode", 12, 12, 1, 1500, 64, False),
    ("llama-vision self, prompt", 64, 8, 1781, 1781, 128, True),
    ("llama-vision cross, prompt", 64, 8, 1781, 1601, 128, False),
    ("llama-vision cross, decode", 64, 8, 1, 1601, 128, False),
]


def phase_lm_kernel_checks(dev) -> dict[str, float]:
    """Phase 10: B5 and B6 against their plain versions at the serving
    path's shapes, and repeated launches bit-equal."""
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import gqa_attention_ref
    from repro_torch.kernels.ssd_chunk import ops as ssd_ops
    from repro_torch.kernels.ssd_chunk import ssd_chunk as sc
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref, ssd_scan_ref
    from repro_torch.kernels.ssd_chunk.ssd_chunk import ssd_chunk_cuda

    log("== phase 10: flash attention and the SSD chunk against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(10)
    worst = {"flash_attention": 0.0, "ssd_chunk": 0.0}
    worst_bf16 = 0.0
    cases = [(hq, hkv, s, s, True) for hq, hkv in ((32, 4), (64, 8)) for s in (2048, 1537)]
    cases += [(32, 4, 300, 2048, True), (32, 4, 1537, 1537, False), (32, 4, 1, 2048, True),
              (64, 8, 1, 1537, False)]
    for hq, hkv, sq, sk, causal in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q = _heads_first(gen, 1, sq, hq, 128, dev, dtype)
            k, v = (_heads_first(gen, 1, sk, hkv, 128, dev, dtype) for _ in range(2))
            out = flash_attention_cuda(q, k, v, causal=causal)
            ref = gqa_attention_ref(q, k, v, causal=causal).to(dtype)
            err = _check(f"flash_attention Hq {hq} Hkv {hkv} Sq {sq} Sk {sk} causal={causal} "
                         f"{str(dtype)[6:]}", out.float(), ref.float(), TOL[dtype])
            worst["flash_attention"] = max(worst["flash_attention"], err)
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, err)
    _bit_equal("flash_attention: two launches", out, flash_attention_cuda(q, k, v, causal=causal))
    # phase 20's shapes: head dim 64 (the bf16 kernel's second panel wholly
    # past D), cross length (ragged last key tile), one query, 64/8 GQA
    for label, hq, hkv, sq, sk, d, causal in B5_PHASE20_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q = _heads_first(gen, 1, sq, hq, d, dev, dtype)
            k, v = (_heads_first(gen, 1, sk, hkv, d, dev, dtype) for _ in range(2))
            out = flash_attention_cuda(q, k, v, causal=causal)
            ref = gqa_attention_ref(q, k, v, causal=causal).to(dtype)
            err = _check(f"flash_attention {label}: Hq {hq} Hkv {hkv} Sq {sq} Sk {sk} D {d} "
                         f"causal={causal} {str(dtype)[6:]}", out.float(), ref.float(), TOL[dtype])
            worst["flash_attention"] = max(worst["flash_attention"], err)
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, err)
            _bit_equal(f"flash_attention {label} {str(dtype)[6:]}: two launches", out,
                       flash_attention_cuda(q, k, v, causal=causal))
    phase_flash_mixed_dtypes(dev, gen)
    q = _heads_first(gen, 1, 2048, 32, 128, dev, torch.bfloat16)
    k, v = (_heads_first(gen, 1, 2048, 4, 128, dev, torch.bfloat16) for _ in range(2))
    _bit_equal("flash_attention: two launches (bf16, yi-6b's prefill shape)",
               flash_attention_cuda(q, k, v), flash_attention_cuda(q, k, v))
    log(f"flash_attention bf16 (wgmma kernel): max_abs_err {worst_bf16:.3e} over the cases above; "
        f"the CUDA-core kernel's was 3.906e-03 on an H100 80GB HBM3 at 700 W; bound 1e-2")
    assert worst_bf16 <= 1e-2, worst_bf16

    L, H, P, N = 256, 256, 64, 128      # Jamba's chunk: d_inner 16,384 in 256 heads of 64
    ssd_before = (sc.launches, dict(sc.instance_launches))
    x, a, b, c, h = ssd_inputs(gen, 1, 2 * L, H, P, N, dev)
    one = [t[:, :L] for t in (x, a, b, c)]
    y, h1 = ssd_chunk_cuda(*one, h)
    y_r, h_r = ssd_chunk_ref(*one, h)
    for name, o, r in (("y", y, y_r), ("h_out", h1, h_r)):
        err = _check(f"ssd_chunk (1, {L}, {H}, {P}), N {N}: {name}", o, r, SSD_TOL)
        worst["ssd_chunk"] = max(worst["ssd_chunk"], err)
    y2, h2 = ssd_chunk_cuda(*one, h)
    _bit_equal("ssd_chunk: two launches (y)", y, y2)
    _bit_equal("ssd_chunk: two launches (h_out)", h1, h2)
    # two chunks through the kernel, the state carried by the kernel: against
    # the same two chunks through the plain version, element by element, and
    # against one double-length plain chunk.  The latter forms
    # exp(cum_t - cum_s) from cums near -100 over 512 rows (an f32 ulp there
    # is 7.6e-6), so its own error is ~1e-5 of the summed terms' scale, not
    # of each element: it is held at 1e-4 of max |y| (and of max |h|)
    ya, ha = ssd_chunk_cuda(*one, h)
    yb, hb = ssd_chunk_cuda(*(t[:, L:] for t in (x, a, b, c)), ha)
    ya_r, ha_r = ssd_chunk_ref(*one, h)
    yb_r, hb_r = ssd_chunk_ref(*(t[:, L:] for t in (x, a, b, c)), ha_r)
    _check("ssd_chunk: two chunks, state carried by the kernel, against the plain version's (y)",
           torch.cat([ya, yb], dim=1), torch.cat([ya_r, yb_r], dim=1), SSD_TOL)
    _check("ssd_chunk: two chunks, state carried by the kernel, against the plain version's (h)",
           hb, hb_r, SSD_TOL)
    y_full, h_full = ssd_chunk_ref(x, a, b, c, h)
    for name, o, r in (("y", torch.cat([ya, yb], dim=1), y_full), ("h_out", hb, h_full)):
        rel = _rel(o, r)
        log(f"ssd_chunk: two chunks composed against one plain chunk of {2 * L} ({name}): "
            f"max_abs_err {float((o - r).abs().max()):.3e}, {rel:.2e} of max |{name}| (bound 1e-4)")
        assert rel < 1e-4, (name, rel)
    # a ragged sequence: six whole chunks and one of a single row, masked in the kernel
    xs, as_, bs, cs, _ = ssd_inputs(gen, 1, 1537, H, P, N, dev)
    ys, hs = ssd_ops.ssd_scan(xs, as_, bs, cs, chunk=L)
    ys_r, hs_r = ssd_scan_ref(xs, as_, bs, cs, chunk=L)
    for name, o, r in (("y", ys, ys_r), ("final state", hs, hs_r)):
        err = _check(f"ssd_scan S 1537 (a ragged last chunk): {name}", o, r, SSD_TOL)
        worst["ssd_chunk"] = max(worst["ssd_chunk"], err)
    ran = {k: v - ssd_before[1][k] for k, v in sc.instance_launches.items()}
    log(f"ssd_chunk: {sc.launches - ssd_before[0]} launches at the path's shapes, per instance {ran}; "
        f"max_abs_err {worst['ssd_chunk']:.3e}")
    assert ran == {"mma": sc.launches - ssd_before[0], "simt": 0}, ran
    # the simt instance (every call cp.async cannot address) on the same
    # inputs through a copy of x 4 bytes off 16-byte alignment
    simt_before = sc.instance_launches["simt"]
    worst["ssd_chunk_simt"] = 0.0
    for name, o, r in zip(("y", "h_out"), ssd_chunk_cuda(misaligned(one[0]), *one[1:], h), (y_r, h_r)):
        err = _check(f"ssd_chunk simt instance (1, {L}, {H}, {P}), N {N}: {name}", o, r, SSD_TOL)
        worst["ssd_chunk_simt"] = max(worst["ssd_chunk_simt"], err)
    for name, o, r in zip(("y", "final state"), ssd_ops.ssd_scan(misaligned(xs), as_, bs, cs, chunk=L),
                          (ys_r, hs_r)):
        err = _check(f"ssd_scan S 1537 on the simt instance: {name}", o, r, SSD_TOL)
        worst["ssd_chunk_simt"] = max(worst["ssd_chunk_simt"], err)
    assert sc.instance_launches["simt"] - simt_before == 8, sc.instance_launches
    log(f"ssd_chunk simt instance: max_abs_err {worst['ssd_chunk_simt']:.3e} over the same checks")
    phase_tensor_core_sum(dev)
    return worst


def phase_flash_mixed_dtypes(dev, gen) -> None:
    """``ops.flash_attention`` on a bf16 q against f32 keys and values (an
    f32 context): one counted copy of q to f32, the f32 kernel, the output
    in q's dtype, against the plain version."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import gqa_attention_ref

    q = _heads_first(gen, 1, 1, 64, 128, dev, torch.bfloat16)
    k, v = (_heads_first(gen, 1, 1601, 8, 128, dev, torch.float32) for _ in range(2))
    before, copies = fa.launches, fa_ops.copies
    out = fa_ops.flash_attention(q, k, v, causal=False)
    assert fa.launches == before + 1 and fa_ops.copies == copies + 1, (fa.launches, fa_ops.copies)
    assert out.dtype == torch.bfloat16
    _check("flash_attention mixed dtypes (bf16 q, f32 k and v; the f32 kernel on an f32 copy of "
           "q) (1, 64/8, 1, 1601, 128)", out.float(),
           gqa_attention_ref(q, k, v, causal=False).to(torch.bfloat16).float(),
           TOL[torch.bfloat16])


def phase_tensor_core_sum(dev) -> None:
    """The tensor cores' f32 sum, through the kernel library's one-mma probe,
    against its model ``tf32.mma_sum`` bit for bit, and against the exact
    sum rounded to nearest (which it is not)."""
    from repro_torch.kernels.ssd_chunk import tf32
    from repro_torch.kernels.ssd_chunk.ssd_chunk import mma_probe_cuda

    rng = np.random.default_rng(10)
    T, same, nearest, below, total = 2048, 0, 0, 0, 0
    for scale_c in (1.0, 100.0, 0.0):
        a, b = (tf32.tf32(rng.normal(size=s).astype(np.float32)) for s in ((T, 16, 8), (T, 8, 8)))
        c = (scale_c * rng.normal(size=(T, 16, 8))).astype(np.float32)
        d = mma_probe_cuda(*(torch.from_numpy(u).to(dev) for u in (a, b, c))).cpu().numpy()
        exact = np.einsum("tik,tkj->tij", a.astype(np.float64), b.astype(np.float64)) + c
        same += int((d.view(np.uint32) == tf32.mma_sum(a, b, c).view(np.uint32)).sum())
        nearest += int((d == exact.astype(np.float32)).sum())
        below += int((np.abs(d) < np.abs(exact)).sum())
        total += d.size
    log(f"mma.sync TF32 sums (one k-step plus c, {total} of them): {same} equal the model "
        f"tf32.mma_sum bit for bit (terms cut toward zero to 2^(E - 25), the sum rounded toward zero); "
        f"{nearest} equal the exact sum rounded to nearest, {below} lie below it in magnitude")
    assert same == total, (same, total)


def phase_lm_kernel_timing(dev, smi: str) -> dict[str, dict]:
    """Phase 11: each kernel at the serving path's shapes beside its plain
    version, its bound and (flash attention) one PyTorch call."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import gqa_attention_ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk as sc
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_ref
    from repro_torch.kernels.ssd_chunk.ssd_chunk import ssd_chunk_cuda

    log("== phase 11: flash attention and SSD chunk timing (CUDA events, mean of 20 after 3)")
    gen = torch.Generator(device=dev).manual_seed(11)
    out: dict[str, dict] = {}
    for label, hq, hkv, s in (("yi-6b", 32, 4, 2048), ("yi-6b", 32, 4, 1537),
                              ("jamba", 64, 8, 2048)):
        dtype = torch.bfloat16
        q = _heads_first(gen, 1, s, hq, 128, dev, dtype)
        k, v = (_heads_first(gen, 1, s, hkv, 128, dev, dtype) for _ in range(2))
        ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=True))
        plain = cuda_ms(lambda: gqa_attention_ref(q, k, v, causal=True).to(dtype), iters=5)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                             enable_gqa=True))
        bound = flash_bound_ms(hq, hkv, s, s, 128, True, dtype)
        tflops = flash_flops(hq, s, s, 128, True) / ms / 1e9
        log(f"flash_attention {label} (1, {hq}/{hkv}, {s}, 128) bf16 causal: kernel {ms:.4f} ms  "
            f"({tflops:.1f} TFLOP/s, {bound[0] / ms:.1%} of the bound)  plain {plain:.4f} ms  "
            f"bound {bound[0]:.4f} ms ({bound[1]})  "
            f"library scaled_dot_product_attention {lib:.4f} ms  [{smi}]")
        out[f"flash_attention_{label}_{s}"] = dict(ms=ms, plain_ms=plain, bound_ms=bound[0],
                                                   bound_by=bound[1], library_ms=lib)
    out["flash_attention"] = out["flash_attention_yi-6b_2048"]
    # phase 20's shapes; at D = 64 the kernel's products still run over 128
    # columns (the second panel is TMA's zeros), so twice the bound's work
    phase20 = {}
    for label, hq, hkv, sq, sk, d, causal in B5_PHASE20_SHAPES:
        dtype = torch.bfloat16
        q = _heads_first(gen, 1, sq, hq, d, dev, dtype)
        k, v = (_heads_first(gen, 1, sk, hkv, d, dev, dtype) for _ in range(2))
        ms = cuda_ms(lambda: flash_attention_cuda(q, k, v, causal=causal))
        plain = cuda_ms(lambda: gqa_attention_ref(q, k, v, causal=causal).to(dtype), iters=5)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                             enable_gqa=True))
        bound = flash_bound_ms(hq, hkv, sq, sk, d, causal, dtype)
        tflops = flash_flops(hq, sq, sk, d, causal) / ms / 1e9
        log(f"flash_attention {label} (1, {hq}/{hkv}, {sq}, {sk}, {d}) bf16 "
            f"{'causal' if causal else 'non-causal'}: kernel {ms:.4f} ms  ({tflops:.1f} TFLOP/s, "
            f"{bound[0] / ms:.1%} of the bound)  plain {plain:.4f} ms  bound {bound[0]:.4f} ms "
            f"({bound[1]})  library scaled_dot_product_attention {lib:.4f} ms  [{smi}]")
        phase20[label] = dict(shape=[1, hq, hkv, sq, sk, d], causal=causal, ms=ms, plain_ms=plain,
                              bound_ms=bound[0], bound_by=bound[1], library_ms=lib)
    out["flash_attention_phase20"] = phase20

    L, H, P, N = 256, 256, 64, 128
    x, a, b, c, h = ssd_inputs(gen, 1, L, H, P, N, dev)
    x_off = misaligned(x)
    for args, want in (((x, a, b, c, h), "mma"), ((x_off, a, b, c, h), "simt")):
        before = dict(sc.instance_launches)
        ssd_chunk_cuda(*args)
        assert sc.instance_launches[want] == before[want] + 1, (want, sc.instance_launches)
    ms = cuda_ms(lambda: ssd_chunk_cuda(x, a, b, c, h))
    alone = queued_ms(lambda: ssd_chunk_cuda(x, a, b, c, h))
    simt = dict(ms=cuda_ms(lambda: ssd_chunk_cuda(x_off, a, b, c, h)),
                alone_ms=queued_ms(lambda: ssd_chunk_cuda(x_off, a, b, c, h)))
    plain = cuda_ms(lambda: ssd_chunk_ref(x, a, b, c, h), iters=5)
    bound, split = ssd_bound_ms(L, H, P, N), ssd_split_bound_ms(L, H, P, N)
    log(f"ssd_chunk jamba (1, {L}, {H}, {P}), N {N}: kernel {ms:.4f} ms  plain {plain:.4f} ms  "
        f"bound {bound[0]:.4f} ms ({bound[1]})  library: none (no one PyTorch call)  [{smi}]")
    log(f"  ssd_chunk mma instance on the card alone {alone:.4f} ms; simt instance (the kernel the "
        f"mma one replaced, through a misaligned x) {simt['ms']:.4f} ms, on the card alone "
        f"{simt['alone_ms']:.4f} ms; mma {simt['ms'] / ms:.2f}x / {simt['alone_ms'] / alone:.2f}x "
        f"faster")
    log(f"  ssd_chunk bounds: f32 {bound[0]:.4f} ms ({bound[0] / ms:.1%} of the time as issued, "
        f"{bound[0] / alone:.1%} alone); the split's own route, 3 TF32 products each at "
        f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s, {split[0]:.4f} ms ({split[1]}; {split[0] / ms:.1%} "
        f"as issued, {split[0] / alone:.1%} alone)")
    mhz, top = sm_clock_mhz(lambda: ssd_chunk_cuda(x, a, b, c, h))
    log(f"  ssd_chunk SM clock while the mma instance runs {mhz:.0f} MHz (max {top:.0f})")
    out["ssd_chunk"] = dict(ms=ms, plain_ms=plain, bound_ms=bound[0], bound_by=bound[1],
                            library_ms=None, alone_ms=alone, simt=simt,
                            split_bound_ms=split[0], split_bound_by=split[1],
                            sm_clock_mhz=mhz, max_sm_clock_mhz=top)
    return out


def _reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    from repro_torch.kernels.fl_gains import fl_gains as fk
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.similarity import similarity as sk
    from repro_torch.kernels.ssd_chunk import ssd_chunk as sc

    sk.launches = fa.launches = sc.launches = 0
    for counts in (fk.launches, fk.gram_free_launches, fk.delta_launches, sc.instance_launches):
        for key in counts:
            counts[key] = 0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|: the reference's decode check
    (tests/test_models.py:79), bound 0.02 in bf16."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / (float(b.abs().max()) + 1e-9)


def serve_traffic(vocab: int, *, n: int, lo: int, hi: int) -> list[np.ndarray]:
    """n prompts of lengths drawn from [lo, hi] (``default_rng(0)``), tokens
    uniform over the vocabulary."""
    lengths = np.random.default_rng(0).integers(lo, hi + 1, n)
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, int(p)).astype(np.int64) for p in lengths]


def phase_serve(dev, cfg, label: str, prompts, *, new_tokens: int, max_batch: int,
                max_len: int, seed: int = 0) -> dict:
    """Build ``cfg`` at random weights and serve ``prompts`` through
    ``ServeEngine``: greedy, no EOS.  Prefill and decode steps are timed
    with the card synchronised; the kernels' launches are counted over the
    engine's run alone."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_chunk import ssd_chunk as sc
    from repro_torch import tree as T
    from repro_torch.models import lm
    from repro_torch.serve import lm_engine

    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed=seed, device=dev)
    _sync(dev)
    n_params = sum(p.numel() for p in T.leaves(model))
    log(f"{label}: {n_params / 1e9:.3f} B parameters ({cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_experts} experts, {cfg.dtype}), built in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = lm_engine.ServeEngine(model, cfg, max_batch=max_batch, max_len=max_len)
    times = {"prefill": [], "decode": []}
    originals = {"prefill": lm.prefill, "decode": lm.decode_step}

    def timed(kind):
        def run(*args, **kwargs):
            _sync(dev)
            t = time.perf_counter()
            res = originals[kind](*args, **kwargs)
            _sync(dev)
            times[kind].append(time.perf_counter() - t)
            return res
        return run

    for i, p in enumerate(prompts):
        eng.submit(lm_engine.Request(i, p, max_new_tokens=new_tokens))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    lm.prefill, lm.decode_step = timed("prefill"), timed("decode")
    _reset_launches()
    fa_ops.copies = 0
    try:
        t0 = time.perf_counter()
        done = eng.run()
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        lm.prefill, lm.decode_step = originals["prefill"], originals["decode"]
    launches = {"flash_attention": fa.launches, "ssd_chunk": sc.launches,
                "ssd_chunk_instances": dict(sc.instance_launches)}
    copies = fa_ops.copies
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    decoded = sum(len(r.generated) - 1 for r in done)
    log(f"{label}: served {len(done)} requests (prompts {[len(p) for p in prompts]}, "
        f"{new_tokens} new tokens each) in {wall:.3f} s wall")
    log(f"  prefill per request (s): {[round(t, 4) for t in times['prefill']]}")
    log(f"  decode steps: {len(times['decode'])}, median {np.median(times['decode']) * 1e3:.2f} ms, "
        f"{decoded} tokens decoded in {sum(times['decode']):.3f} s = "
        f"{decoded / sum(times['decode']):.1f} tokens/s")
    log(f"  launches: flash_attention {launches['flash_attention']}, ssd_chunk "
        f"{launches['ssd_chunk']} (per instance {launches['ssd_chunk_instances']}); copies for "
        f"the flash kernel's TMA maps {copies}; "
        f"max_memory_allocated {peak if peak is None else f'{peak / 2**30:.2f} GiB'}")
    assert copies == 0, "the serving path hands the bf16 flash kernel views it takes in place"
    assert sorted(r.rid for r in done) == list(range(len(prompts)))
    assert all(len(r.generated) == new_tokens for r in done), "every request got its tokens"
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.generated)
    return dict(model=model, launches=launches, wall=wall, peak=peak, done=done,
                prefill_s=times["prefill"], decode_s=times["decode"])


def _greedy_run(model, cfg, prompt, steps: int, max_len: int, dev, feed=None):
    """Prefill ``prompt`` then ``steps`` decode steps, feeding the greedy
    tokens (or ``feed``).  Returns the prefill logits, the decode logits and
    the fed tokens."""
    from repro_torch.models import lm

    caches = lm.init_caches(cfg, 1, max_len, dev)
    logits, caches = lm.prefill(model, cfg, torch.as_tensor(prompt[None], device=dev), caches)
    fed = [int(torch.argmax(logits[0, -1]))] if feed is None else list(feed[:1])
    dec = []
    for j in range(steps):
        tok = torch.tensor([[fed[j]]], device=dev)
        out, caches = lm.decode_step(model, cfg, tok, caches, len(prompt) + j)
        dec.append(out[0, -1])
        if feed is None:
            fed.append(int(torch.argmax(out[0, -1])))
        elif j + 1 < steps:
            fed.append(feed[j + 1])
    return logits[0], torch.stack(dec), fed[:steps]


def phase_yi_checks(dev, cfg, model, prompt, *, max_len: int, steps: int = 8) -> None:
    """yi-6b, request 0: decode on the kernel route against the plain
    route's full forward (no cache), and the two routes' prefill logits."""
    import dataclasses

    from repro_torch.models import lm

    plain = dataclasses.replace(cfg, attention_impl="naive")
    pre_k, dec_k, fed = _greedy_run(model, cfg, prompt, steps, max_len, dev)
    seq = torch.as_tensor(np.concatenate([prompt, fed]), device=dev)[None]
    full, _ = lm.forward(model, plain, seq)
    full = full[0]
    P = len(prompt)
    rels = [_rel(dec_k[j], full[P + j]) for j in range(steps)]
    log(f"yi-6b decode (kernel route, {steps} steps after a {P}-token prefill) against the plain "
        f"route's full forward: relative max error per step {[f'{r:.2e}' for r in rels]} "
        "(bound 0.02)")
    assert max(rels) < 0.02, rels
    rel = _rel(pre_k, full[:P])
    log(f"yi-6b prefill logits, kernel route against plain route: relative max error "
        f"{rel:.2e} (bound 0.02, the same bf16 bound)")
    assert rel < 0.02, rel


def phase_jamba_routes(dev, cfg, model, prompt, *, max_len: int, steps: int = 8) -> None:
    """Jamba, request 0: the kernel route (flash attention, the SSD kernel)
    against the plain route (naive attention, the plain chunked scan).

    Layer by layer on the same input — the kernel route's hidden state — the
    two routes' mixer outputs must agree (bf16 bound 0.02, relative to the
    output's scale).  End to end the two routes are also run on the same
    prefill and the same fed decode tokens, and the tokens whose experts
    changed are counted: a router that flips on a last-bit difference sends
    a token to another expert, and with capacity dropping at prefill that
    also moves other tokens' drops, so from the first flip on the two
    routes' logits part by design (in the reference too).  Those logits are
    reported, not held to a bound.
    """
    import dataclasses

    from repro_torch.models import lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.attention import attention
    from repro_torch.models.blocks import apply_block
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.ssm import mamba

    plain = dataclasses.replace(cfg, attention_impl="naive", ssm_impl="chunked")
    tokens = torch.as_tensor(prompt[None], device=dev)
    P = tokens.shape[1]
    positions = torch.arange(P, device=dev)[None]
    rels = []
    with torch.no_grad():
        x = model["embed"][tokens]
        for block, kinds in zip(lm.layer_params(model, cfg), lm.layer_kinds(cfg)):
            h = rms_norm(x, block["norm1"], cfg.norm_eps)
            if kinds[0] == "attn":
                rope = dict(rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
                y_k, _ = attention(block["mixer"], h, positions, impl=cfg.attention_impl, **rope)
                y_p, _ = attention(block["mixer"], h, positions, impl=plain.attention_impl, **rope)
            else:
                y_k, _ = mamba(block["mixer"], h, chunk=cfg.ssm_chunk, impl=cfg.ssm_impl)
                y_p, _ = mamba(block["mixer"], h, chunk=cfg.ssm_chunk, impl=plain.ssm_impl)
            rels.append(_rel(y_k, y_p))
            x, _ = apply_block(block, x, cfg=cfg, kinds=kinds, positions=positions, cache=None,
                               mode="train")
    log(f"jamba request 0 ({P} tokens), layer by layer on the same input: mixer output, kernel "
        f"route against plain route, relative max error {[f'{r:.2e}' for r in rels]} "
        "(bound 0.02)")
    assert max(rels) < 0.02, rels

    routes: list = []
    orig = moe_mod._router

    def recording(params, xr, top_k):
        topv, topi = orig(params, xr, top_k)
        routes.append(topi.reshape(-1, top_k))
        return topv, topi

    moe_mod._router = recording
    try:
        pre_k, dec_k, fed = _greedy_run(model, cfg, prompt, steps, max_len, dev)
        n_k = len(routes)
        pre_p, dec_p, _ = _greedy_run(model, plain, prompt, steps, max_len, dev, feed=fed)
    finally:
        moe_mod._router = orig
    rk, rp = routes[:n_k], routes[n_k:]
    assert len(rk) == len(rp)
    n_moe = sum(1 for _, f in cfg.pattern if f == "moe")
    changed = torch.zeros(P, dtype=torch.bool, device=dev)
    per_layer = []
    for a, b in zip(rk[:n_moe], rp[:n_moe]):  # the prefill's MoE layers
        diff = (a[:P] != b[:P]).any(dim=1)
        per_layer.append(int(diff.sum()))
        changed |= diff
    dec_changed = sum(int((a != b).any()) for a, b in zip(rk[n_moe:], rp[n_moe:]))
    first = int(torch.nonzero(changed)[0]) if bool(changed.any()) else P
    log(f"  end to end ({steps} decode steps fed the same tokens): {int(changed.sum())} of {P} "
        f"prompt tokens changed expert in some MoE layer (per MoE layer {per_layer}; the first "
        f"at position {first}); {dec_changed} of {len(rk) - n_moe} decode-step MoE calls routed "
        "differently")
    log(f"  prefill logits: relative max error {_rel(pre_k, pre_p):.2e} over all positions, "
        f"{_rel(pre_k[:first], pre_p[:first]) if first else 0.0:.2e} before the first change; "
        f"decode logits per step {[f'{_rel(dec_k[j], dec_p[j]):.2e}' for j in range(steps)]} "
        "(reported)")


def phase_lm_serving(dev, *, rehearsal: bool) -> dict:
    """Phases 12-13: yi-6b, then one Jamba period, through ``ServeEngine``.
    The rehearsal runs both at ``registry.smoke`` size on the CPU."""
    import dataclasses
    import gc

    from repro_torch.configs import registry

    yi = dataclasses.replace(registry.get("yi-6b"), attention_impl="pallas")
    # one period of the pattern (1 attention + 7 Mamba layers, 4 MoE), 8 of
    # the 16 experts: 25.3 B parameters, 50.6 GB in bf16 (16 would not fit)
    jamba = dataclasses.replace(registry.get("jamba-1.5-large-398b"), num_layers=8,
                                num_experts=8, attention_impl="pallas", ssm_impl="pallas")
    traffic = dict(n=8, lo=256, hi=2048)
    size = dict(new_tokens=32, max_batch=4, max_len=2304)
    if rehearsal:
        yi = dataclasses.replace(registry.smoke("yi-6b"), attention_impl="pallas")
        jamba = dataclasses.replace(registry.smoke("jamba-1.5-large-398b"),
                                    attention_impl="pallas", ssm_impl="pallas")
        traffic = dict(n=8, lo=8, hi=40)
        size = dict(new_tokens=6, max_batch=4, max_len=64)

    log("== phase 12: yi-6b serving (ServeEngine, attention_impl='pallas')")
    prompts = serve_traffic(yi.vocab_size, **traffic)
    run = phase_serve(dev, yi, yi.name, prompts, **size)
    if dev.type == "cuda":
        assert run["launches"]["flash_attention"] == yi.num_layers * len(prompts), run["launches"]
        assert run["launches"]["ssd_chunk"] == 0
    phase_yi_checks(dev, yi, run["model"], prompts[0], max_len=size["max_len"])
    flash_launches = run["launches"]["flash_attention"]
    del run
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    log("== phase 13: Jamba serving, one period with 8 experts (attention and ssm 'pallas')")
    prompts = serve_traffic(jamba.vocab_size, **traffic)
    run = phase_serve(dev, jamba, jamba.name, prompts, **size)
    n_mamba = sum(1 for m, _ in jamba.pattern if m == "mamba") * jamba.n_groups
    expected = n_mamba * sum(-(-len(p) // jamba.ssm_chunk) for p in prompts)
    log(f"  ssd_chunk launches expected: {n_mamba} Mamba layers x sum ceil(S/{jamba.ssm_chunk}) "
        f"= {expected}; flash_attention expected {len(prompts)}")
    if dev.type == "cuda":
        assert run["launches"]["ssd_chunk"] == expected, run["launches"]
        assert run["launches"]["ssd_chunk_instances"] == {"mma": expected, "simt": 0}, run["launches"]
        assert run["launches"]["flash_attention"] == len(prompts), run["launches"]
    phase_jamba_routes(dev, jamba, run["model"], prompts[0], max_len=size["max_len"])
    ssd_launches = run["launches"]["ssd_chunk"]
    ssd_instances = run["launches"]["ssd_chunk_instances"]
    del run
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"flash_attention": flash_launches, "ssd_chunk": ssd_launches,
            "ssd_chunk_instances": ssd_instances}


def _fits():
    """Wrap ``Trainer.fit`` so each fitted state is kept (``train`` reports
    no parameters); returns (states, restore)."""
    from repro_torch.train import trainer as trainer_mod

    states, orig = [], trainer_mod.Trainer.fit

    def fit(self, state):
        out = orig(self, state)
        states.append(out)
        return out

    trainer_mod.Trainer.fit = fit
    return states, lambda: setattr(trainer_mod.Trainer, "fit", orig)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(torch.int32)


def phase_fused_training(dev, x, y, tx, ty, md, *, epochs: int, batch_size: int = 32,
                         superstep: int = 32) -> dict:
    """Phase 14: ``MiloSession(fused_training=True)`` (one CUDA graph per
    segment shape) against the step loop, on phase 5's artifact, adopted:
    parameters and per-step losses bit-equal."""
    from repro_torch.selection import MiloSession
    from repro_torch.train import engine as engine_mod

    log(f"== phase 14: fused training (CUDA graphs, superstep {superstep}) against the step loop")
    states, restore = _fits()
    runs = {}
    try:
        for fused in (False, True):
            before = _allocated_mib(dev)
            session = MiloSession(use_pallas=True, total_epochs=epochs, lr=0.01,
                                  batch_size=batch_size, superstep=superstep,
                                  fused_training=fused, device=dev)
            session.adopt_metadata(md)
            engine_mod.captures = engine_mod.replays = 0
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            report = session.train(x, y, test_x=tx, test_y=ty)
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
            runs[fused] = dict(report=report, wall=wall, state=states[-1], peak=peak,
                               captures=engine_mod.captures, replays=engine_mod.replays)
            name = "fused" if fused else "loop"
            # C1: the session's engine, graphs, static state and resident
            # buffers die with it; what stays is the fitted state kept above
            # for the bit comparison (the classifier's parameters and momenta)
            after = _allocated_mib(dev)
            del session
            runs[fused]["memory"] = _released(f"phase 14 {name} session", dev, before, after)
            log(f"{name}: train {wall:.3f} s ({report.train_time:.3f} s timed, {report.steps} steps, "
                f"{report.steps / report.train_time:.1f} steps/s), accuracy {report.final_acc:.4f}, "
                f"graph captures {engine_mod.captures} (warm-up included), replays "
                f"{engine_mod.replays}, max_memory_allocated "
                f"{peak if peak is None else f'{peak / 2**20:.1f} MiB'}")
    finally:
        restore()
    loop, fused = runs[False], runs[True]
    k, steps_per_epoch = md.k, md.k // batch_size
    assert loop["report"].steps == fused["report"].steps == steps_per_epoch * epochs
    for key in loop["state"].params:
        assert torch.equal(_bits(loop["state"].params[key]), _bits(fused["state"].params[key])), key
        assert torch.equal(_bits(loop["state"].mom[key]), _bits(fused["state"].mom[key])), key
        assert torch.isfinite(fused["state"].params[key]).all(), key
    strip = [{k_: v for k_, v in h.items() if k_ != "wall"} for h in loop["report"].history]
    assert strip == [{k_: v for k_, v in h.items() if k_ != "wall"}
                     for h in fused["report"].history]
    assert loop["report"].final_acc == fused["report"].final_acc
    segments = -(-steps_per_epoch // superstep)
    shapes = {min(superstep, steps_per_epoch - i) for i in range(0, steps_per_epoch, superstep)}
    log(f"{k} rows in batches of {batch_size}: {steps_per_epoch} steps an epoch, segment shapes "
        f"{sorted(shapes, reverse=True)}; parameters, momenta and {len(strip)} history records "
        "bit-equal to the loop's")
    if dev.type == "cuda":
        assert fused["captures"] == len(shapes), fused["captures"]
        # warm_fused replays epoch 0's walk once before the timed run
        assert fused["replays"] == segments * (epochs + 1), fused["replays"]
        assert loop["captures"] == loop["replays"] == 0
    return {"loop_s": loop["report"].train_time, "fused_s": fused["report"].train_time,
            "steps": fused["report"].steps, "captures": fused["captures"],
            "replays": fused["replays"], "memory": {"loop": loop["memory"],
                                                    "fused": fused["memory"]}}


TUNE_SPACE = {"lr": ("log", 3e-3, 0.3), "hidden": ("choice", [32, 64, 128])}


def phase_tuning(dev, x, y, vx, vy, md, *, mf_limit_s: float = 40.0) -> dict:
    """Phase 15: ``examples/tune_hparams.py``'s flow (TPE over lr and hidden,
    Hyperband max_budget 9, eta 3) on phase 5's artifact, adopted, for the
    full, milo and milo_fixed selectors; then a sweep ended by
    ``should_stop`` after its first bracket and resumed from its checkpoint."""
    from repro_torch.selection import MiloSession, build_selector
    from repro_torch.train import engine as engine_mod

    log("== phase 15: tuning (MiloSession.tune: TPE x Hyperband, fused training)")
    session = MiloSession(use_pallas=True, eval_every_epochs=10, fused_training=True,
                          device=dev)
    session.adopt_metadata(md)
    log(f"train {x.shape}, validation {vx.shape}; space {TUNE_SPACE}; artifact k = {md.k}")
    # milo_fixed rebuilds its subset in every trial (a Gram and k greedy steps
    # over every row): time one build, and cut its sweep to max_budget 3 (6
    # trials) if the example's 22 would overrun its share (40 s) of the ~60 s
    # phases 14-15 may take together
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    sel = build_selector("milo_fixed", features=x, k=md.k, device=dev)
    t_build = time.perf_counter() - t0
    idx = sel.plan(0).indices
    assert len(np.unique(idx)) == md.k and idx.min() >= 0 and idx.max() < len(x)
    del sel
    mf_budget = 9 if 22 * t_build <= mf_limit_s else 3
    log(f"one milo_fixed build ({len(x)} rows, k {md.k}): {t_build:.3f} s; 22 builds would take "
        f"~{22 * t_build:.1f} s against a {mf_limit_s:.0f} s limit: milo_fixed sweeps at "
        f"max_budget {mf_budget}")
    out = {"milo_fixed_build_s": t_build, "milo_fixed_max_budget": mf_budget}
    results = {}
    for name in ("full", "milo", "milo_fixed"):
        budget = mf_budget if name == "milo_fixed" else 9
        engine_mod.captures = engine_mod.replays = 0
        t0 = time.perf_counter()
        res = session.tune(x, y, vx, vy, TUNE_SPACE, selector=name, search="tpe",
                           max_budget=budget, eta=3, seed=0)
        wall = time.perf_counter() - t0
        results[name] = res
        log(f"{name}: wall {wall:.3f} s, max_budget {budget}, {len(res.trials)} trials, "
            f"total_epochs {res.total_epochs}, best_score {res.best_score:.4f}, best_config "
            f"{res.best_config}, failed_trials {res.failed_trials}; graph captures "
            f"{engine_mod.captures}, replays {engine_mod.replays}")
        assert res.failed_trials == 0 and not res.stopped
        assert all(math.isfinite(t["score"]) and 0.0 <= t["score"] <= 1.0 for t in res.trials)
        if dev.type == "cuda":
            widths = {t["config"]["hidden"] for t in res.trials}
            # one segment shape per width (one full-subset batch an epoch)
            assert engine_mod.captures == len(widths), (engine_mod.captures, widths)
        out[name] = {"wall_s": wall, "trials": len(res.trials), "total_epochs": res.total_epochs,
                     "best_score": res.best_score, "best_config": res.best_config,
                     "failed_trials": res.failed_trials}
    ratio = out["full"]["wall_s"] / out["milo"]["wall_s"]
    log(f"full / milo tuning wall time: {ratio:.2f}x (reported, not asserted)")
    out["full_over_milo"] = ratio

    polls = {"n": 0}

    def stop_after_first_bracket() -> bool:
        polls["n"] += 1
        return polls["n"] > 3   # bracket 2 of max_budget 9, eta 3 has three rungs

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "hyperband.json")
        kw = dict(selector="milo", search="tpe", max_budget=9, eta=3, seed=0, checkpoint=ckpt)
        first = session.tune(x, y, vx, vy, TUNE_SPACE, should_stop=stop_after_first_bracket, **kw)
        resumed = session.tune(x, y, vx, vy, TUNE_SPACE, **kw)
    full_run = results["milo"]
    assert first.stopped and len(first.trials) == 13, (first.stopped, len(first.trials))
    assert resumed.trials == full_run.trials, "resumed trial stream differs"
    assert resumed.best_config == full_run.best_config
    log(f"checkpoint resume: stopped after bracket 2 with {len(first.trials)} trials, resumed to "
        f"{len(resumed.trials)}: trial stream and best_config identical to the uninterrupted run")
    return out


# ---------------------------------------------------------------------------
# phase 16: the hierarchical path (block partitions, level-1 refine,
# milo_hier, milo_targeted, warmup) on B1, B2 and B3
# ---------------------------------------------------------------------------

#: phase 16's widths at full size and in the CPU rehearsal
HIER_SIZES = {"full": dict(dense_block=2048, gf_block=4096, k_targeted=500, n_queries=64),
              "rehearsal": dict(dense_block=128, gf_block=256, k_targeted=20, n_queries=8)}


@contextlib.contextmanager
def _stage_times(owner, stages: dict[str, str], dev):
    """Wrap ``owner``'s functions (a module's or a class's) so each stage's
    synchronised wall time adds up in the yielded dict; restored after."""
    times: dict[str, float] = {}
    originals = {attr: getattr(owner, attr) for attr in stages.values()}
    for key, attr in stages.items():
        setattr(owner, attr, _timed(originals[attr], times, key, dev))
    try:
        yield times
    finally:
        for attr, fn in originals.items():
            setattr(owner, attr, fn)


@contextlib.contextmanager
def _lazy_runs():
    """Record every ``lazy_greedy`` result (rows_evaluated, ground rows)."""
    from repro_torch.core import greedy as greedy_mod

    runs: list = []
    orig = greedy_mod.lazy_greedy

    def recorded(*args, **kwargs):
        res = orig(*args, **kwargs)
        runs.append((res, args[1].shape[0]))
        return res

    greedy_mod.lazy_greedy = recorded
    try:
        yield runs
    finally:
        greedy_mod.lazy_greedy = orig


def _reset_peak(dev) -> float | None:
    """Reset the peak counter; returns the MiB earlier phases still hold."""
    if dev.type != "cuda":
        return None
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev) / 2**20


def _peak_mib(dev, held: float | None) -> float | None:
    """Peak allocated MiB since ``_reset_peak``, above what was held then."""
    return None if held is None else torch.cuda.max_memory_allocated(dev) / 2**20 - held


def _peak_text(peak: float | None, held: float | None) -> str:
    if peak is None:
        return "peak memory not measured (cpu)"
    return f"peak memory {peak:.1f} MiB above the {held:.1f} MiB earlier phases hold"


def _selection_launches() -> dict:
    """B1, B2 and B3's launches since the last reset, B2's and B3's per
    instance as their C entry points report them."""
    from repro_torch.kernels.fl_gains import fl_gains as fk
    from repro_torch.kernels.similarity import similarity as sk

    return {"similarity": sk.launches,
            "fl_gains_gram_free": dict(fk.gram_free_launches),
            "fl_gains_gram_free_delta": dict(fk.delta_launches)}


def _lazy_summary(runs, seconds: float) -> dict:
    """Steps of the recorded lazy passes: each pass launches B2 once at its
    init and once per full recompute (rows_evaluated == n), B3 once per
    lazy step (0 < rows_evaluated < n)."""
    rows = [(r.rows_evaluated, n) for r, n in runs]
    steps = sum(int((r > 0).sum()) for r, _ in rows)
    lazy = torch.cat([r[(r > 0) & (r < n)] for r, n in rows]) if rows else torch.zeros(0)
    sizes, counts = torch.unique(lazy.long(), return_counts=True)
    return {"passes": len(runs), "steps": steps,
            "full_recomputes": sum(int((r == n).sum()) for r, n in rows),
            "lazy_steps": len(lazy), "gather_sizes": dict(zip(sizes.tolist(), counts.tolist())),
            "us_per_step": seconds / steps * 1e6 if steps else None}


def _check_artifact(md, m: int, n_subsets: int, stamp: dict) -> None:
    k = md.k
    assert md.sge_subsets.shape == (n_subsets, k), md.sge_subsets.shape
    assert all(len(np.unique(s)) == k and s.min() >= 0 and s.max() < m for s in md.sge_subsets), \
        "every bank slot holds k unique in-range rows"
    assert int(md.class_budgets.sum()) == k, "class_budgets sum to k"
    assert np.isfinite(md.wre_probs).all() and (md.wre_probs >= 0).all()
    total = float(md.wre_probs.astype(np.float64).sum())
    assert abs(total - 1.0) <= 1e-5, f"wre_probs sum to {total!r}"
    for key, want in stamp.items():
        assert md.config.get(key) == want, (key, md.config.get(key), want)


def _reload_and_refuse(md, x, y, session_kw: dict, dev) -> None:
    """A second session reloads the artifact; one whose refine_factor
    disagrees refuses it."""
    from repro_torch.core.metadata import MetadataMismatchError
    from repro_torch.selection import MiloSession

    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "hier.npz")
        md.save(path)
        reuse = MiloSession(metadata_path=path, device=dev, **session_kw)
        assert reuse.preprocess(x, y).config_hash() == md.config_hash() and reuse.loaded_from_artifact
        bad = MiloSession(metadata_path=path, device=dev,
                          **dict(session_kw, refine_factor=session_kw["refine_factor"] + 1))
        try:
            bad.preprocess(x, y)
        except MetadataMismatchError as e:
            log(f"artifact reloads (config_hash {md.config_hash()}); refine_factor "
                f"{session_kw['refine_factor'] + 1} refuses it: {str(e).split(': ', 1)[1]}")
        else:
            raise AssertionError("a session with another refine_factor reused the artifact")


def _hier_session(dev, x, y, tx, ty, session_kw: dict, *, epochs: int, label: str,
                  warm: bool) -> dict:
    """Preprocess (stage times, launches, peak memory) and train one
    hierarchical session; with ``warm``, ``warmup`` runs first."""
    from repro_torch.core import milo as milo_mod
    from repro_torch.core.partition import proportional_budgets
    from repro_torch.kernels.similarity import ops as sim_ops
    from repro_torch.selection import MiloSession

    session = MiloSession(total_epochs=epochs, lr=0.01, device=dev, **session_kw)
    cfg = session.config
    pre = cfg.preprocessor(dev)
    parts = pre.partition_strategy().partition(y, len(x))
    k = max(1, int(round(cfg.subset_fraction * len(x))))
    budgets = proportional_budgets(parts, k)
    rf = cfg.refine_factor
    buckets = [(len(p.indices), b) for p, b in zip(parts, budgets)]
    widths = [min(n, rf * b) for n, b in buckets]
    runs_n = sorted({milo_mod._next_pow2(n) for n, _ in buckets})
    runs_k = sorted({min(milo_mod._next_pow2(n), milo_mod._next_pow2(w))
                     for (n, _), w in zip(buckets, widths)})
    sizes = [n for n, _ in buckets]
    log(f"{label}: {len(parts)} partitions of {min(sizes)}-{max(sizes)} rows (run at {runs_n}), "
        f"bank widths {min(widths)}-{max(widths)} (run at {runs_k}); each of the "
        f"{cfg.n_sge_subsets} bank slots cuts its union of {sum(widths)} rows to k = {k}")
    out = {"partitions": len(parts), "rows": [min(sizes), max(sizes)], "union": sum(widths),
           "k": k, "bank_widths": [min(widths), max(widths)], "run_rows": runs_n,
           "run_widths": runs_k}
    if warm:
        geometries = len({(n, w) for (n, _), w in zip(buckets, widths) if w > 0})
        _sync(dev)
        t0 = time.perf_counter()
        count = pre.warmup(buckets, x.shape[1])
        _sync(dev)
        out["warmup_s"] = time.perf_counter() - t0
        log(f"warmup: {count} partition geometries and the union's in {out['warmup_s']:.3f} s "
            f"(expected {geometries})")
        assert count == geometries, (count, geometries)
    unions: list = []
    orig_refine = milo_mod.MiloPreprocessor._refine_indices

    def refine_recorded(self, feats_u, k_u, easy, *rest):
        if not unions:
            unions.append(np.array(feats_u))
        return orig_refine(self, feats_u, k_u, easy, *rest)

    stages = {"gram": "gram_matrix_blocked", "sge": "run_sge", "wre": "greedy_importance",
              "refine": "run_refine"}
    held = _reset_peak(dev)
    sim_ops_copies = sim_ops.copies
    milo_mod.MiloPreprocessor._refine_indices = refine_recorded
    try:
        with _stage_times(milo_mod, stages, dev) as times, \
                _stage_times(milo_mod.MiloPreprocessor, {"refine_bank": "_refine_bank"}, dev) as bank, \
                _lazy_runs() as runs:
            _reset_launches()
            t0 = time.perf_counter()
            md = session.preprocess(x, y)
            _sync(dev)
            t_pre = time.perf_counter() - t0
            launches = _selection_launches()
    finally:
        milo_mod.MiloPreprocessor._refine_indices = orig_refine
    peak = _peak_mib(dev, held)
    t0 = time.perf_counter()
    report = session.train(x, y, test_x=tx, test_y=ty)
    t_train = time.perf_counter() - t0
    times.update(bank)
    lazy = _lazy_summary(runs, times.get("wre", 0.0))
    log(f"preprocess {t_pre:.3f} s: gram {times.get('gram', 0.0):.3f} s (the partitions' and the "
        f"unions'), sge bank {times['sge']:.3f} s, wre importance {times['wre']:.3f} s, refine "
        f"{times['refine']:.3f} s (the whole level-1 bank, gathers and union Grams included: "
        f"{times['refine_bank']:.3f} s)")
    if runs:
        log(f"lazy wre: {lazy['passes']} passes, {lazy['steps']} steps "
            f"({lazy['us_per_step']:.1f} us per step), {lazy['full_recomputes']} full recomputes; "
            f"B3 gather sizes b (b: calls) {lazy['gather_sizes']}")
    log(f"launches: {launches}; similarity copies {sim_ops.copies - sim_ops_copies}")
    log(f"train {t_train:.3f} s ({report.train_time:.3f} s timed loop, {report.steps} steps), "
        f"final test accuracy {report.final_acc:.4f}; preprocess {_peak_text(peak, held)}")
    stamp = {key: md.config.get(key) for key in ("partition", "partition_block",
                                                 "partition_seed", "refine_factor")}
    want = pre.partition_strategy().config()
    want["refine_factor"] = rf
    _check_artifact(md, len(x), cfg.n_sge_subsets, want)
    assert all(stamp[key] is None for key in set(stamp) - set(want)), stamp
    log(f"partition keys stamped: { {key: v for key, v in stamp.items() if v is not None} }")
    assert report.final_acc >= 0.5, f"test accuracy {report.final_acc} is near chance"
    assert sim_ops.copies == sim_ops_copies, "the path hands the similarity kernel rows in place"
    _reload_and_refuse(md, x, y, dict(session_kw, total_epochs=epochs, lr=0.01), dev)
    out.update(preprocess_s=t_pre, stages=times, lazy=lazy, launches=launches, peak_mib=peak,
               held_mib=held, train_s=t_train, accuracy=report.final_acc,
        union_rows=unions[0] if unions else None, md=md)
    return out


def phase_hier_dense(dev, x, y, tx, ty, *, block: int, epochs: int) -> dict:
    """16a: the dense route (B1 for every block's Gram and every slot's
    union Gram) with balanced blocks and rf 2, warmed first."""
    from repro_torch.core.similarity import gram_matrix_blocked
    from repro_torch.kernels.similarity import similarity as sim_kernel

    log(f"== phase 16a: hierarchical dense route (balanced_blocks {block}, refine_factor 2, B1)")
    kw = dict(use_pallas=True, partition="balanced_blocks", partition_block=block, refine_factor=2)
    out = _hier_session(dev, x, y, tx, ty, kw, epochs=epochs, label="16a", warm=True)
    n_blocks = sum(math.ceil(int(c) / block) for c in np.bincount(y))
    assert out["partitions"] == n_blocks, (out["partitions"], n_blocks)
    gram_block = 2048
    union_tiles = math.ceil(out["union"] / gram_block)
    expected = n_blocks + 8 * union_tiles
    if dev.type == "cuda":
        assert out["launches"]["similarity"] == expected, (out["launches"], expected)
        assert sum(out["launches"]["fl_gains_gram_free"].values()) == 0
    log(f"B1 launches {out['launches']['similarity']} (expected {n_blocks} block Grams + 8 slots x "
        f"{union_tiles} union tiles = {expected})")
    # B1 against its plain version at the union's shape (not a multiple of the tile)
    z_u = torch.as_tensor(out.pop("union_rows"), device=dev)
    before = sim_kernel.launches
    A_k = gram_matrix_blocked(z_u, block=gram_block, use_pallas=True)
    if dev.type == "cuda":
        assert sim_kernel.launches == before + union_tiles
    A_p = gram_matrix_blocked(z_u, block=gram_block, use_pallas=False)
    out["max_abs_err"] = _check(f"similarity at the union Gram ({len(z_u)}, {len(z_u)}, "
                                f"{z_u.shape[1]}) in tiles of {gram_block}", A_k, A_p,
                                TOL[torch.float32])
    del z_u, A_k, A_p
    return out


def phase_hier_gram_free(dev, x, y, tx, ty, *, block: int, epochs: int) -> dict:
    """16b: phase 7's gram-free lazy facility-location path over random
    blocks with rf 2 (B2, B3 in every block's lazy WRE pass)."""
    log(f"== phase 16b: hierarchical gram-free lazy route (random_blocks {block}, refine_factor 2, "
        "B2 and B3)")
    kw = dict(GRAM_FREE_PATH, partition="random_blocks", partition_block=block, refine_factor=2)
    out = _hier_session(dev, x, y, tx, ty, kw, epochs=epochs, label="16b", warm=False)
    n_blocks = math.ceil(len(x) / block)
    assert out["partitions"] == n_blocks and out["lazy"]["passes"] == n_blocks, out["lazy"]
    lo, hi = len(x) // n_blocks, -(-len(x) // n_blocks)
    assert out["rows"] == [lo, hi], out["rows"]
    out.pop("union_rows")
    if dev.type == "cuda":
        b2, b3 = out["launches"]["fl_gains_gram_free"], out["launches"]["fl_gains_gram_free_delta"]
        assert out["launches"]["similarity"] == 0, "the gram-free path builds no Gram"
        lazy = out["lazy"]
        assert b2 == {"ring": n_blocks + lazy["full_recomputes"], "tiled": 0}, (b2, lazy)
        assert sum(b3.values()) == lazy["lazy_steps"] and b3["small_b"] > 0, (b3, lazy)
    return out


def _part_first(name: str, ids_k: torch.Tensor, ids_p: torch.Tensor, g_k: torch.Tensor,
                g_p: torch.Tensor, n: int) -> int:
    """Kernel route against plain route: index-exact up to the first parting,
    which must be a near-tie (4 fp32 ulps of the first gain, the cached
    gains' resolution, plus rtol 1e-5), as phase 8 holds them."""
    parted = torch.nonzero(ids_k[:n] != ids_p[:n])
    t = int(parted[0]) if len(parted) else n
    tol = 4 * float(np.spacing(np.float32(float(g_p[0]))))
    if t < n:
        gap = abs(float(g_k[t]) - float(g_p[t]))
        log(f"{name}: the routes part at step {t} of {n}: kernel picks {int(ids_k[t])} (gain "
            f"{float(g_k[t])!r}), plain {int(ids_p[t])} (gain {float(g_p[t])!r}): a gap of "
            f"{gap:.3e} (near-tie bound {tol:.3e})")
        assert gap <= tol + 1e-5 * abs(float(g_p[t])), f"{name}: the routes part at a clear gap"
    else:
        log(f"{name}: kernel and plain routes index-equal over all {n} steps")
    before = slice(0, t)
    np.testing.assert_allclose(g_k[before].cpu().numpy(), g_p[before].cpu().numpy(),
                               rtol=1e-4, atol=tol)
    return t


def phase_hier_select(dev, x, *, block: int, k: int) -> dict:
    """16c: ``hierarchical_select`` (facility location, gram-free, kernels)
    and the registry's ``milo_hier`` (the plain route); block 0's level 0
    and one refine on both routes."""
    from repro_torch.core import greedy as greedy_mod
    from repro_torch.core import milo as milo_mod
    from repro_torch.core.gram_free import make_gram_free_facility_location
    from repro_torch.core.partition import RandomBlocks, proportional_budgets
    from repro_torch.kernels.fl_gains import ops as fl_ops
    from repro_torch.selection import build_selector

    log(f"== phase 16c: hierarchical_select (facility location, random_blocks {block}, "
        "refine_factor 2, use_pallas=True) and milo_hier")
    kernel_rows: list = []
    union_feats: list = []
    orig_kernel = milo_mod._hier_kernel

    def kernel_recorded(feats, n_pad, **kw):
        kernel_rows.append(len(feats))
        union_feats[:] = [feats]          # the last call's rows: the refine's union
        return orig_kernel(feats, n_pad, **kw)

    stages = {"level0": "greedy", "refine": "run_refine", "kernel_build": "_hier_kernel"}
    milo_mod._hier_kernel = kernel_recorded
    held = _reset_peak(dev)
    try:
        with _stage_times(milo_mod, stages, dev) as times, _lazy_runs() as runs:
            _reset_launches()
            t0 = time.perf_counter()
            idx, info = milo_mod.hierarchical_select(
                x, k, partition="random_blocks", block_size=block, refine_factor=2,
                fn_name="facility_location", gram_free=True, use_pallas=True, return_info=True,
                device=dev)
            _sync(dev)
            wall = time.perf_counter() - t0
            launches = _selection_launches()
    finally:
        milo_mod._hier_kernel = orig_kernel
    peak = _peak_mib(dev, held)
    lazy = _lazy_summary(runs, times["refine"])
    parts = RandomBlocks(block_size=block, seed=0).partition(None, len(x))
    budgets = proportional_budgets(parts, k)
    k_sels = [min(len(p.indices), 2 * b) for p, b in zip(parts, budgets)]
    n_max, k_max = max(len(p.indices) for p in parts), max(k_sels)
    log(f"hierarchical_select {wall:.3f} s: level 0 {times['level0']:.3f} s ({len(parts)} x "
        f"{k_max} greedy steps at ({n_max}, {x.shape[1]})), refine {times['refine']:.3f} s "
        f"({lazy['steps']} lazy steps, {lazy['us_per_step']:.1f} us per step, "
        f"{lazy['full_recomputes']} full recomputes; B3 gather sizes b (b: calls) "
        f"{lazy['gather_sizes']}: single-level gathers, as the reference's refine), kernels' inputs "
        f"{times['kernel_build']:.3f} s")
    log(f"info {info}; launches {launches}; {_peak_text(peak, held)}")
    assert idx.shape == (k,) and len(np.unique(idx)) == k and idx.min() >= 0 and idx.max() < len(x)
    assert info == {"n_partitions": len(parts), "union_size": sum(k_sels),
                    "peak_partition_rows": n_max, "refine_factor": 2}, info
    assert kernel_rows == [len(p.indices) for p in parts] + [sum(k_sels)], kernel_rows
    b2, b3 = launches["fl_gains_gram_free"], launches["fl_gains_gram_free_delta"]
    level0 = sum(min(k_max, len(p.indices)) for p in parts)
    assert lazy["passes"] == 1, "one lazy refine"
    if dev.type == "cuda":
        # one B2 a level-0 step, plus the refine's init and full recomputes;
        # one B3 a lazy step of the refine, each on the instance its gather
        # size takes (single-level gathers of the whole budget: > 64 rows, tiled)
        assert b2 == {"ring": level0 + 1 + lazy["full_recomputes"], "tiled": 0}, (b2, lazy)
        small = sum(c for b, c in lazy["gather_sizes"].items() if b <= 64)
        assert b3 == {"small_b": small, "tiled": lazy["lazy_steps"] - small}, (b3, lazy)
        assert launches["similarity"] == 0

    # block 0's level 0 and the refine, on both routes
    fn_k = make_gram_free_facility_location(use_pallas=True)
    fn_p = make_gram_free_facility_location(use_pallas=False)
    kern = dict(gram_free=True, metric="cosine", gram_block=2048, device=dev)
    A, valid = milo_mod._hier_kernel(x[parts[0].indices], n_max, use_pallas=True, **kern)
    res = {}
    for name, fn in (("kernel", fn_k), ("plain", fn_p)):
        _sync(dev)
        t0 = time.perf_counter()
        res[name] = greedy_mod.greedy(fn, A, k_max, valid=valid, n=n_max)
        _sync(dev)
        res[name + "_s"] = time.perf_counter() - t0
    log(f"block 0's level 0 ({k_max} steps): kernel route {res['kernel_s']:.3f} s, plain route "
        f"{res['plain_s']:.3f} s")
    t0_part = _part_first("block 0's level 0", res["kernel"].indices, res["plain"].indices,
                          res["kernel"].gains, res["plain"].gains, k_sels[0])
    # B2 against its plain version at the block's shape, under the cover of its level 0
    w = res["kernel"].indices[:k_sels[0]]
    c = torch.where(valid, (0.5 + 0.5 * (A @ A[w].T)).max(dim=1).values,
                    torch.full_like(valid, float("inf"), dtype=torch.float32))
    err_b2 = _check(f"fl_gains_gram_free at block 0 ({n_max}, {n_max}, {x.shape[1]}) under its "
                    "level-0 cover", fl_ops.fl_gains_gram_free(A, A, c),
                    fl_ops.fl_gains_gram_free(A, A, c, use_pallas=False), fl_tol(n_max))
    del A, valid

    (union,) = union_feats
    A, valid = milo_mod._hier_kernel(union, len(union), use_pallas=True, **kern)
    budget = max(1, int(len(union) * 0.125))
    for name, fn in (("kernel", fn_k), ("plain", fn_p)):
        _sync(dev)
        t0 = time.perf_counter()
        res["refine_" + name] = greedy_mod.refine(fn, A, k, valid=valid, lazy_budget=budget)
        _sync(dev)
        res["refine_" + name + "_s"] = time.perf_counter() - t0
    log(f"the refine ({len(union)} rows to {k}, lazy budget {budget}): kernel route "
        f"{res['refine_kernel_s']:.3f} s, plain route {res['refine_plain_s']:.3f} s")
    t_part = _part_first("the refine", res["refine_kernel"].indices, res["refine_plain"].indices,
                         res["refine_kernel"].gains, res["refine_plain"].gains, k)
    same_run = np.array_equal(union[res["refine_kernel"].indices.cpu().numpy()], x[idx])
    log(f"the refine's kernel route again picks hierarchical_select's subset: {same_run}")
    assert same_run, "a rerun of the kernel route picked another subset"
    # B3 against its plain version at the union's shape: 8 touched rows
    c_old = (0.5 + 0.5 * (A @ A[res["refine_kernel"].indices[:64]].T)).max(dim=1).values
    c_new = torch.maximum(c_old, 0.5 + 0.5 * (A @ A[res["refine_kernel"].indices[64]]))
    rows_t = torch.nonzero(c_new > c_old)[:8, 0]
    assert len(rows_t) > 0
    err_b3 = _check(f"fl_gains_gram_free_delta at the union ({len(rows_t)}, {len(union)}, "
                    f"{x.shape[1]})", fl_ops.fl_gains_gram_free_delta(A[rows_t], A, c_old[rows_t],
                                                                      c_new[rows_t]),
                    fl_ops.fl_gains_gram_free_delta(A[rows_t], A, c_old[rows_t], c_new[rows_t],
                                                    use_pallas=False), fl_tol(len(rows_t)))
    del A, valid

    # the registry's milo_hier: the reference's plain route on the card
    _sync(dev)
    t0 = time.perf_counter()
    sel = build_selector("milo_hier", features=x, k=k, partition_block=block, device=dev)
    plan = sel.plan(0)
    _sync(dev)
    t_sel = time.perf_counter() - t0
    plan.validate(len(x))
    assert plan.phase == "fixed" and len(np.unique(plan.indices)) == k
    assert sel.info == info, (sel.info, info)
    z = torch.as_tensor(x, device=dev)
    z = z / z.norm(dim=1, keepdim=True).clamp_min(1e-8)

    def fl_value(sub: np.ndarray) -> float:
        zs = z[torch.as_tensor(sub, device=dev)]
        return sum(float((0.5 + 0.5 * (z[lo:lo + 8192] @ zs.T)).max(dim=1).values.double().sum())
                   for lo in range(0, len(z), 8192))

    f_k, f_p = fl_value(idx), fl_value(plan.indices)
    overlap = len(np.intersect1d(idx, plan.indices))
    log(f"milo_hier (plain route) {t_sel:.3f} s: {overlap} of {k} rows shared with the kernel "
        f"route; facility-location value {f_p:.6f} against the kernel route's {f_k:.6f} "
        f"(ratio {f_k / f_p:.8f})")
    assert abs(f_k / f_p - 1.0) <= 1e-3, "the kernel route's subset covers the data worse"
    return {"wall_s": wall, "stages": times, "lazy": lazy, "launches": launches, "info": info,
            "peak_mib": peak, "held_mib": held, "level0_parting": t0_part,
            "refine_parting": t_part, "route_s": {key: v for key, v in res.items()
                                                  if key.endswith("_s")},
            "milo_hier_s": t_sel, "overlap": overlap, "fl_ratio": f_k / f_p,
            "max_abs_err": {"fl_gains_gram_free": err_b2, "fl_gains_gram_free_delta": err_b3}}


def phase_hier_targeted(dev, x, y, *, k: int, n_queries: int) -> dict:
    """16d: ``milo_targeted`` with queries from class 0, by class, rf 4."""
    from repro_torch.selection import build_selector

    log(f"== phase 16d: milo_targeted ({n_queries} queries from class 0, k {k}, by_class, "
        "refine_factor 4)")
    queries = x[y == 0][:n_queries]
    _sync(dev)
    t0 = time.perf_counter()
    sel = build_selector("milo_targeted", features=x, queries=queries, k=k, labels=y,
                         partition="by_class", refine_factor=4, device=dev)
    idx = sel.plan(0).indices
    _sync(dev)
    wall = time.perf_counter() - t0
    assert len(np.unique(idx)) == k and idx.min() >= 0 and idx.max() < len(x)
    z = torch.as_tensor(x, device=dev)
    z = z / z.norm(dim=1, keepdim=True).clamp_min(1e-8)
    q = torch.as_tensor(queries, device=dev)
    q = q / q.norm(dim=1, keepdim=True)

    def query_fl(sub: np.ndarray) -> float:
        return float((0.5 + 0.5 * (z[torch.as_tensor(sub, device=dev)] @ q.T)).max(dim=0)
                     .values.double().sum())

    rand = np.random.default_rng(0).choice(len(x), size=k, replace=False)
    f_t, f_r = query_fl(idx), query_fl(rand)
    share = float(np.mean(y[idx] == 0))
    log(f"milo_targeted {wall:.3f} s, info {sel.info}: query facility-location value {f_t:.6f} "
        f"against a random subset's {f_r:.6f}; {share:.3f} of the subset from class 0")
    assert f_t > f_r, "the targeted subset covers the queries no better than a random one"
    return {"wall_s": wall, "info": sel.info, "query_fl": f_t, "random_query_fl": f_r,
            "class0_share": share}


def phase_hierarchical(dev, x, y, tx, ty, *, smi: str, sizes: dict, epochs: int) -> dict:
    """Phase 16: the hierarchical path on phase 5's data."""
    log(f"== phase 16: the hierarchical path on {smi}")
    t0 = time.perf_counter()
    dense = phase_hier_dense(dev, x, y, tx, ty, block=sizes["dense_block"], epochs=epochs)
    gf = phase_hier_gram_free(dev, x, y, tx, ty, block=sizes["gf_block"], epochs=epochs)
    sel = phase_hier_select(dev, x, block=sizes["gf_block"], k=gf["k"])
    tgt = phase_hier_targeted(dev, x, y, k=sizes["k_targeted"], n_queries=sizes["n_queries"])
    for run in (dense, gf):
        run.pop("md")
    summary = {"card": smi, "16a": dense, "16b": gf, "16c": sel, "16d": tgt,
               "total_s": time.perf_counter() - t0}
    log("phase 16 summary: " + json.dumps(summary, default=float))
    return summary


# ---------------------------------------------------------------------------
# phase 17: the encoder step (proxy, ViT-B/16, text) and the paper's
# baselines (Fig. 6) through MiloSession.train; CRAIG's greedy on B4
# ---------------------------------------------------------------------------

#: phase 17's widths at full size and in the CPU rehearsal
BASELINE_SIZES = {
    "full": dict(vit=dict(), n_images=5000, upsample=7, image_batch=256, text=dict(),
                 n_text=2000, text_len=(32, 128), route_rows=8192, craig_limit_s=20.0),
    "rehearsal": dict(vit=dict(image_size=32, patch_size=8, d_model=64, num_layers=2, num_heads=4,
                               d_ff=128),
                      n_images=200, upsample=1, image_batch=64,
                      text=dict(vocab_size=1000, max_len=64, d_model=32, num_layers=2,
                                num_heads=4, d_ff=64),
                      n_text=200, text_len=(8, 32), route_rows=600, craig_limit_s=20.0),
}

#: the C1 bound: what a finished session leaves allocated on the card
RELEASE_MIB = 8.0


def _allocated_mib(dev) -> float | None:
    """``memory_allocated`` once the garbage of earlier work is collected
    and cuBLAS's per-stream workspaces are dropped: those are library
    caches that the next product on a stream allocates again (32 MiB a
    stream on an H100 under torch 2.11), which torch's own leak check
    (``CudaMemoryLeakCheck``) drops before its readings too.  No live graph's workspace is among
    them: the engine drops them around every capture, so each graph's lies
    in its private pool."""
    if dev.type != "cuda":
        return None
    gc.collect()
    torch.cuda.synchronize(dev)
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated(dev) / 2**20


def _holders(obj, skip: set, depth: int = 4) -> str:
    """The objects that refer to ``obj``, ``depth`` levels up: type names
    (a dict's first keys), frames and the search's own lists left out."""
    out, level = [], [obj]
    frame = type(sys._getframe())
    for _ in range(depth):
        skip.add(id(level))
        refs = [r for o in level for r in gc.get_referrers(o)
                if id(r) not in skip and not isinstance(r, frame)]
        if not refs:
            break
        out.append(", ".join(f"{type(r).__name__}{list(r)[:4] if isinstance(r, dict) else ''}"
                             for r in refs[:4]))
        level = refs[:4]
    return " <- ".join(out)


def _leftovers(top: int = 4) -> list[str]:
    """The largest tensors still alive on the card, each with its holders."""
    live = [o for o in gc.get_objects() if isinstance(o, torch.Tensor) and o.is_cuda]
    live.sort(key=lambda t: t.untyped_storage().nbytes(), reverse=True)
    return [f"{tuple(t.shape)} {t.dtype} {t.untyped_storage().nbytes() / 2**20:.2f} MiB, held by "
            f"{_holders(t, {id(live)})}" for t in live[:top]]


def _released(label: str, dev, before: float | None, after: float | None) -> dict:
    """After ``del session``: collect, read ``memory_allocated`` again and
    hold it to the reading before the session (within ``RELEASE_MIB``);
    what is left over is named before the check fails."""
    freed = _allocated_mib(dev)
    if before is None:
        log(f"{label}: card memory not measured (cpu)")
        return {}
    left = freed - before
    log(f"{label}: memory_allocated {before:.2f} MiB before the session, {after:.2f} MiB after its "
        f"work, {freed:.2f} MiB after del + gc.collect() ({left:+.2f} MiB against before)")
    if abs(left) > RELEASE_MIB:
        for line in _leftovers():
            log(f"  left on the card: {line}")
    assert abs(left) <= RELEASE_MIB, f"{label}: {left:+.2f} MiB still allocated after the session"
    return {"before_mib": before, "after_mib": after, "released_mib": freed, "left_mib": left}


def vit_flops(cfg) -> float:
    """Multiply-adds ×2 of one image through ``vit_encode``: the patch
    projection, each layer's qkv, attention (scores and values), output
    projection and MLP."""
    s, d, f = cfg.n_patches + 1, cfg.d_model, cfg.d_ff
    layer = 2 * s * d * 3 * d + 2 * 2 * s * s * d + 2 * s * d * d + 2 * 2 * s * d * f
    return 2.0 * cfg.n_patches * 3 * cfg.patch_size ** 2 * d + cfg.num_layers * layer


def _encoder_artifact(label, md, m: int, encoder_id: str, launches: int, expected: int, dev):
    _check_artifact(md, m, 8, {"encoder_id": encoder_id})
    log(f"{label} artifact: k {md.k}, config_hash {md.config_hash()}, similarity launches "
        f"{launches} (expected sum_c ceil(n_c/2048) = {expected})")
    if dev.type == "cuda":
        assert launches == expected, (launches, expected)


def _expected_tiles(y: np.ndarray, block: int = 2048) -> int:
    return int(sum(math.ceil(int(s) / block) for s in np.bincount(y) if s))


def phase_proxy_encoder(dev, x, y, tx, ty, *, epochs: int) -> dict:
    """17a: the proxy encoder fit on the training rows, its 128-wide
    features preprocessed with B1, the artifact reloaded by a session that
    expects ``encoder_id="proxy"`` and refused by one that expects "vit",
    then ``milo`` trained on the raw rows."""
    from repro_torch.core import preprocess_with_encoder
    from repro_torch.core.metadata import MetadataMismatchError
    from repro_torch.encoders import ProxyEncoder
    from repro_torch.kernels.similarity import similarity as sk
    from repro_torch.selection import MiloSession

    log("== phase 17a: proxy encoder (d_hidden 128, 60 full-batch steps) -> preprocess_with_encoder")
    _sync(dev)
    t0 = time.perf_counter()
    enc = ProxyEncoder(d_in=x.shape[1], n_classes=int(y.max()) + 1, d_hidden=128, epochs=60,
                       device=dev).fit(x, y)
    _sync(dev)
    t_fit = time.perf_counter() - t0
    probe = enc.linear_probe_accuracy(x, y), enc.linear_probe_accuracy(tx, ty)
    enc_time = {"encode": 0.0}
    _reset_launches()
    held = _reset_peak(dev)
    t0 = time.perf_counter()
    md = preprocess_with_encoder(_timed(enc.encode, enc_time, "encode", dev), x, y, 0,
                                 encoder_id="proxy", use_pallas=True, device=dev)
    t_pre = time.perf_counter() - t0
    peak = _peak_mib(dev, held)
    log(f"fit {t_fit:.3f} s; linear-probe accuracy train {probe[0]:.4f}, test {probe[1]:.4f}; "
        f"preprocess_with_encoder {t_pre:.3f} s (encode {enc_time['encode']:.3f} s in "
        f"{-(-len(x) // 256)} batches of 256); {_peak_text(peak, held)}")
    _encoder_artifact("proxy", md, len(x), "proxy", sk.launches, _expected_tiles(y), dev)
    feats = enc.encode(x)
    assert feats.shape == (len(x), 128) and np.isfinite(feats).all()

    before = _allocated_mib(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "proxy.npz")
        md.save(path)
        session = MiloSession(use_pallas=True, total_epochs=epochs, lr=0.01, metadata_path=path,
                              device=dev)
        back = session.preprocess(feats, y, encoder_id="proxy")
        assert session.loaded_from_artifact and back.config_hash() == md.config_hash()
        other = MiloSession(use_pallas=True, metadata_path=path, device=dev)
        try:
            other.preprocess(feats, y, encoder_id="vit")
        except MetadataMismatchError as e:
            log(f"artifact reloads (config_hash {md.config_hash()}); a session expecting "
                f"encoder_id 'vit' refuses it: {str(e).split(': ', 1)[1]}")
        else:
            raise AssertionError("a session expecting encoder_id 'vit' took the proxy artifact")
        t0 = time.perf_counter()
        report = session.train(x, y, test_x=tx, test_y=ty)
        t_train = time.perf_counter() - t0
    after = _allocated_mib(dev)
    log(f"milo on the raw rows with the proxy artifact: train {t_train:.3f} s "
        f"({report.train_time:.3f} s timed, {report.steps} steps), accuracy {report.final_acc:.4f}")
    assert report.final_acc >= 0.5, f"test accuracy {report.final_acc} is near chance"
    del session, other, back
    memory = _released("17a session", dev, before, after)
    return {"fit_s": t_fit, "probe_acc": probe, "preprocess_s": t_pre, "encode_s": enc_time["encode"],
            "peak_mib": peak, "train_s": t_train, "accuracy": report.final_acc, "memory": memory}


def phase_vit_encoder(dev, *, sizes: dict) -> dict:
    """17b: ViT-B/16 at published widths (random weights from seed 0, fp32,
    TF32 off) over class-structured 32×32 images upsampled (nearest) inside
    ``encode_fn``; the features preprocessed with B1."""
    from repro_torch.core import preprocess_with_encoder
    from repro_torch.encoders import ViTConfig, init_vit, vit_encode
    from repro_torch.kernels.similarity import similarity as sk

    cfg = ViTConfig(**sizes["vit"])
    n, up, batch = sizes["n_images"], sizes["upsample"], sizes["image_batch"]
    log(f"== phase 17b: ViT encoder {cfg} over {n} images of 32x32x3 upsampled x{up} "
        f"(nearest), batches of {batch}")
    params = init_vit(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    labels = np.repeat(np.arange(10), n // 10)
    templates = rng.normal(size=(10, 32, 32, 3)).astype(np.float32)
    images = templates[labels] + 0.5 * rng.normal(size=(n, 32, 32, 3)).astype(np.float32)

    def upsample(batch_np, device):
        t = torch.as_tensor(batch_np, device=device)
        return t.repeat_interleave(up, dim=1).repeat_interleave(up, dim=2)

    def encode(batch_np):
        return vit_encode(params, upsample(batch_np, dev), cfg)

    enc_time = {"encode": 0.0}
    _reset_launches()
    t0 = time.perf_counter()
    md = preprocess_with_encoder(_timed(encode, enc_time, "encode", dev), images, labels, 0,
                                 batch_size=batch, encoder_id="vit", use_pallas=True, device=dev)
    t_pre = time.perf_counter() - t0
    flops = vit_flops(cfg) * n
    rate = flops / enc_time["encode"] / 1e12
    log(f"encode {enc_time['encode']:.3f} s ({-(-n // batch)} batches): {n / enc_time['encode']:.1f} "
        f"images/s, {vit_flops(cfg) / 1e9:.2f} GFLOP an image, {rate:.2f} TFLOP/s "
        f"({100 * rate * 1e12 / PEAK_FP32_FLOPS:.1f}% of the fp32 peak); "
        f"preprocess_with_encoder {t_pre:.3f} s in all")
    _encoder_artifact("vit", md, n, "vit", sk.launches, _expected_tiles(labels), dev)
    one = images[:batch]
    z1, z2 = encode(one), encode(one)
    assert torch.equal(z1, z2), "one batch encoded twice differs"
    assert z1.shape == (len(one), cfg.d_model) and torch.isfinite(z1).all()
    cpu = torch.device("cpu")
    params_cpu = {k: ([{kk: vv.to(cpu) for kk, vv in lp.items()} for lp in v] if k == "layers"
                      else v.to(cpu)) for k, v in params.items()}
    z_cpu = vit_encode(params_cpu, upsample(images[:4], cpu), cfg)
    err = float((z1[:4].cpu() - z_cpu).abs().max())
    log(f"one batch encoded twice: bit-equal; 4 images on {dev.type} against the CPU: max abs "
        f"diff {err:.3e}")
    np.testing.assert_allclose(z1[:4].cpu().numpy(), z_cpu.numpy(), **TOL[torch.float32])
    return {"encode_s": enc_time["encode"], "images_per_s": n / enc_time["encode"], "tflops": rate,
            "fp32_peak_share": rate * 1e12 / PEAK_FP32_FLOPS, "preprocess_s": t_pre,
            "cpu_max_abs_diff": err}


def phase_text_encoder(dev, *, sizes: dict) -> dict:
    """17c: the SBERT-style text encoder at all-distilroberta-v1's widths
    (random weights) over padded, masked sequences; the masked-tail check
    of ``tests/test_encoders.py`` on the card."""
    from repro_torch.core import preprocess_with_encoder
    from repro_torch.encoders import TextEncoderConfig, init_text_encoder, text_encode
    from repro_torch.kernels.similarity import similarity as sk

    cfg = TextEncoderConfig(**sizes["text"])
    n, (lo, hi) = sizes["n_text"], sizes["text_len"]
    log(f"== phase 17c: text encoder {cfg} over {n} sequences of {lo}-{hi} tokens")
    params = init_text_encoder(cfg, seed=0, device=dev)
    rng = np.random.default_rng(1)
    labels = np.repeat(np.arange(10), n // 10)
    band = cfg.vocab_size // 10          # each class draws from its own band of ids
    lengths = rng.integers(lo, hi + 1, n)
    mask = np.arange(hi)[None] < lengths[:, None]
    toks = np.where(mask, labels[:, None] * band + rng.integers(0, band, (n, hi)), 1)
    inputs = np.stack([toks, mask.astype(np.int64)], axis=1)

    def encode(batch_np):
        t = torch.as_tensor(batch_np, device=dev)
        return text_encode(params, t[:, 0], cfg, t[:, 1].float())

    enc_time = {"encode": 0.0}
    _reset_launches()
    t0 = time.perf_counter()
    md = preprocess_with_encoder(_timed(encode, enc_time, "encode", dev), inputs, labels, 0,
                                 encoder_id="text", use_pallas=True, device=dev)
    t_pre = time.perf_counter() - t0
    log(f"encode {enc_time['encode']:.3f} s ({-(-n // 256)} batches): {n / enc_time['encode']:.1f} "
        f"sequences/s; preprocess_with_encoder {t_pre:.3f} s in all")
    _encoder_artifact("text", md, n, "text", sk.launches, _expected_tiles(labels), dev)
    # tests/test_encoders.py's property: a masked-out tail does not move the embedding
    short = int(np.argmin(lengths))
    pair = inputs[[short, short]].copy()
    pair[1, 0, lengths[short]:] = 0
    z = encode(pair)
    diff = float((z[0] - z[1]).abs().max())
    log(f"masked tail ({hi - lengths[short]} tokens of sequence {short} changed): max abs diff "
        f"{diff:.3e}")
    assert diff <= 1e-5, diff
    return {"encode_s": enc_time["encode"], "sequences_per_s": n / enc_time["encode"],
            "preprocess_s": t_pre, "masked_tail_diff": diff}


def _probe_grads(dev, x, y, tx, ty):
    """The bench's last-layer proxy (``benchmarks/bench_training.py``): the
    probe MLP's ``softmax(logits) − onehot`` over the training rows, and its
    mean over the validation rows, on the device; and EL2N scores from a
    probe trained 2 epochs on the full set."""
    import importlib

    from repro_torch.models.classifier import init_mlp, mlp_logits

    sm = importlib.import_module("repro_torch.selection.session")
    n_classes = int(y.max()) + 1
    X, Y = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    VX, VY = torch.as_tensor(tx, device=dev), torch.as_tensor(ty, device=dev)
    probe = init_mlp(torch.Generator().manual_seed(9), x.shape[1], n_classes, device=dev)

    @torch.no_grad()
    def residual(params, a, b):
        p = torch.softmax(mlp_logits(params, a), dim=-1)
        return p - torch.nn.functional.one_hot(b, n_classes).to(p.dtype)

    def grad_fn():
        return residual(probe, X, Y)

    def val_grad_fn():
        return residual(probe, VX, VY).mean(0)

    state = sm._init_classifier(9, x.shape[1], n_classes, 64, 0.01, 2, dev)
    step = sm._classifier_step_fn(4)
    for _ in range(2):                       # 2 epochs, one full-set batch each
        state, _ = step(state, {"x": X, "y": Y})
    scores = residual(state.params, X, Y).norm(dim=1).cpu().numpy()
    return grad_fn, val_grad_fn, scores


def phase_craig_routes(dev, g: torch.Tensor, *, rows: int) -> dict:
    """CRAIG on the first ``rows`` rows on the kernel route (B4) and the
    plain route: index-equal up to a near-tie parting; weights equal when
    the indices are."""
    from repro_torch.baselines import selectors as base_mod
    from repro_torch.core.similarity import gram_matrix
    from repro_torch.core.submodular import facility_location

    g = g[:rows]
    k = max(1, round(0.1 * rows))
    out = {}
    kernel_fn = base_mod.make_facility_location_pallas
    try:
        for name, make_fn in (("kernel", kernel_fn), ("plain", lambda: facility_location)):
            base_mod.make_facility_location_pallas = make_fn
            _sync(dev)
            t0 = time.perf_counter()
            out[name] = base_mod.craig_pb_select(g, k)
            out[name + "_s"] = time.perf_counter() - t0
    finally:
        base_mod.make_facility_location_pallas = kernel_fn
    (ik, wk), (ip, wp) = out["kernel"], out["plain"]
    log(f"CRAIG routes on the first {rows} rows (k {k}): kernel {out['kernel_s']:.3f} s, plain "
        f"{out['plain_s']:.3f} s")
    parted = np.nonzero(ik != ip)[0]
    if len(parted):
        t = int(parted[0])
        K = gram_matrix(g).double()
        cover = K[:, torch.as_tensor(ip[:t], device=dev)].max(dim=1).values if t else \
            torch.zeros(rows, dtype=torch.float64, device=dev)
        ga, gb = (float(torch.relu(K[:, int(j)] - cover).sum()) for j in (ip[t], ik[t]))
        gap = abs(ga - gb) / max(ga, gb)
        log(f"indices part at step {t} of {k}: plain picks {int(ip[t])} (float64 gain {ga!r}), "
            f"kernel {int(ik[t])} ({gb!r}): relative gap {gap:.2e}; weights not compared")
        # B4 sums 256-row chunks in fp32, then the chunks: its rounding
        # budget is (256 + rows / 256) · 2^-24 of the gain
        assert gap <= (256 + rows / 256) * 2.0**-24, f"the routes part at step {t} by {gap:.2e}"
        del K
    else:
        assert np.array_equal(wk, wp), "equal medoids with other cluster masses"
        log("indices equal; weights equal")
    return {"rows": rows, "k": k, "parted_at": int(parted[0]) if len(parted) else None,
            "kernel_s": out["kernel_s"], "plain_s": out["plain_s"]}


def phase_b4_at_craig(dev, g: torch.Tensor, idx: np.ndarray, smi: str) -> dict:
    """B4 at CRAIG's shape, (n, n) with n the training rows, under the cover
    of the first 100 medoids: time, plain time, bound, error."""
    from repro_torch.core.similarity import gram_matrix
    from repro_torch.kernels.fl_gains import fl_gains as fk
    from repro_torch.kernels.fl_gains.ref import fl_gains_ref

    K = gram_matrix(g)
    n = K.shape[0]
    c = K[:, torch.as_tensor(idx[:100], device=dev)].max(dim=1).values
    bound, by = fl_bound_ms("fl_gains", n, n)
    out = fk.fl_gains_cuda(K, c)
    ref = fl_gains_ref(K, c)
    err = _check(f"fl_gains at CRAIG's ({n}, {n})", out, ref, fl_tol(n))
    del out, ref
    ms = cuda_ms(lambda: fk.fl_gains_cuda(K, c))
    plain = cuda_ms(lambda: fl_gains_ref(K, c), iters=2, warmup=1)
    log(f"fl_gains at ({n}, {n}) on {smi}: {ms:.4f} ms against its {bound:.4f} ms bound "
        f"({by}; {100 * bound / ms:.1f}%), plain {plain:.4f} ms; max abs err {err:.3e}")
    return {"shape": f"({n}, {n})", "ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": by, "max_abs_err": err}


FIG6 = ("full", "el2n", "selfsup_prune", "craig_pb", "gradmatch_pb", "glister")
MODEL_DEPENDENT = ("craig_pb", "gradmatch_pb", "glister")


def phase_selfsup_routes(dev, x: np.ndarray, *, rows: int) -> dict:
    """Self-supervised pruning of the first ``rows`` rows on the card and on
    the CPU: the same kept rows, or sets that differ only in rows whose
    distance lies within rtol 1e-5 of the k-th (a near-tie), as the CPU
    tests hold the port against the reference."""
    from repro_torch.baselines.selectors import SelfSupPruneSelector, prototype_distances

    z = x[:rows]
    k = max(1, round(0.1 * rows))
    kept = {d: SelfSupPruneSelector(z, k, device=d).indices_for_epoch(0) for d in (dev, "cpu")}
    differ = np.setxor1d(kept[dev], kept["cpu"])
    if len(differ):
        zt = torch.as_tensor(z)
        first = np.random.default_rng(0).choice(len(z), 10, replace=False)
        dist = prototype_distances(zt, zt[torch.as_tensor(first)]).numpy()
        kth = np.sort(dist)[-k]
        np.testing.assert_allclose(dist[differ], kth, rtol=1e-5)
    log(f"selfsup_prune on the first {rows} rows (k {k}): {dev.type} and cpu keep "
        f"{'the same rows' if not len(differ) else f'sets differing in {len(differ)} near-tie rows'}")
    return {"rows": rows, "k": k, "differ": int(len(differ))}


def phase_fig6(dev, x, y, tx, ty, *, epochs: int, R: int, sizes: dict, smi: str) -> dict:
    """17d: the Fig. 6 rows, each through ``MiloSession.train(selector=...)``
    in a session of its own, released after its row.  Each baseline's
    selector is built first (the model-dependent ones take their first
    selection, which ``train`` would take as its warm-up), timed."""
    from repro_torch.baselines import selectors as base_mod
    from repro_torch.kernels.fl_gains import fl_gains as fk
    from repro_torch.models.classifier import accuracy
    from repro_torch.selection import MiloSession

    log(f"== phase 17d: the Fig. 6 rows ({', '.join(FIG6)}), {epochs} epochs, R {R}")
    grad_fn, val_grad_fn, scores = _probe_grads(dev, x, y, tx, ty)
    routes = phase_craig_routes(dev, grad_fn(), rows=min(sizes["route_rows"], len(x)))
    selfsup = phase_selfsup_routes(dev, x, rows=min(sizes["route_rows"], len(x)))
    kws = {"el2n": dict(scores=scores), "selfsup_prune": dict(n_prototypes=10),
           "craig_pb": dict(grad_fn=grad_fn, R=R), "gradmatch_pb": dict(grad_fn=grad_fn, R=R),
           "glister": dict(grad_fn=grad_fn, val_grad_fn=val_grad_fn, R=R)}
    rows = {}
    states, restore = _fits()
    try:
        for name in FIG6:
            before = _allocated_mib(dev)
            held = _reset_peak(dev)
            _reset_launches()
            session = MiloSession(use_pallas=True, total_epochs=epochs, lr=0.01, device=dev)
            row = {}
            with _stage_times(base_mod, {"greedy": "greedy"}, dev) as times:
                selector = name
                if name != "full":
                    _sync(dev)
                    t0 = time.perf_counter()
                    selector = session.selector(name, n=len(x), features=x, **kws[name])
                    plan0 = selector.plan(0)
                    row["first_selection_s"] = time.perf_counter() - t0
                    row["classes"] = np.bincount(y[plan0.indices], minlength=int(y.max()) + 1)
                if name == "craig_pb" and row["first_selection_s"] > sizes["craig_limit_s"]:
                    selector.R = epochs      # one window: this selection and one timed
                    log(f"craig_pb: the first selection took {row['first_selection_s']:.3f} s "
                        f"(> {sizes['craig_limit_s']:.0f} s): cut to R = {epochs}")
                t0 = time.perf_counter()
                report = session.train(x, y, test_x=tx, test_y=ty, selector=selector)
                row["wall_s"] = time.perf_counter() - t0
            row.update(train_s=report.train_time, accuracy=report.final_acc,
                       peak_mib=_peak_mib(dev, held), held_mib=held)
            if name in MODEL_DEPENDENT:
                row["selection_s"] = selector.selection_time
                row["R"] = selector.R
                row["selections"] = 1 + -(-epochs // selector.R)
            if name == "craig_pb":
                k = selector.cfg.k
                row["b4_launches"] = fk.launches["fl_gains"]
                row["greedy_s"] = times.get("greedy", 0.0)
                row["ms_per_step"] = 1e3 * row["greedy_s"] / (k * row["selections"])
                craig_idx = selector._idx
                if dev.type == "cuda":
                    assert row["b4_launches"] == k * row["selections"], (row["b4_launches"], k)
            if name == "selfsup_prune":
                # the rows farthest from 10 k-means prototypes fall in a few
                # classes of this mixture (the reference keeps the same rows,
                # tests/test_torch_baselines.py): the model is held to the
                # test rows of the classes its subset holds
                held_classes = np.nonzero(row["classes"])[0]
                on = np.isin(ty, held_classes)
                row["accuracy_on_held_classes"] = float(accuracy(
                    states[-1].params, torch.as_tensor(tx[on], device=dev),
                    torch.as_tensor(ty[on], device=dev)))
            after = _allocated_mib(dev)
            del session, selector
            states.clear()
            row["memory"] = _released(f"17d {name} session", dev, before, after)
            rows[name] = row
            gate = row.get("accuracy_on_held_classes", row["accuracy"])
            assert gate >= 0.5, f"{name}: test accuracy {gate} is near chance"
    finally:
        restore()
    full = rows["full"]
    for name, row in rows.items():
        row["speedup"] = full["train_s"] / row["train_s"]
        row["accuracy_loss"] = full["accuracy"] - row["accuracy"]
        extra = ""
        if "classes" in row:
            extra = (f", subset classes {row['classes'].tolist()}, first selection "
                     f"{row['first_selection_s']:.3f} s")
            row["classes"] = row["classes"].tolist()
        if "accuracy_on_held_classes" in row:
            extra += f", accuracy on its classes' test rows {row['accuracy_on_held_classes']:.4f}"
        if name in MODEL_DEPENDENT:
            extra += (f", selection {row['selection_s']:.3f} s over {row['selections']} "
                      f"selections at R {row['R']}")
        if name == "craig_pb":
            extra += (f"; B4 {row['b4_launches']} launches, greedy {row['greedy_s']:.3f} s, "
                      f"{row['ms_per_step']:.3f} ms a step")
        log(f"{name}: train {row['train_s']:.3f} s timed, accuracy {row['accuracy']:.4f}, speedup "
            f"{row['speedup']:.2f}x, accuracy loss {row['accuracy_loss']:+.4f} against full"
            f"{extra}; {_peak_text(row['peak_mib'], row['held_mib'])}")
    b4 = None
    if dev.type == "cuda":
        b4 = phase_b4_at_craig(dev, grad_fn(), craig_idx, smi)
        b4["launches"] = rows["craig_pb"]["b4_launches"]
    return {"routes": routes, "selfsup_routes": selfsup, "rows": rows, "b4": b4}


def phase_baselines(dev, x, y, tx, ty, *, smi: str, sizes: dict, epochs: int) -> dict:
    """Phase 17: the encoder step and the paper's baselines on phase 5's data."""
    log(f"== phase 17: the encoder step and the paper's baselines on {smi}")
    t0 = time.perf_counter()
    proxy = phase_proxy_encoder(dev, x, y, tx, ty, epochs=epochs)
    vit = phase_vit_encoder(dev, sizes=sizes)
    text = phase_text_encoder(dev, sizes=sizes)
    fig6 = phase_fig6(dev, x, y, tx, ty, epochs=epochs, R=10, sizes=sizes, smi=smi)
    summary = {"card": smi, "17a": proxy, "17b": vit, "17c": text, "17d": fig6,
               "total_s": time.perf_counter() - t0}
    log("phase 17 summary: " + json.dumps(summary, default=float))
    return summary


# ---------------------------------------------------------------------------
# phase 18: LM training with checkpoints, restart and the divergence guard
# ---------------------------------------------------------------------------

#: bf16 route check of 18a (chunked against naive attention on one batch):
#: the chunked route rounds its softmax probabilities to bf16 before p·v,
#: naive keeps them f32 — the loss within 1e-2 relative, every gradient
#: leaf within 5e-2 in relative Frobenius norm
ROUTE_TOL = dict(loss=1e-2, grad=5e-2)


def _ckpt_dir(name: str) -> Path:
    """A fresh directory for phase 18's checkpoints inside the checkout (a
    git-ignored build directory), removed at the end of its sub-phase."""
    import shutil

    d = ROOT / "build" / "phase18" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def _free_disk_gib(path: Path) -> float:
    import shutil

    return shutil.disk_usage(path).free / 2**30


def _state_bytes(state) -> int:
    from repro_torch import tree as T

    return sum(t.numel() * t.element_size() for t in T.leaves(state))


def _states_bit_equal(a, b) -> int:
    """Assert two train states equal bit for bit; returns the leaves held."""
    from repro_torch import tree as T

    la, lb = T.leaves(a), T.leaves(b)
    assert len(la) == len(lb), (len(la), len(lb))
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (i, x.dtype, y.dtype)
        assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)), \
            f"leaf {i} of {len(la)} ({tuple(x.shape)}, {x.dtype}) differs"
    return len(la)


def _timed_step(step, dev, marks: list):
    """``step`` with a pair of CUDA events around each call (no host read;
    the times are read after the run), or the host clock on the CPU."""
    import functools

    @functools.wraps(step)
    def timed(state, batch):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, batch)
            end.record()
            marks.append((start, end))
        else:
            t0 = time.perf_counter()
            out = step(state, batch)
            marks.append(time.perf_counter() - t0)
        return out

    return timed


def _step_ms(marks: list, dev) -> list[float]:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        return [s.elapsed_time(e) for s, e in marks]
    return [1e3 * t for t in marks]


def phase_lm_launcher(dev, *, rehearsal: bool, smi: str) -> dict:
    """18a: ``launch/train.py``'s flow on internlm2-1.8b at full width and
    depth: MILO over 512 documents, k = 128, batch 16 × 64 tokens, 4 epochs
    (32 steps), adamw with cosine lr from 1e-3, ``--ckpt`` (a checkpoint
    every 20 steps and at the end), run by ``launch.train`` as the
    launcher's ``main`` runs it (a timing hook around the step); then the
    newest checkpoint validated and restored, and the chunked route against
    naive attention on one batch with 4 KV blocks."""
    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.launch import train as launch
    from repro_torch.train.train_state import _loss_and_grads

    log("== phase 18a: launch/train.py on internlm2-1.8b (chunked attention, remat, bf16, "
        "checkpoints)")
    ckpt = _ckpt_dir("18a")
    argv = ["--arch", "internlm2-1.8b", "--device", dev.type, "--ckpt", str(ckpt)]
    cfg = None
    if rehearsal:
        argv.append("--smoke")
        cfg = dataclasses.replace(registry.smoke("internlm2-1.8b"), attention_impl="chunked",
                                  remat=True, dtype="bfloat16")
    args = launch.parse_args(argv)
    free = _free_disk_gib(ckpt)
    marks: list = []
    # the launcher's own path (launch.train, as its main runs it), with
    # CUDA events around each step; the peak covers the build and the fit
    held = _reset_peak(dev)
    t0 = time.perf_counter()
    run, state = launch.train(args, cfg=cfg, wrap_step=lambda step: _timed_step(step, dev, marks))
    _sync(dev)
    total_s = time.perf_counter() - t0
    peak = _peak_mib(dev, held)
    cfg, tr, fit_s = run["cfg"], run["trainer"], run["fit_s"]
    assert cfg.attention_impl == "chunked" and cfg.remat and cfg.dtype == "bfloat16", cfg
    n_params = sum(t.numel() for t in T.leaves(state.params))
    state_mib = _state_bytes(state) / 2**20
    log(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads} of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
        f"{n_params:,} parameters ({cfg.param_count():,} analytic); state "
        f"{_state_bytes(state) / 1e9:.2f} GB; MILO k = {run['subset_k']} of {args.n_docs} "
        f"documents, preprocess {run['preprocess_s']:.3f} s, build {total_s - fit_s:.1f} s; free "
        f"disk {free:.1f} GiB")
    assert n_params == cfg.param_count(), (n_params, cfg.param_count())
    summary = launch.summary(args, run, state)
    ms = _step_ms(marks, dev)
    steps = len(ms)
    tokens = args.batch_size * 64
    train_s = sum(ms) / 1e3
    losses = [(h["step"], h["loss"]) for h in tr.history if "loss" in h]
    save = dict(tr.ckpt.last_save)
    peak_text = ("peak memory not measured (cpu)" if peak is None else
                 f"peak memory {peak:.1f} MiB over launch.train (build and fit) above the "
                 f"{held:.1f} MiB earlier phases hold: the {state_mib:.1f} MiB state and "
                 f"{peak - state_mib:.1f} MiB more")
    log(f"launcher summary: {json.dumps(summary)}")
    log(f"{steps} steps: median {np.median(ms):.2f} ms (first {ms[0]:.1f} ms), "
        f"{steps / train_s:.2f} steps/s, {steps * tokens / train_s:.0f} tokens/s over the steps' "
        f"device time ({train_s:.3f} s); fit {fit_s:.3f} s with its checkpoints: "
        f"{steps * tokens / fit_s:.0f} tokens/s over the fit; loss "
        f"{losses[0][1]:.4f} (step {losses[0][0]}) -> {losses[-1][1]:.4f} (step {losses[-1][0]}); "
        f"{peak_text}")
    log(f"checkpoint step {save['step']}: {save['bytes'] / 1e9:.3f} GB; save: host snapshot "
        f"{save['snapshot_s']:.3f} s, write+fsync {save['write_s']:.3f} s, sha256 "
        f"{save['sha256_s']:.3f} s; steps on disk {tr.ckpt.all_steps()}")
    assert summary["steps"] == steps == int(state.step) == args.epochs * (run["subset_k"] //
                                                                          args.batch_size)
    assert losses[-1][1] < losses[0][1], f"loss must decrease: {losses}"
    assert tr.ckpt.all_steps() == [20, 32], tr.ckpt.all_steps()
    t0 = time.perf_counter()
    back = tr.ckpt.restore(32, state)   # validates the checksums first
    _sync(dev)
    restore_s = time.perf_counter() - t0
    held_leaves = _states_bit_equal(back, state)
    log(f"validate + restore of step 32: {restore_s:.3f} s; {held_leaves} leaves bit-equal to the "
        "trained state")
    del back
    # route check: one batch, attn_block 16 (S = 64 spans 4 KV blocks),
    # chunked against naive attention, at the trained weights
    batch = tr.put_batch(next(iter(run["pipeline"].epoch(0))))
    chunked = dataclasses.replace(cfg, attn_block=16)
    naive = dataclasses.replace(cfg, attention_impl="naive")
    loss_c, g_c = _loss_and_grads(state.params, chunked, batch)
    loss_n, g_n = _loss_and_grads(state.params, naive, batch)
    rel = [float(torch.linalg.vector_norm((a.float() - b.float())) /
                 torch.clamp_min(torch.linalg.vector_norm(b.float()), 1e-30))
           for a, b in zip(T.leaves(g_c), T.leaves(g_n))]
    loss_rel = abs(float(loss_c) - float(loss_n)) / abs(float(loss_n))
    log(f"route check (4 KV blocks of 16 against naive, bf16): loss {float(loss_c):.6f} / "
        f"{float(loss_n):.6f} (relative {loss_rel:.2e}, bound {ROUTE_TOL['loss']}); gradient "
        f"leaves' relative error max {max(rel):.2e}, median {float(np.median(rel)):.2e} (bound "
        f"{ROUTE_TOL['grad']}); {smi}")
    assert loss_rel <= ROUTE_TOL["loss"] and max(rel) <= ROUTE_TOL["grad"], (loss_rel, max(rel))
    del g_c, g_n
    import shutil

    shutil.rmtree(ckpt, ignore_errors=True)
    return {"arch": cfg.name, "params": n_params, "steps": steps,
            "median_step_ms": float(np.median(ms)), "steps_per_s": steps / train_s,
            "tokens_per_s": steps * tokens / train_s, "fit_s": fit_s,
            "fit_tokens_per_s": steps * tokens / fit_s, "state_mib": state_mib,
            "loss_first": losses[0][1], "loss_last": losses[-1][1], "peak_mib": peak,
            "checkpoint": save, "validate_restore_s": restore_s,
            "route": {"loss_rel": loss_rel, "grad_rel_max": max(rel)}}


def _corrupt_one_byte(directory: Path, step: int) -> int:
    """Flip one byte in the middle of ``step_<step>/shard_0.npz``; returns
    its offset."""
    path = directory / f"step_{step}" / "shard_0.npz"
    off = path.stat().st_size // 2
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    return off


def phase_lm_resume(dev, *, rehearsal: bool) -> dict:
    """18b: ``examples/train_lm_milo.py``'s kill-and-resume, stricter, on
    granite-moe-1b-a400m at full width and depth: checkpoints every 16 of 24
    steps, the newest then corrupted by one byte, a fresh ``Trainer``
    resumes from the one before it and replays to the end under the guard
    (``skip_step``); parameters and both Adam moments bit-equal to the
    uninterrupted, unguarded run's, and the two runs' peaks beside each
    other."""
    from repro_torch.configs import registry
    from repro_torch.core.milo import MiloPreprocessor
    from repro_torch.data.datasets import TokenLMDataset
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.health import GuardPolicy
    from repro_torch.optim.optimizers import adamw
    from repro_torch.optim.schedules import cosine
    from repro_torch.selection import build_selector
    from repro_torch.train.train_state import init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig

    log("== phase 18b: kill and resume past a corrupted checkpoint (granite-moe-1b-a400m)")
    cfg = registry.get("granite-moe-1b-a400m")
    if rehearsal:
        cfg = dataclasses.replace(registry.smoke(cfg), attention_impl="chunked", remat=True,
                                  dtype="bfloat16")
    ckpt = _ckpt_dir("18b")
    ds = TokenLMDataset(n_docs=256, seq_len=64, vocab=cfg.vocab_size, seed=0)
    pre = MiloPreprocessor(subset_fraction=0.5, n_sge_subsets=4, classwise=False, device=dev)
    md = pre.preprocess(ds.features(), None, seed=0)
    batch_size, every = 16, 16
    steps_per_epoch = md.k // batch_size
    epochs = 3
    total = steps_per_epoch * epochs
    sel = build_selector("milo", metadata=md, total_epochs=epochs, kappa=1 / 6, R=1, device=dev)
    pipe = Pipeline(ds.batch, sel, batch_size, seed=0, device=dev)
    opt = adamw()
    step_fn = make_train_step(cfg, opt, cosine(1e-3, total, warmup=10))
    tcfg = TrainerConfig(epochs=epochs, checkpoint_dir=str(ckpt), checkpoint_every_steps=every,
                         log_every_steps=8)
    state = init_train_state(cfg, opt, seed=0, device=dev)
    need = 2 * _state_bytes(state) / 2**30
    free = _free_disk_gib(ckpt)
    log(f"k = {md.k}, {steps_per_epoch} steps an epoch, {total} steps; state "
        f"{_state_bytes(state) / 1e9:.2f} GB, two checkpoints need {need:.1f} GiB of the "
        f"{free:.1f} GiB free")
    assert free > need + 2, f"{free:.1f} GiB free cannot hold two checkpoints ({need:.1f} GiB)"
    box = [state]   # the trainer alone holds the state while it trains
    del state
    held_mib = _reset_peak(dev)
    t0 = time.perf_counter()
    tr = Trainer(step_fn, pipe, tcfg)
    ref = tr.fit(box.pop(), resume=False)
    _sync(dev)
    fit_s = time.perf_counter() - t0
    peak_ref = _peak_mib(dev, held_mib)
    steps_on_disk = tr.ckpt.all_steps()
    assert steps_on_disk == [every, total], steps_on_disk
    losses = [(h["step"], h["loss"]) for h in tr.history if "loss" in h]
    assert losses[-1][1] < losses[0][1], f"loss must decrease: {losses}"
    off = _corrupt_one_byte(ckpt, total)
    # the resume runs guarded (skip_step): healthy, it must give the
    # unguarded run's bits, and the guard over this functional step copies
    # no state (its peak against the unguarded run's)
    tr2 = Trainer(step_fn, pipe, TrainerConfig(epochs=epochs, checkpoint_dir=str(ckpt),
                                               checkpoint_every_steps=every, log_every_steps=8,
                                               guard=GuardPolicy("skip_step")))
    box = [init_train_state(cfg, opt, seed=0, device=dev)]
    held2_mib = _reset_peak(dev)
    t0 = time.perf_counter()
    resumed = tr2.fit(box.pop(), resume=True)
    _sync(dev)
    resume_s = time.perf_counter() - t0
    peak_guarded = _peak_mib(dev, held2_mib)
    assert tr2.guard_report() is None, tr2.guard_report()
    held = _states_bit_equal(resumed, ref)
    # the resume replayed exactly the steps after `every`: latest_valid_step
    # skipped the corrupted newest checkpoint
    ref_tail = [h for h in tr.history if h.get("step", 0) > every]
    strip = lambda hs: [{k: v for k, v in h.items() if k not in ("wall", "guard_bad")}  # noqa
                        for h in hs]
    assert strip(tr2.history) == strip(ref_tail), (tr2.history, ref_tail)
    peaks = ("peak memory not measured (cpu)" if peak_ref is None else
             f"peak memory {peak_ref:.1f} MiB unguarded (fit) / {peak_guarded:.1f} MiB guarded "
             f"(resume: restore, steps, save) above the {held_mib:.1f} / {held2_mib:.1f} MiB held before, "
             f"state {_state_bytes(ref) / 2**20:.1f} MiB")
    log(f"uninterrupted: {total} steps and 2 checkpoints in {fit_s:.3f} s, loss "
        f"{losses[0][1]:.4f} -> {losses[-1][1]:.4f}; step {total}'s shard corrupted at byte "
        f"{off}; a fresh Trainer skipped it, resumed at {every} and replayed {total - every} "
        f"steps in {resume_s:.3f} s (validate both, restore, steps, final checkpoint) under "
        f"GuardPolicy('skip_step'): {held} leaves (parameters, both Adam moments, t, step) and "
        f"{len(tr2.history)} history records bit-equal to the uninterrupted, unguarded run's; "
        f"{peaks}")
    del ref, resumed
    import shutil

    shutil.rmtree(ckpt, ignore_errors=True)
    return {"arch": cfg.name, "steps": total, "fit_s": fit_s, "resume_s": resume_s,
            "leaves": held, "checkpoint": dict(tr2.ckpt.last_save),
            "peak_mib": {"unguarded": peak_ref, "guarded": peak_guarded}}


def _poisoned(selector, epoch: int, pos: int):
    """``selector`` whose plan for ``epoch`` carries a NaN weight at ``pos``."""
    class Poisoned:
        def plan(self, e):
            plan = selector.plan(e)
            if e != epoch:
                return plan
            w = np.array(plan.weights, np.float32)
            w[pos] = np.nan
            return dataclasses.replace(plan, weights=w)

    return Poisoned()


def _count_syncs(fn):
    """(result, synchronising calls) of ``fn()`` on the card, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchronizing" in str(w.message) for w in caught)


def phase_guard_fused(dev, x, y, md, *, epochs: int = 2, batch_size: int = 32,
                      superstep: int = 32) -> dict:
    """18c: the divergence guard on the fused path at phase 14's geometry
    (phase 5's data and artifact, ``milo``, batch 32, segments of 32 as
    CUDA graphs): healthy ``skip_step`` bit-equal to unguarded with as many
    host reads (after a warm-up fit); a NaN plan weight skipped with the step counter advanced;
    ``rollback`` (a checkpoint every quarter epoch) replaying to
    ``skip_step``'s state."""
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.health import GuardPolicy
    from repro_torch.selection import build_selector
    from repro_torch.selection import session as session_mod
    from repro_torch.train import engine as engine_mod
    from repro_torch.train.trainer import Trainer, TrainerConfig

    log(f"== phase 18c: the divergence guard on the fused path (graphs, superstep {superstep})")
    sel = build_selector("milo", metadata=md, total_epochs=epochs, seed=0, device=dev)
    k = sel.plan(0).k
    steps_per_epoch = k // batch_size
    total = steps_per_epoch * epochs
    every = max(1, steps_per_epoch // 4)
    # poison epoch 0's step every + every // 2 (0-based): after the first
    # checkpoint, so rollback has one to restore; the position is the plan
    # row that the pipeline's permutation puts there
    perm = np.random.default_rng(0 * 1_000_003 + 0).permutation(k)
    bad = min(steps_per_epoch - 1, every + every // 2)
    pos = int(perm[bad * batch_size + 5])
    step_fn = session_mod._classifier_step_fn(1)
    n_classes = int(y.max()) + 1

    def run(guard=None, selector=sel, ckpt=None):
        pipe = Pipeline(None, selector, batch_size, seed=0, arrays={"x": x, "y": y}, device=dev)
        tr = Trainer(step_fn, pipe, TrainerConfig(
            epochs=epochs, log_every_steps=1, guard=guard,
            checkpoint_dir=None if ckpt is None else str(ckpt),
            checkpoint_every_steps=every if ckpt is not None else 0, async_checkpoint=False),
            fused=True, superstep=superstep)
        init = lambda: session_mod._init_classifier(0, x.shape[1], n_classes, 64, 0.01,  # noqa
                                                    total, dev)
        held = _reset_peak(dev)
        tr.warm_fused(init())
        state, syncs = (_count_syncs(lambda: tr.fit(init(), resume=False)) if dev.type == "cuda"
                        else (tr.fit(init(), resume=False), None))
        tr.peak_mib = _peak_mib(dev, held)
        return state, tr, syncs

    engine_mod.captures = engine_mod.replays = 0
    # a first fit pays one-time host reads the later ones do not: warm up
    # with one, then the unguarded and the guarded run read equally often
    _, _, syncs_first = run()
    base, tr_base, syncs_base = run()
    healthy, tr_h, syncs_h = run(GuardPolicy("skip_step"))
    for key in base.params:
        assert torch.equal(_bits(base.params[key]), _bits(healthy.params[key])), key
        assert torch.equal(_bits(base.mom[key]), _bits(healthy.mom[key])), key
    assert tr_h.guard_report() is None and syncs_h == syncs_base, (syncs_h, syncs_base)
    assert all(h["guard_bad"] == 0.0 for h in tr_h.history if "loss" in h)
    poison = _poisoned(sel, 0, pos)
    skip, tr_s, _ = run(GuardPolicy("skip_step"), poison)
    rep = tr_s.guard_report()
    assert rep["skipped_steps"] == 1 and int(skip.step) == total, (rep, int(skip.step))
    bad_step = rep["events"][0]["step"]
    assert bad_step == bad + 1, (bad_step, bad)
    assert all(torch.isfinite(v).all() for v in skip.params.values())
    wrecked, _, _ = run(None, poison)
    assert not all(torch.isfinite(v).all() for v in wrecked.params.values()), \
        "an unguarded run takes the NaN weight into its parameters"
    ckpt = _ckpt_dir("18c")
    rolled, tr_r, _ = run(GuardPolicy("rollback"), poison, ckpt)
    rep_r = tr_r.guard_report()
    assert rep_r["rollbacks"] == 1 and rep_r["skipped_steps"] == 1, rep_r
    # the newest checkpoint before the flagged segment: checkpoints are
    # written after the segment's flags are read
    assert [h["restored_step"] for h in tr_r.history if h.get("guard")] == [bad // every * every]
    for key in skip.params:
        assert torch.equal(_bits(skip.params[key]), _bits(rolled.params[key])), key
        assert torch.equal(_bits(skip.mom[key]), _bits(rolled.mom[key])), key
    restored = [h["restored_step"] for h in tr_r.history if h.get("guard") == "rollback"]
    import shutil

    shutil.rmtree(ckpt, ignore_errors=True)
    state_mib = _state_bytes(base) / 2**20
    log(f"{total} steps ({steps_per_epoch} an epoch); healthy skip_step bit-equal to unguarded, "
        f"synchronising calls {syncs_h} / {syncs_base} (the warm-up fit {syncs_first}); peak memory (captures included) "
        f"{tr_h.peak_mib} / {tr_base.peak_mib} MiB guarded / unguarded, the guard's pre-step "
        f"copy one state ({state_mib:.3f} MiB) a step; NaN weight: step {bad_step} skipped, "
        f"counter at {int(skip.step)}, unguarded parameters non-finite; rollback restored step "
        f"{restored} and replayed to skip_step's state bit for bit; graph captures "
        f"{engine_mod.captures}, replays {engine_mod.replays}")
    return {"steps": total, "syncs": [syncs_first, syncs_base, syncs_h], "skipped_step": bad_step,
            "peak_mib": [tr_base.peak_mib, tr_h.peak_mib], "state_mib": state_mib,
            "restored": restored, "captures": engine_mod.captures,
            "replays": engine_mod.replays}


def phase_lm_training(dev, x, y, md, *, rehearsal: bool, smi: str) -> dict:
    """Phase 18; no kernel of the table lies on its path (asserted)."""
    _reset_launches()
    out = {"18a": phase_lm_launcher(dev, rehearsal=rehearsal, smi=smi),
           "18b": phase_lm_resume(dev, rehearsal=rehearsal)}
    out["18c"] = phase_guard_fused(dev, x, y, md)
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.ssd_chunk import ssd_chunk as sc

    assert fa.launches == sc.launches == 0, "phase 18 trains on chunked attention"
    log("phase 18 summary: " + json.dumps(out, default=float))
    return out


# ---------------------------------------------------------------------------
# phase 19: selection as a service — MiloServer (artifact store, shared
# buffers, breaker, retries, health), the firewall, fallback chains, fault
# injection, and landmark (feature-based) selection
# ---------------------------------------------------------------------------

#: phase 19's sizes at full size and in the CPU rehearsal
SERVE_SIZES = {"full": dict(max_budget=9, k_landmark=500, example=(1200, 6, 24)),
               "rehearsal": dict(max_budget=3, k_landmark=20, example=(240, 3, 8))}


def _planted(m: int) -> dict[str, list[int]]:
    """32 fixed rows of the training set: 8 NaN, 8 inf, 16 zero."""
    rows = np.random.default_rng(19).choice(m, 32, replace=False)
    return {"nan_rows": sorted(rows[:8].tolist()), "inf_rows": sorted(rows[8:16].tolist()),
            "zero_rows": sorted(rows[16:].tolist())}


def _launch_state() -> dict:
    from repro_torch.kernels import _build
    from repro_torch.kernels.similarity import similarity as sk
    from repro_torch.train import engine as engine_mod

    return {"captures": engine_mod.captures, "builds": _build.builds, "loads": _build.loads,
            "similarity": sk.launches}


def phase_server(dev, x, y, vx, vy, *, sizes: dict, smi: str) -> dict:
    """19a: ``MiloServer`` on phase 5's data, 32 rows poisoned and quarantined:
    warm, 3 tenants tuning at once, a repeat request; against a cold session
    and a serial replay on one worker."""
    import shutil

    from repro_torch.selection import MiloSession, MiloSessionConfig
    from repro_torch.serve import MiloClient, MiloServer, artifact_request_config
    from repro_torch.testing.faults import poison_features

    budget = sizes["max_budget"]
    log(f"== phase 19a: MiloServer on {x.shape} (firewall quarantine, 2 workers, 3 tenants, "
        f"max_budget {budget})")
    planted = _planted(len(x))
    bad = sorted(sum(planted.values(), []))
    log(f"planted rows: {json.dumps(planted)}")
    xp = poison_features(x, **planted)
    cfg = MiloSessionConfig(use_pallas=True, eval_every_epochs=10, fused_training=True,
                            firewall="quarantine")
    root = ROOT / "build" / "phase19" / "store"
    shutil.rmtree(root.parent, ignore_errors=True)
    before = _allocated_mib(dev)
    held = _reset_peak(dev)
    _reset_launches()
    server = MiloServer(cfg, device=dev, store_root=str(root), num_workers=2).start()
    t0 = time.perf_counter()
    warm = server.warm(xp, y, val_x=vx, val_y=vy, space=TUNE_SPACE)
    _sync(dev)
    t_warm = time.perf_counter() - t0
    warm_state = _launch_state()
    assert server.store.builds == 1 and warm["tune_replayed"]
    log(f"warm {t_warm:.3f} s: {warm['warmed_geometries']} geometries, B1 launches "
        f"{warm_state['similarity']}, graph captures {warm_state['captures']}, kernel library "
        f"builds {warm_state['builds']} and loads {warm_state['loads']} in this process so far")

    clients = [MiloClient(server, tenant=f"t{i}") for i in range(3)]
    t0 = time.perf_counter()
    rids = [c.submit_tune(xp, y, vx, vy, TUNE_SPACE, max_budget=budget, eta=3, seed=100 + i)
            for i, c in enumerate(clients)]
    tenants = [server.result(r, timeout=900) for r in rids]
    t_tenants = time.perf_counter() - t0
    rows = [server.poll(r) for r in rids]
    assert all(r["status"] == "done" and r["artifact_source"] == "memory" for r in rows), rows
    assert server.store.builds == 1, server.store.stats()
    per_request = [r["finished"] - r["started"] for r in rows]
    after_tenants = _launch_state()
    puts = server.buffers.put_count
    log(f"3 tenants at once: {t_tenants:.3f} s, per request "
        f"{', '.join(f'{s:.3f}' for s in per_request)} s, every row from memory; graph captures "
        f"{after_tenants['captures'] - warm_state['captures']}, buffer placements {puts}")

    t0 = time.perf_counter()
    repeat = clients[0].tune(xp, y, vx, vy, TUNE_SPACE, max_budget=budget, eta=3, seed=100)
    t_repeat = time.perf_counter() - t0
    new = {k: v - after_tenants[k] for k, v in _launch_state().items()}
    log(f"repeat request {t_repeat:.3f} s: new graph captures {new['captures']}, kernel library "
        f"builds {new['builds']} and loads {new['loads']}, B1 launches {new['similarity']}, "
        f"buffer placements {server.buffers.put_count - puts}")
    assert new == {"captures": 0, "builds": 0, "loads": 0, "similarity": 0}, new
    assert server.buffers.put_count == puts
    assert repeat.trials == tenants[0].trials
    peak = _peak_mib(dev, held)

    req = artifact_request_config(cfg)
    key = server.store.key_for(server.data_fingerprint(xp), req)
    md, _, source = server.store.get_or_build(key, req, lambda: None)
    assert source == "memory"
    quarantined = md.config["data_health"]["quarantined_rows"]
    assert quarantined == bad, (quarantined, bad)
    assert not np.isin(md.sge_subsets, bad).any() and float(md.wre_probs[bad].sum()) == 0.0
    assert md.config["firewall"] == "quarantine" and md.m == len(x)
    log(f"quarantined rows = the 32 planted; none in the bank ({md.sge_subsets.shape}), "
        f"WRE mass on them 0; health {server.health()['status']}")
    stats = server.stats()
    server.shutdown()
    after = _allocated_mib(dev)
    del server, clients, md
    memory = _released("phase 19 server", dev, before, after)

    t0 = time.perf_counter()
    cold = MiloSession(cfg, device=dev)
    cold.preprocess(xp, y)
    cold_res = cold.tune(xp, y, vx, vy, TUNE_SPACE, max_budget=budget, eta=3, seed=100)
    _sync(dev)
    t_cold = time.perf_counter() - t0
    del cold
    assert (cold_res.best_config, cold_res.best_score) == (tenants[0].best_config,
                                                           tenants[0].best_score)
    assert cold_res.trials == tenants[0].trials
    log(f"cold session (preprocess + tune) {t_cold:.3f} s: best config and score bit-equal to "
        f"tenant 0's ({tenants[0].best_config}, {tenants[0].best_score}); the warm repeat "
        f"request {t_cold / t_repeat:.1f}x faster (reported, not asserted)")
    sources = []
    with MiloServer(cfg, device=dev, store_root=str(root), num_workers=1) as serial:
        for i in (1, 2):
            rid = serial.submit("tune", features=xp, labels=y, val_x=vx, val_y=vy,
                                space=TUNE_SPACE, max_budget=budget, eta=3, seed=100 + i)
            again = serial.result(rid, timeout=900)
            sources.append(serial.poll(rid)["artifact_source"])
            assert again.trials == tenants[i].trials, f"tenant {i} differs from its serial replay"
    assert sources == ["disk", "memory"], sources
    log("tenants 1-2 bit-equal to a serial replay on one worker (artifact from disk)")
    shutil.rmtree(root.parent, ignore_errors=True)
    return {"warm_s": t_warm, "warmed_geometries": warm["warmed_geometries"],
            "tenants_s": t_tenants, "per_request_s": per_request, "repeat_s": t_repeat,
            "cold_s": t_cold, "cold_over_repeat": t_cold / t_repeat,
            "b1_launches": warm_state["similarity"], "captures_warm": warm_state["captures"],
            "captures_tenants": after_tenants["captures"] - warm_state["captures"],
            "repeat_new": new, "buffer_puts": puts, "store": stats["store"],
            "best": [(r.best_config, r.best_score) for r in tenants],
            "peak_mib": peak, "memory": memory, "card": smi}


def _example(sizes: dict):
    from repro_torch.data.datasets import GaussianMixtureDataset

    n, c, d = sizes["example"]
    ds = GaussianMixtureDataset(n=n, n_classes=c, dim=d, seed=0)
    tr, va, _ = ds.split()
    return ds.x[tr], ds.y[tr], ds.x[va], ds.y[va]


def _noncontiguous_refusal(dev):
    """B1's wrapper handed a non-contiguous view: its refusal."""
    from repro_torch.kernels.similarity import similarity as sk

    z = torch.ones((64, 32), device=dev)[:, ::2]
    sk.similarity_cuda(z, z)


def phase_faults(dev, *, sizes: dict) -> dict:
    """19b: faults and health on the card at the example's size."""
    from repro_torch.distributed.multihost import HeartbeatMonitor, HeartbeatWriter
    from repro_torch.health import CircuitBreaker, CircuitOpenError
    from repro_torch.kernels import _build
    from repro_torch.selection import session as S
    from repro_torch.serve import MiloClient, MiloServer, RetryPolicy
    from repro_torch.testing.faults import TransientFault, fail_nth_calls

    x, y, _, _ = _example(sizes)
    log(f"== phase 19b: faults and health on {x.shape}")
    cfg = S.MiloSessionConfig(use_pallas=True)
    orig = S.MiloSession.build_metadata
    out = {}
    try:
        S.MiloSession.build_metadata = fail_nth_calls(orig, fail_on={1})
        with MiloServer(cfg, device=dev, num_workers=1, retry_policy=RetryPolicy(
                base_delay=0.01, retry_on=(TransientFault,))) as srv:
            rid = srv.submit("preprocess", features=x, labels=y)
            assert srv.result(rid, timeout=300)["source"] == "built"
            snap = srv.poll(rid)
            assert snap["attempts"] == 2 and snap["status"] == "done", snap
            out["transient"] = {"attempts": snap["attempts"], "retries": srv.stats()["retries"]}
        log(f"a transient build failure: retried once, attempts {snap['attempts']}")

        now = [0.0]
        br = CircuitBreaker(threshold=2, cooldown=30.0, clock=lambda: now[0])
        with MiloServer(cfg, device=dev, num_workers=1, breaker=br) as srv:
            S.MiloSession.build_metadata = orig
            c = MiloClient(srv)
            assert c.preprocess(x, y)["source"] == "built"
            calls = [0]

            def broken(self, *a, **kw):
                calls[0] += 1
                raise ValueError("deterministically broken build")

            S.MiloSession.build_metadata = broken
            for _ in range(2):
                try:
                    c.preprocess(x, y, force=True)
                    raise AssertionError("the broken build succeeded")
                except ValueError:
                    pass
            try:
                c.preprocess(x, y, force=True)
                raise AssertionError("the open breaker let a build through")
            except CircuitOpenError:
                pass
            assert calls[0] == 2
            assert c.preprocess(x, y)["source"] == "memory"
            h_open = srv.health()
            assert h_open["status"] == "degraded" and len(h_open["tripped_keys"]) == 1
            S.MiloSession.build_metadata = orig
            now[0] = 30.0
            probe = c.preprocess(x, y, force=True)
            h_closed = srv.health()
            assert probe["source"] == "built" and probe["version"] == 2
            assert h_closed["status"] == "ok", h_closed
            out["breaker"] = {"builds_tried": calls[0], "open": h_open["status"],
                              "after_reset": h_closed["status"]}
        log("a deterministic build failure: the breaker opened after 2, the third failed fast, "
            "the cached key served from memory, health degraded; after the cooldown one probe "
            "build closed it and health read ok")

        def kernel_fault(self, *a, **kw):
            _noncontiguous_refusal(dev)

        S.MiloSession.build_metadata = kernel_fault
        br = CircuitBreaker(threshold=1, cooldown=1e9)
        with MiloServer(cfg, device=dev, num_workers=1, breaker=br, retry_policy=RetryPolicy(
                base_delay=0.0, retry_on=(RuntimeError, ValueError))) as srv:
            rid = srv.submit("preprocess", features=x, labels=y)
            try:
                srv.result(rid, timeout=300)
                raise AssertionError("the refused kernel launch succeeded")
            except _build.KernelInputError as e:
                err = str(e)
            snap = srv.poll(rid)
            assert snap["attempts"] == 1 and srv.stats()["retries"] == 0, snap
            assert len(srv.health()["tripped_keys"]) == 1
            out["kernel_fault"] = {"attempts": snap["attempts"], "error": err}
        log(f"a kernel wrapper's refusal ({err}): not retried (attempts 1) though retry_on names "
            "ValueError, counted by the breaker")
    finally:
        S.MiloSession.build_metadata = orig

    with tempfile.TemporaryDirectory() as hb:
        now = time.time()
        HeartbeatWriter(hb, 0).beat(step=1)
        HeartbeatWriter(hb, 1, clock=lambda: now - 120.0).beat()
        with MiloServer(cfg, device=dev, heartbeat_monitor=HeartbeatMonitor(
                hb, timeout=60.0, expected=2)) as srv:
            h = srv.health()
        assert h["status"] == "degraded" and h["hosts"]["stale"] == [1], h
        out["heartbeat"] = h["hosts"]
    log(f"one stale beacon (host 1, {h['hosts']['ages']['1']:.0f} s): health degraded")
    return out


def phase_fallback(dev, *, sizes: dict) -> dict:
    """19c: a degenerate primary falls back to ``adaptive_random``; a kernel
    wrapper's refusal in the primary propagates."""
    from repro_torch.core.metadata import MiloMetadata
    from repro_torch.health import FallbackSelector
    from repro_torch.kernels import _build
    from repro_torch.selection import MiloSession

    x, y, vx, vy = _example(sizes)
    log(f"== phase 19c: selector fallback on {x.shape}")
    session = MiloSession(use_pallas=True, total_epochs=6, lr=0.01,
                          selector_fallback=("adaptive_random",), device=dev)
    md = session.preprocess(x, y)
    # a WRE distribution with 3 rows of mass: the draw of k rows is degenerate
    probs = np.zeros_like(md.wre_probs)
    probs[:3] = 1.0 / 3
    session.adopt_metadata(MiloMetadata(md.sge_subsets, probs, md.wre_importance,
                                        md.class_labels, md.class_budgets, dict(md.config)))
    sel = session.selector(n=len(x))
    plans = [sel.plan(e) for e in range(6)]
    assert sel.active_name == "adaptive_random", sel.events
    last = plans[-1]
    assert last.provenance["fallback_from"] == "milo"
    assert last.provenance["fallback_selector"] == "adaptive_random"
    assert sel.events[0]["stage"] == "plan" and "nonzero" in sel.events[0]["error"]
    report = session.train(x, y, test_x=vx, test_y=vy)
    log(f"milo's WRE draw over 3 rows of mass fell back at epoch "
        f"{next(p.epoch for p in plans if 'fallback_from' in p.provenance)} to adaptive_random: "
        f"{sel.events[0]['error']}; training on the chain: accuracy {report.final_acc:.4f}")

    def refusing():
        class Primary:
            def plan(self, epoch):
                _noncontiguous_refusal(dev)
        return Primary()

    fb = FallbackSelector([("milo", refusing), ("adaptive_random",
                                                lambda: session.selector("adaptive_random",
                                                                         n=len(x)))])
    try:
        fb.plan(0)
        raise AssertionError("the refusal was degraded around")
    except _build.KernelInputError as e:
        err = str(e)
    assert fb.events == [] and fb.active_name == "milo"
    log(f"B1's refusal in the primary propagated ({err}); no fallback event")
    return {"fallback_events": sel.events, "acc": report.final_acc, "refusal": err}


def phase_landmarks(dev, x, y, *, sizes: dict, smi: str) -> dict:
    """19d: landmark facility location per class of phase 5's data; class 0
    against exact greedy facility location on its Gram."""
    from repro_torch.core.feature_submodular import default_landmarks, feature_greedy_select
    from repro_torch.core.greedy import greedy
    from repro_torch.core.similarity import gram_matrix
    from repro_torch.core.submodular import facility_location

    k = sizes["k_landmark"]
    log(f"== phase 19d: landmark facility location per class, k {k}")
    held = _reset_peak(dev)
    times, sel0 = [], None
    for c in np.unique(y):
        z = x[y == c]
        _sync(dev)
        t0 = time.perf_counter()
        sel = feature_greedy_select(z, k, seed=int(c), device=dev)
        idx = sel.indices.cpu().numpy()
        times.append(time.perf_counter() - t0)
        assert len(np.unique(idx)) == k and idx.min() >= 0 and idx.max() < len(z)
        assert tuple(sel.phi.shape) == (len(z), default_landmarks(len(z), k))
        if c == 0:
            sel0 = idx
        del sel
    peak = _peak_mib(dev, held)
    z0 = torch.as_tensor(x[y == 0], device=dev)
    K = gram_matrix(z0)
    t0 = time.perf_counter()
    exact = greedy(facility_location, K, k).indices
    _sync(dev)
    t_exact = time.perf_counter() - t0
    masks = {}
    for name, idx in (("exact", exact), ("landmark", torch.as_tensor(sel0, device=dev))):
        m = torch.zeros(len(z0), dtype=torch.bool, device=dev)
        m[idx] = True
        masks[name] = float(facility_location.evaluate(m, K))
    ratio = masks["landmark"] / masks["exact"]
    del K, z0
    log(f"per class (m ~{int(np.mean(np.bincount(y)))}, L {default_landmarks(int((y == 0).sum()), k)}): "
        f"{', '.join(f'{t:.3f}' for t in times)} s; {_peak_text(peak, held)}; class 0: exact FL "
        f"{masks['exact']:.3f} (greedy {t_exact:.3f} s), landmark FL {masks['landmark']:.3f}, ratio "
        f"{ratio:.4f} (>= 0.9 asserted)")
    assert ratio >= 0.9, ratio
    return {"class_s": times, "peak_mib": peak, "exact_fl": masks["exact"],
            "landmark_fl": masks["landmark"], "ratio": ratio, "exact_greedy_s": t_exact}


def phase_selection_service(dev, x, y, vx, vy, *, rehearsal: bool, smi: str) -> dict:
    """Phase 19."""
    sizes = SERVE_SIZES["rehearsal" if rehearsal else "full"]
    t0 = time.perf_counter()
    out = {"19a": phase_server(dev, x, y, vx, vy, sizes=sizes, smi=smi),
           "19b": phase_faults(dev, sizes=sizes),
           "19c": phase_fallback(dev, sizes=sizes),
           "19d": phase_landmarks(dev, x, y, sizes=sizes, smi=smi)}
    out["seconds"] = time.perf_counter() - t0
    log("phase 19 summary: " + json.dumps(out, default=str))
    return out


# ---------------------------------------------------------------------------
# phase 20: the last LM families — xlstm-125m through ServeEngine, and the
# encoder-decoder (whisper-small) and cross-attention (llama-3.2-vision)
# path with B5 on its non-causal and cross-length shapes
# ---------------------------------------------------------------------------

#: 20a's decode-vs-forward bound in f32 (relative to max |logit|): the
#: recurrent and chunked forms of the mLSTM differ only in f32 rounding
#: (the CPU tests: < 1e-5 at the smoke size)
XLSTM_F32_BOUND = 1e-3


@contextlib.contextmanager
def _flash_shapes(seen: dict):
    """Count each B5 launch that ``ops.flash_attention`` makes in ``seen``
    by its shape and instance: "(Hq/Hkv, Sq, Sk, D) causal|non-causal,
    wgmma bf16|f32"."""
    from repro_torch.kernels.flash_attention import ops as fa_ops

    orig = fa_ops.flash_attention_cuda

    def recording(q, k, v, *, causal=True, scale=None):
        out = orig(q, k, v, causal=causal, scale=scale)
        key = (f"({q.shape[1]}/{k.shape[1]}, {q.shape[2]}, {k.shape[2]}, {q.shape[3]}) "
               f"{'causal' if causal else 'non-causal'}, "
               f"{'wgmma bf16' if q.dtype == torch.bfloat16 else 'f32'}")
        seen[key] = seen.get(key, 0) + 1
        return out

    fa_ops.flash_attention_cuda = recording
    try:
        yield seen
    finally:
        fa_ops.flash_attention_cuda = orig


def _contexts(cfg, n: int, dev) -> list[torch.Tensor]:
    """One context per request, (1, Nctx, D) in the model's dtype (as a
    frontend hands it over): the frames of an encoder-decoder or the patch
    embeddings, drawn from the port's generator seeded with the request's
    index."""
    from repro_torch.models import lm

    rows = cfg.encoder_seq if cfg.is_encdec else cfg.num_context_tokens
    return [torch.randn((1, rows, cfg.d_model), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(i)).to(lm._dtype(cfg))
            for i in range(n)]


def _serve_one_by_one(dev, cfg, model, prompts, contexts, *, new_tokens: int, max_len: int,
                      keep_steps: int) -> tuple[dict, dict]:
    """Each request alone at batch 1: ``lm.prefill`` with its context, then
    ``new_tokens - 1`` greedy ``lm.decode_step``s, timed with the card
    synchronised.  B5's launches are counted by shape and instance, prefill
    and decode apart; request 0's prefill logits, first ``keep_steps``
    decode logits and fed tokens are kept for the checks."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import lm

    times = {"prefill": [], "decode": []}
    shapes: dict[str, dict] = {"prefill": {}, "decode": {}}
    kept: dict = {}
    _reset_launches()
    fa_ops.copies = 0
    held = _reset_peak(dev)
    t_all = time.perf_counter()
    for i, (prompt, ctx) in enumerate(zip(prompts, contexts)):
        caches = lm.init_caches(cfg, 1, max_len, dev)
        tok = torch.as_tensor(prompt[None], device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        with torch.no_grad(), _flash_shapes(shapes["prefill"]):
            logits, caches = lm.prefill(model, cfg, tok, caches, context=ctx)
        nxt = int(torch.argmax(logits[0, -1]))
        times["prefill"].append(time.perf_counter() - t0)
        fed, rows = [nxt], []
        for j in range(new_tokens - 1):
            t0 = time.perf_counter()
            with torch.no_grad(), _flash_shapes(shapes["decode"]):
                out, caches = lm.decode_step(model, cfg, torch.tensor([[nxt]], device=dev), caches,
                                             len(prompt) + j, context=ctx)
            nxt = int(torch.argmax(out[0, -1]))
            times["decode"].append(time.perf_counter() - t0)
            fed.append(nxt)
            if i == 0 and j < keep_steps:
                rows.append(out[0, -1])
        if i == 0:
            kept = dict(prefill=logits[0], decode=torch.stack(rows), fed=fed[:keep_steps])
        del logits, caches
    _sync(dev)
    wall = time.perf_counter() - t_all
    decoded = len(times["decode"])
    out = dict(prefill_s=times["prefill"], decode_median_ms=float(np.median(times["decode"])) * 1e3,
               decode_tokens_per_s=decoded / sum(times["decode"]), wall_s=wall,
               peak_mib=_peak_mib(dev, held), held_mib=held, launches=fa.launches,
               shapes=shapes, copies=fa_ops.copies)
    log(f"{cfg.name}: {len(prompts)} requests at batch 1 (prompts {[len(p) for p in prompts]}, "
        f"{new_tokens} new tokens each) in {wall:.3f} s wall")
    log(f"  prefill per request (s): {[round(t, 4) for t in times['prefill']]}")
    log(f"  decode steps: {decoded}, median {out['decode_median_ms']:.2f} ms, "
        f"{out['decode_tokens_per_s']:.1f} tokens/s")
    log(f"  B5 launches {fa.launches}: prefill {shapes['prefill']}; decode {shapes['decode']}; "
        f"copies {fa_ops.copies}; {_peak_text(out['peak_mib'], held)}")
    assert fa_ops.copies == 0, "the context comes in the model's dtype: no copy"
    return out, kept


def _decode_against_full(dev, cfg, plain, model, prompt, ctx, kept, label: str) -> dict:
    """Request 0: its prefill logits on the kernel route against the plain
    route's, and its decode logits against the plain route's full forward
    over the prompt and the fed tokens (bf16 bound 0.02, the LM phases')."""
    from repro_torch.models import lm

    P = len(prompt)
    seq = torch.as_tensor(np.concatenate([prompt, kept["fed"]]), device=dev)[None]
    with torch.no_grad():
        full, _ = lm.forward(model, plain, seq, context=ctx)
    full = full[0]
    rels = [_rel(kept["decode"][j], full[P + j]) for j in range(len(kept["fed"]))]
    pre = _rel(kept["prefill"], full[:P])
    log(f"{label} request 0: decode (kernel route, {len(rels)} steps after a {P}-token prefill) "
        f"against the plain route's full forward: relative max error per step "
        f"{[f'{r:.2e}' for r in rels]}; prefill logits kernel against plain {pre:.2e} (bound 0.02)")
    assert max(rels) < 0.02 and pre < 0.02, (rels, pre)
    return {"decode_rel": rels, "prefill_rel": pre}


def phase_xlstm(dev, *, rehearsal: bool) -> dict:
    """20a: xlstm-125m at full width and depth through ``ServeEngine``."""
    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.models.ssm import mlstm, slstm

    log("== phase 20a: xlstm-125m serving (ServeEngine; mLSTM and sLSTM, no kernel of the table)")
    cfg = registry.smoke("xlstm-125m") if rehearsal else registry.get("xlstm-125m")
    traffic = dict(n=8, lo=8, hi=40) if rehearsal else dict(n=8, lo=256, hi=2048)
    size = (dict(new_tokens=6, max_batch=4, max_len=64) if rehearsal
            else dict(new_tokens=32, max_batch=4, max_len=2304))
    prompts = serve_traffic(cfg.vocab_size, **traffic)
    run = phase_serve(dev, cfg, cfg.name, prompts, **size)
    assert run["launches"]["flash_attention"] == run["launches"]["ssd_chunk"] == 0, run["launches"]
    # request 0's decode (the recurrent forms) against the full forward (the
    # chunked mLSTM scan): in bf16 at this width the two forms part by more
    # than the LM phases' 0.02 — the reference's own bf16 gap does too
    # (tests/test_torch_xlstm.py::test_full_width_bf16_decode_gap_is_the_references)
    # — so the bf16 gap is reported and the check is held on the same
    # weights in f32, where the two forms compute the same function
    steps = min(8, size["new_tokens"] - 1)
    P = len(prompts[0])
    rels = {}
    f32 = dataclasses.replace(cfg, dtype="float32")
    for dtype, c, m in (("bfloat16", cfg, run["model"]),
                        ("float32", f32, T.map(lambda t: t.float(), run["model"]))):
        with torch.no_grad():
            _, dec, fed = _greedy_run(m, c, prompts[0], steps, size["max_len"], dev)
            full, _ = lm.forward(m, c, torch.as_tensor(np.concatenate([prompts[0], fed]),
                                                       device=dev)[None])
        rels[dtype] = [_rel(dec[j], full[0, P + j]) for j in range(steps)]
        del m, full
    log(f"xlstm-125m request 0: decode ({steps} steps after a {P}-token prefill) against the full "
        f"forward, relative max error per step: bf16 {[f'{r:.2e}' for r in rels['bfloat16']]} "
        f"(reported); f32 {[f'{r:.2e}' for r in rels['float32']]} (bound {XLSTM_F32_BOUND})")
    assert max(rels["float32"]) < XLSTM_F32_BOUND, rels
    # what each mixer costs at request 0's prefill (CUDA events around 3
    # calls after one: the sLSTM's time is its host loop over the tokens)
    mixers = {}
    if dev.type == "cuda":
        layers = lm.layer_params(run["model"], cfg)
        h = torch.randn((1, P, cfg.d_model), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(20)).to(torch.bfloat16)
        for name, fn in (("mlstm", mlstm), ("slstm", slstm)):
            i = next(j for j, (m, _) in enumerate(lm.layer_kinds(cfg)) if m == name)
            kw = dict(chunk=cfg.ssm_chunk) if name == "mlstm" else {}
            with torch.no_grad():
                mixers[name] = cuda_ms(lambda: fn(layers[i]["mixer"], h, mode="prefill", **kw),
                                       iters=3, warmup=1)
        n_of = {m: sum(1 for k, _ in lm.layer_kinds(cfg) if k == m) for m in mixers}
        log(f"xlstm-125m mixers at a {P}-token prefill: mLSTM {mixers['mlstm']:.2f} ms a layer "
            f"(x {n_of['mlstm']}), sLSTM {mixers['slstm']:.2f} ms a layer (x {n_of['slstm']}; "
            f"{mixers['slstm'] / P * 1e3:.1f} us a token of its loop)")
    decoded = sum(len(r.generated) - 1 for r in run["done"])
    out = dict(prefill_s=run["prefill_s"], decode_median_ms=float(np.median(run["decode_s"])) * 1e3,
               decode_tokens_per_s=decoded / sum(run["decode_s"]), wall_s=run["wall"],
               peak_gib=None if run["peak"] is None else run["peak"] / 2**30,
               launches=run["launches"], decode_rel=rels, mixer_prefill_ms=mixers)
    del run
    return out


def phase_encdec(dev, *, rehearsal: bool) -> dict:
    """20b: whisper-small at full width and depth, 4 requests one by one."""
    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.models import lm

    log("== phase 20b: whisper-small (encoder-decoder, attention_impl='pallas')")
    base = registry.smoke("whisper-small") if rehearsal else registry.get("whisper-small")
    cfg = dataclasses.replace(base, attention_impl="pallas")
    plain = dataclasses.replace(cfg, attention_impl="naive")
    prompts = serve_traffic(cfg.vocab_size, n=4, lo=8 if rehearsal else 32,
                            hi=16 if rehearsal else 448)
    new_tokens, max_len = (6, 32) if rehearsal else (32, 512)
    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed=0, device=dev)
    _sync(dev)
    log(f"whisper-small: {sum(p.numel() for p in T.leaves(model)) / 1e9:.3f} B parameters "
        f"({cfg.encoder_layers} encoder layers, {cfg.num_layers} decoder blocks, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}), built in "
        f"{time.perf_counter() - t0:.1f} s")
    contexts = _contexts(cfg, len(prompts), dev)
    run, kept = _serve_one_by_one(dev, cfg, model, prompts, contexts, new_tokens=new_tokens,
                                  max_len=max_len, keep_steps=min(8, new_tokens - 1))
    n_self = sum(1 for m, _ in lm.layer_kinds(cfg) if m == "attn")
    n_cross = sum(1 for m, _ in lm.layer_kinds(cfg) if m == "xattn")
    expected = {"prefill": len(prompts) * (cfg.encoder_layers + n_self + n_cross),
                "decode": len(prompts) * (new_tokens - 1) * (cfg.encoder_layers + n_cross)}
    got = {k: sum(v.values()) for k, v in run["shapes"].items()}
    log(f"  B5 launches expected (encoder {cfg.encoder_layers} + self {n_self} + cross {n_cross} "
        f"a prefill, encoder + cross a decode step): {expected}; made {got}")
    if dev.type == "cuda":
        assert got == expected and run["launches"] == sum(expected.values()), (got, expected)
    checks = _decode_against_full(dev, cfg, plain, model, prompts[0], contexts[0], kept,
                                  "whisper-small")
    with torch.no_grad():
        frames = contexts[0]
        enc_k = lm.run_encoder(model, cfg, frames)
        enc_p = lm.run_encoder(model, plain, frames)
    checks["encoder_rel"] = _rel(enc_k, enc_p)
    log(f"whisper-small encoder output (1, {cfg.encoder_seq}, {cfg.d_model}), kernel route against "
        f"plain: relative max error {checks['encoder_rel']:.2e} (bound 0.02)")
    assert checks["encoder_rel"] < 0.02, checks
    del model, kept
    return dict(run, expected=expected, checks=checks)


def phase_cross_attention(dev, *, rehearsal: bool) -> dict:
    """20c: one period of llama-3.2-vision's pattern (4 attn + 1 xattn) at
    published widths, 4 requests one by one against 1,601 patch tokens."""
    from repro_torch import tree as T
    from repro_torch.configs import registry
    from repro_torch.models import lm
    from repro_torch.models.attention import attention
    from repro_torch.models.layers import rms_norm

    log("== phase 20c: llama-3.2-vision, one period of 5 layers (cross-attention, "
        "attention_impl='pallas')")
    base = registry.get("llama-3.2-vision-90b")
    # one period of the pattern: depth 100 -> 5 (100 layers are ~88 B
    # parameters, ~176 GB in bf16, over the card's 80 GB)
    cfg = dataclasses.replace(registry.smoke(base) if rehearsal else base,
                              num_layers=len(base.pattern), attention_impl="pallas")
    plain = dataclasses.replace(cfg, attention_impl="naive")
    prompts = serve_traffic(cfg.vocab_size, n=8, lo=8 if rehearsal else 256,
                            hi=40 if rehearsal else 2048)[:4]
    new_tokens, max_len = (6, 64) if rehearsal else (32, 2304)
    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed=0, device=dev)
    _sync(dev)
    log(f"llama-3.2-vision (one period): {sum(p.numel() for p in T.leaves(model)) / 1e9:.3f} B "
        f"parameters ({cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads}/"
        f"{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), "
        f"built in {time.perf_counter() - t0:.1f} s")
    contexts = _contexts(cfg, len(prompts), dev)
    run, kept = _serve_one_by_one(dev, cfg, model, prompts, contexts, new_tokens=new_tokens,
                                  max_len=max_len, keep_steps=min(8, new_tokens - 1))
    n_self = sum(1 for m, _ in lm.layer_kinds(cfg) if m == "attn")
    n_cross = sum(1 for m, _ in lm.layer_kinds(cfg) if m == "xattn")
    expected = {"prefill": len(prompts) * (n_self + n_cross),
                "decode": len(prompts) * (new_tokens - 1) * n_cross}
    got = {k: sum(v.values()) for k, v in run["shapes"].items()}
    log(f"  B5 launches expected (self {n_self} + cross {n_cross} a prefill, cross a decode "
        f"step): {expected}; made {got}")
    if dev.type == "cuda":
        assert got == expected and run["launches"] == sum(expected.values()), (got, expected)
    checks = _decode_against_full(dev, cfg, plain, model, prompts[0], contexts[0], kept,
                                  "llama-3.2-vision")
    # the cross-attention sublayer alone on request 0's prompt and on one
    # query, kernel route against plain, the counterpart of 20b's encoder
    block = next(b for b, (m, _) in zip(lm.layer_params(model, cfg), lm.layer_kinds(cfg))
                 if m == "xattn")
    tok = torch.as_tensor(prompts[0][None], device=dev)
    with torch.no_grad():
        h = rms_norm(model["embed"][tok], block["norm1"], cfg.norm_eps)
        rels = []
        for x in (h, h[:, -1:]):
            pos = torch.arange(x.shape[1], device=dev)[None]
            y = [attention(block["mixer"], x, pos, causal=False, impl=impl, use_rope=False,
                           kv_x=contexts[0])[0] for impl in ("pallas", "naive")]
            rels.append(_rel(*y))
    checks["xattn_rel"] = rels
    log(f"llama-3.2-vision cross-attention sublayer, kernel route against plain: relative max "
        f"error {rels[0]:.2e} ({len(prompts[0])} queries), {rels[1]:.2e} (1 query) (bound 0.02)")
    assert max(rels) < 0.02, rels
    del model, kept
    return dict(run, expected=expected, checks=checks)


def phase_last_families(dev, *, rehearsal: bool, smi: str) -> dict:
    """Phase 20: xlstm-125m, whisper-small and one llama-3.2-vision period."""
    log(f"== phase 20: the last LM families on {smi}")
    t0 = time.perf_counter()
    out = {}
    for key, fn in (("20a", phase_xlstm), ("20b", phase_encdec), ("20c", phase_cross_attention)):
        t = time.perf_counter()
        out[key] = fn(dev, rehearsal=rehearsal)
        out[key]["seconds"] = time.perf_counter() - t
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    out["smi"] = smi
    log("phase 20 summary: " + json.dumps(out, default=str))
    return out


# ---------------------------------------------------------------------------
# phase 21: multi-device selection and multi-host execution — the sharded
# engines on torch.distributed (one rank on NCCL; two ranks on the one card
# through gloo), int8 compression and its integrity check, two-host
# training with two-phase checkpoints, a killed host and the restart
# ---------------------------------------------------------------------------

# 21b runs over the first ``classes`` classes: a lazy step of two ranks
# sharing the card makes four gloo collectives, each staged through host
# memory (8.25 ms a step, ~42 s a class on an H100's host), so all 10
# classes would take ~7 minutes (PERF.md section 4 lists the cut).  Two
# classes, not one: with one partition the preprocessor does not bucket,
# and phase 7's artifact (bucketed) would not be the one to compare with
PHASE21_SIZES = {"full": dict(classes=2, k_sharded=512, k_c8=64, mf_rows=4096, mf_k=256,
                              epochs=2, ckpt_every=64, kill_step=200, barrier_timeout=8.0,
                              launch_timeout=300.0),
                 "rehearsal": dict(classes=4, k_sharded=16, k_c8=16, mf_rows=128, mf_k=16,
                                   epochs=6, ckpt_every=4, kill_step=10, barrier_timeout=10.0,
                                   launch_timeout=120.0)}

#: the child processes of phase 21: ``phase21_child`` of this file
PHASE21_CHILD = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
                 "sys.exit(chip_smoke.phase21_child(sys.argv[2:]))")


def _phase21_device() -> torch.device:
    return torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")


def _class_rows(x, y, c: int, dev) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Class ``c``'s ground set as the preprocessor builds it: row-normalised
    features, zero rows up to the power-of-two bucket; the valid mask; n_c."""
    from repro_torch.core.milo import _next_pow2
    from repro_torch.core.similarity import normalize_rows

    feats = torch.as_tensor(x[y == c], device=dev)
    n_c = feats.shape[0]
    n_pad = _next_pow2(n_c)
    z = torch.zeros((n_pad, feats.shape[1]), dtype=torch.float32, device=dev)
    z[:n_c] = normalize_rows(feats.float())
    return z, torch.arange(n_pad, device=dev) < n_c, n_c


@contextlib.contextmanager
def _lazy_traces(progress=None):
    """Record every ``lazy_greedy`` pass: (result, the global n — a rank's
    ground rows are n / ranks); ``progress(i, seconds)`` after each pass."""
    from repro_torch.core import greedy as greedy_mod

    runs: list = []
    orig = greedy_mod.lazy_greedy

    def recorded(fn, K, k, **kwargs):
        t0 = time.perf_counter()
        res = orig(fn, K, k, **kwargs)
        runs.append((res, kwargs.get("n") or K.shape[0]))
        if progress is not None:
            progress(len(runs) - 1, time.perf_counter() - t0)
        return res

    greedy_mod.lazy_greedy = recorded
    try:
        yield runs
    finally:
        greedy_mod.lazy_greedy = orig


def _launch_counts() -> dict:
    from repro_torch.kernels.fl_gains import fl_gains as fk

    return {"fl_gains_gram_free": fk.launches["fl_gains_gram_free"],
            "fl_gains_gram_free_delta": fk.launches["fl_gains_gram_free_delta"],
            "instances": _selection_launches()}


def _phase21_select(data_path: str, out_dir: str, sizes: dict) -> int:
    """21b and 21c, on every rank: the session's preprocess over every class
    with ``shard_selection`` (``multihost_init`` starts the process group),
    ``milo_fixed(shard_selection=True)``, then class 0's facility location
    with int8 compression and one corrupted payload."""
    from repro_torch.core import sharded as sharded_mod
    from repro_torch.distributed import multihost
    from repro_torch.distributed.compression import CompressionIntegrityError
    from repro_torch.distributed.sharding import selection_mesh
    from repro_torch.selection import MiloSession, build_selector
    from repro_torch.testing.faults import flip_payload_byte

    dev = _phase21_device()
    t_start = time.perf_counter()

    def note(*args) -> None:   # progress on stderr: a launch cut at its timeout still shows it
        print(f"[{time.perf_counter() - t_start:8.2f} s]", *args, file=sys.stderr, flush=True)

    session = MiloSession(total_epochs=12, lr=0.01, device=dev, multihost_init=True,
                          shard_selection=True, **GRAM_FREE_PATH)
    rank, mesh = multihost.process_index(), selection_mesh()
    assert multihost.is_initialized() and mesh.size == 2 and mesh.backend == "gloo", mesh
    with np.load(data_path) as f:
        x, y = f["x"], f["y"]
    keep = y < sizes["classes"]
    stats: dict = {"rank": rank, "mesh": repr(mesh), "start_s": time.perf_counter() - t_start,
                   "classes": sizes["classes"]}
    note(f"rank {rank} of {mesh}: started")
    # 21b: the artifact over the first ``classes`` classes
    _reset_launches()
    mesh.reset_counts()
    held = _reset_peak(dev)
    with _stage_times(sharded_mod, {"sge": "sharded_sge", "wre": "sharded_greedy_importance"},
                      dev) as times, \
            _lazy_traces(lambda i, dt: note(f"class {i}: WRE pass {dt:.2f} s")) as runs:
        t0 = time.perf_counter()
        md = session.preprocess(x[keep], y[keep])
        _sync(dev)
        stats["preprocess_s"] = time.perf_counter() - t0
    note(f"preprocess {stats['preprocess_s']:.2f} s")
    stats.update(stage_s=dict(times), launches=_launch_counts(), peak_mib=_peak_mib(dev, held),
                 hops=mesh.hops, collectives=mesh.collectives, staged_calls=mesh.staged_calls,
                 staged_bytes=mesh.staged_bytes)
    stats["lazy"] = _lazy_summary(runs, times.get("wre", 0.0))
    arrays = {"sge": md.sge_subsets, "imp": md.wre_importance, "probs": md.wre_probs,
              "budgets": md.class_budgets}
    for c, (r, n) in enumerate(runs):
        arrays[f"traj_idx_{c}"] = r.indices.cpu().numpy()
        arrays[f"traj_gains_{c}"] = r.gains.cpu().numpy()
    assert stats["launches"]["fl_gains_gram_free"] > 0 or dev.type == "cpu", stats["launches"]
    # milo_fixed with shard_selection: sharded disparity-min
    mf = x[y == 0][:sizes["mf_rows"]]
    arrays["milo_fixed"] = build_selector("milo_fixed", features=mf, k=sizes["mf_k"],
                                          shard_selection=True, device=dev).plan(0).indices
    # 21c: int8 compression on class 0, then one payload corrupted in flight
    z, valid, n_c = _class_rows(x, y, 0, dev)
    exact = sharded_mod.make_sharded_gram_free("facility_location", mesh=mesh,
                                               use_pallas=True)
    comp = sharded_mod.make_sharded_gram_free("facility_location", mesh=mesh,
                                              use_pallas=True, compress="int8", compress_rounds=2)
    k = sizes["k_c8"]
    t0 = time.perf_counter()
    e = sharded_mod.sharded_greedy(exact, z, k, mesh=mesh, valid=valid)
    _sync(dev)
    t_e = time.perf_counter() - t0
    t0 = time.perf_counter()
    c8 = sharded_mod.sharded_greedy(comp, z, k, mesh=mesh, valid=valid)
    _sync(dev)
    stats["c8"] = {"exact_s": t_e, "compressed_s": time.perf_counter() - t0, "k": k}
    arrays.update(c8_idx=c8.indices.cpu().numpy(), c8_gains=c8.gains.cpu().numpy(),
                  exact_idx=e.indices.cpu().numpy(), exact_gains=e.gains.cpu().numpy())
    hook = flip_payload_byte(at_call=sharded_mod._payload_calls + 5, process=1, index=7)
    sharded_mod.payload_hook = hook
    try:
        sharded_mod.sharded_greedy(comp, z, 16, mesh=mesh, valid=valid)
        stats["corrupt"] = "no error"
    except CompressionIntegrityError as err:
        stats["corrupt"] = type(err).__name__
        stats["corrupt_message"] = str(err)[:120]
    finally:
        sharded_mod.payload_hook = None
    stats["corrupt_fired"] = hook.fired
    stats["seconds"] = time.perf_counter() - t_start
    note(f"done: 21c {stats['c8']}, corrupted payload: {stats['corrupt']}")
    np.savez(Path(out_dir) / f"select.{rank}.npz", **arrays)
    with open(Path(out_dir) / f"select.{rank}.json", "w") as f:
        json.dump(stats, f, default=str)
    print("PHASE21_SELECT_DONE", rank, flush=True)
    return 0


def _phase21_train(mode: str, data_path: str, ckpt: str, hb: str, out: str, sizes: dict,
                   dev: torch.device | None = None) -> dict:
    """21d: phase 14's classifier (d from the data, hidden 64, 4 sub-steps,
    lr 0.01) on ``adaptive_random`` (k = 10% of the rows), batch 32, on the
    step loop with heartbeats and two-phase checkpoints; ``mode == "kill"``
    plants ``KillHost`` on rank 1.  Run by ``launch_hosts`` children (the
    env triplet starts the group) and, with no env, as one process."""
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.distributed import multihost
    from repro_torch.selection import build_selector
    from repro_torch.selection import session as S
    from repro_torch.train.trainer import Trainer, TrainerConfig

    dev = dev or _phase21_device()
    multihost.initialize(timeout=60.0, device=dev)
    with np.load(data_path) as f:
        x, y = f["x"], f["y"]
    n, d = x.shape
    k = max(1, int(round(0.1 * n)))
    sel = build_selector("adaptive_random", n=n, k=k, R=1, seed=3)
    pipe = Pipeline(None, sel, 32, seed=1, arrays={"x": x, "y": y}, device=dev)
    total = sizes["epochs"] * pipe.steps_per_epoch()
    tr = Trainer(S._classifier_step_fn(4), pipe,
                 TrainerConfig(epochs=sizes["epochs"], checkpoint_dir=ckpt,
                               checkpoint_every_steps=sizes["ckpt_every"], async_checkpoint=False,
                               log_every_steps=1, barrier_timeout=sizes["barrier_timeout"],
                               heartbeat_dir=None if hb == "none" else hb,
                               heartbeat_timeout=300.0))
    if mode == "kill":
        from repro_torch.testing.faults import KillHost

        tr.monitor = KillHost(sizes["kill_step"], process_to_kill=1)
    t0 = time.perf_counter()
    state = tr.fit(S._init_classifier(0, d, int(y.max()) + 1, 64, 0.01, total, dev), resume=True)
    _sync(dev)
    seconds = time.perf_counter() - t0
    flat = {f"p_{key}": v.detach().cpu().numpy() for key, v in state.params.items()}
    flat.update({f"m_{key}": v.cpu().numpy() for key, v in state.mom.items()})
    rank = multihost.process_index()
    np.savez(f"{out}.{rank}.npz", step=int(state.step), **flat)
    print("PHASE21_TRAIN_DONE", rank, int(state.step), flush=True)
    return {"seconds": seconds, "steps": int(state.step), "spe": pipe.steps_per_epoch(),
            "ckpt_save_s": tr.ckpt.last_save.get("write_s") if tr.ckpt else None}


def phase21_child(argv: list[str]) -> int:
    """Entry point of phase 21's child processes (see ``PHASE21_CHILD``)."""
    role, sizes = argv[0], json.loads(argv[1])
    if role == "select":
        return _phase21_select(argv[2], argv[3], sizes)
    if role == "train":
        _phase21_train(argv[2], argv[3], argv[4], argv[5], argv[6], sizes)
        return 0
    raise ValueError(role)


def _launch(role: str, args: list[str], sizes: dict, *, timeout: float) -> tuple[list, float]:
    """Two ranks of ``phase21_child`` through the port's ``launch_hosts``."""
    from repro_torch.testing.faults import launch_hosts

    env = {"PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "4"}
    t0 = time.perf_counter()
    res = launch_hosts(PHASE21_CHILD, [str(ROOT), role, json.dumps(sizes), *args],
                       num_processes=2, env=env, cwd=str(ROOT), timeout=timeout)
    return res, time.perf_counter() - t0


def _class_banks(sge: np.ndarray, labels: np.ndarray, budgets) -> list[np.ndarray]:
    """Each class's bank in local (within-class) indices: the merged bank
    holds class c's k_c columns after the classes before it."""
    out, off = [], 0
    for c, k_c in enumerate(np.asarray(budgets).tolist()):
        rows = np.flatnonzero(labels == c)
        out.append(np.searchsorted(rows, sge[:, off:off + k_c]))
        off += k_c
    return out


def _first_parting(a: np.ndarray, b: np.ndarray, ga: np.ndarray, gb: np.ndarray) -> dict:
    parted = np.nonzero(a != b)[0]
    if not len(parted):
        return {"step": None}
    t = int(parted[0])
    return {"step": t, "gap": abs(float(ga[t]) - float(gb[t])),
            "bound": 4 * float(np.spacing(np.float32(gb[0]))) + 1e-5 * abs(float(gb[t]))}


def phase_sharded_one_rank(dev, x, y, *, sizes: dict) -> dict:
    """21a: the sharded engines on one rank whose collectives are real NCCL
    calls on the card (gloo on the CPU): bit-equal to the single-device port."""
    from repro_torch.core import greedy as greedy_mod
    from repro_torch.core import gram_free as gf
    from repro_torch.core import sharded as sharded_mod
    from repro_torch.distributed.sharding import selection_mesh

    dist = torch.distributed
    backend = "nccl" if dev.type == "cuda" else "gloo"
    log(f"== phase 21a: the sharded engines on one {backend} rank, class 0")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = selection_mesh()
        assert mesh.size == 1 and mesh.group is not None and mesh.backend == backend, mesh
        z, valid, n_c = _class_rows(x, y, 0, dev)
        n = z.shape[0]
        k = sizes["k_sharded"]
        budget = max(1, int(n * 0.125))
        fl = gf.make_gram_free_facility_location(use_pallas=True)
        fl_sh = sharded_mod.make_sharded_gram_free("facility_location", mesh=mesh,
                                                   use_pallas=True)
        sh = {name: sharded_mod.make_sharded_gram_free(name, mesh=mesh)
              for name in ("graph_cut", "disparity_min")}
        gen = lambda: torch.Generator(device=dev).manual_seed(0)  # noqa: E731
        # the single-device port first; then the sharded engines alone, their
        # own B2 / B3 launches and collectives counted from 0
        single = {}
        for name in ("graph_cut", "disparity_min"):
            a = greedy_mod.greedy(gf.get_gram_free(name), z, k, valid=valid)
            single[f"greedy {name}"] = (a.indices, a.gains)
        a = greedy_mod.sge(gf.get_gram_free("graph_cut"), z, k, n_subsets=8, valid=valid,
                           generator=gen())
        single["sge bank"] = (a, a.float())
        a = greedy_mod.lazy_greedy(fl, z, k, budget=budget, valid=valid)
        single["lazy facility location"] = (a.indices, a.gains)
        a = greedy_mod.greedy_importance(fl, z, valid=valid, lazy_budget=budget,
                                         lazy_two_level=True)
        single["importance (lazy, two-level)"] = (a, a)
        _sync(dev)
        _reset_launches()
        mesh.reset_counts()
        t0 = time.perf_counter()
        sharded = {}
        for name in ("graph_cut", "disparity_min"):
            b = sharded_mod.sharded_greedy(sh[name], z, k, mesh=mesh, valid=valid)
            sharded[f"greedy {name}"] = (b.indices, b.gains)
        b = sharded_mod.sharded_sge(sh["graph_cut"], z, k, n_subsets=8, mesh=mesh, valid=valid,
                                    generator=gen())
        sharded["sge bank"] = (b, b.float())
        b = sharded_mod.sharded_lazy_greedy(fl_sh, z, k, budget=budget, mesh=mesh, valid=valid)
        sharded["lazy facility location"] = (b.indices, b.gains)
        b = sharded_mod.sharded_greedy_importance(fl_sh, z, mesh=mesh, valid=valid,
                                                  lazy_budget=budget, lazy_two_level=True)
        sharded["importance (lazy, two-level)"] = (b, b)
        _sync(dev)
        seconds = time.perf_counter() - t0
        launches = _launch_counts()
        pairs = {label: single[label] + sharded[label] for label in single}
        for label, (ai, ag, bi, bg) in pairs.items():
            _bit_equal(f"21a {label}: indices", ai, bi)
            _bit_equal(f"21a {label}: values", ag, bg)
        counts = dict(collectives=mesh.collectives, hops=mesh.hops,
                      staged_calls=mesh.staged_calls)
        log(f"21a: {len(pairs)} engine runs on n {n} ({n_c} live), k {k}, lazy budget {budget}: "
            f"bit-equal to the single-device port; {counts['collectives']} {backend} collectives "
            f"(0 ring hops at one rank, {counts['staged_calls']} staged); the sharded engines' "
            f"B2 and B3 launches {launches['fl_gains_gram_free']} / "
            f"{launches['fl_gains_gram_free_delta']}; {seconds:.3f} s")
        assert counts["staged_calls"] == 0 and counts["collectives"] > 0, counts
        if dev.type == "cuda":
            assert launches["fl_gains_gram_free"] > 0 and launches["fl_gains_gram_free_delta"] > 0
    finally:
        dist.destroy_process_group()
    return {"seconds": seconds, "n": n, "live": n_c, "k": k, "budget": budget,
            "launches": launches, **counts}


def phase_sharded_two_ranks(dev, x, y, gf7: dict, *, sizes: dict, work: Path) -> dict:
    """21b and 21c: two ranks on the one card (gloo: NCCL refuses two ranks
    on one GPU), every CUDA tensor staged through host memory."""
    from repro_torch.distributed import multihost
    from repro_torch.selection import build_selector

    log(f"== phase 21b: two ranks (launch_hosts, gloo, staged) run MiloSession(shard_selection="
        f"True, multihost_init=True) over the first {sizes['classes']} classes of phase 7's data")
    if dev.type == "cuda" and torch.cuda.device_count() < 2:
        try:
            multihost.choose_backend("nccl", 2)
            raise AssertionError("NCCL for two ranks on one card did not raise")
        except ValueError as e:
            log(f"NCCL asked for two ranks on one card raises: {str(e)[:90]}...")
    data = work / "data.npz"
    np.savez(data, x=x, y=y)
    res, wall = _launch("select", [str(data), str(work)], sizes,
                        timeout=sizes["launch_timeout"])
    for r in res:
        assert r.returncode == 0, (r.process_id, r.returncode, r.stderr[-4000:])
        assert "PHASE21_SELECT_DONE" in r.stdout
    for line in res[0].stderr.splitlines():
        if line.startswith("["):
            log(f"  rank 0 {line}")
    stats = [json.load(open(work / f"select.{i}.json")) for i in range(2)]
    arrs = [dict(np.load(work / f"select.{i}.npz")) for i in range(2)]
    for key in arrs[0]:
        _bit_equal(f"21b rank 0 against rank 1: {key}", torch.from_numpy(arrs[0][key]),
                   torch.from_numpy(arrs[1][key]))
    log(f"launch of 2 ranks: {wall:.1f} s wall; the two ranks' artifacts, trajectories and "
        f"21c results bit-equal")
    md7 = gf7["md"]
    a = arrs[0]
    classes = sizes["classes"]
    keep = y < classes
    y_sub = y[keep]
    banks7 = _class_banks(md7.sge_subsets, y, md7.class_budgets)
    banks = _class_banks(a["sge"], y_sub, a["budgets"])
    bank = {"equal": True, "classes": classes}
    for c in range(classes):
        w = min(banks[c].shape[1], banks7[c].shape[1])
        diff = np.argwhere(banks[c][:, :w] != banks7[c][:, :w])
        if len(diff):
            bank.update(equal=False, cls=c, first=diff[0].tolist(), differing=int(len(diff)))
            break
    partings = []
    for c in range(classes):
        idx7, g7 = gf7["trajectories"][c]
        partings.append(_first_parting(a[f"traj_idx_{c}"], idx7, a[f"traj_gains_{c}"], g7))
    for c, p in enumerate(partings):
        if p["step"] is not None:
            assert p["gap"] <= p["bound"], f"class {c}: parts from phase 7 at a clear gap {p}"
    imp7 = md7.wre_importance[keep]
    for c in range(classes):
        m = y_sub == c
        np.testing.assert_allclose(np.sort(a["imp"][m]), np.sort(imp7[m]), rtol=1e-5, atol=1e-5)
    imp_diff = float(np.abs(a["imp"] - imp7).max())
    bank_equal = bank["equal"]
    log(f"21b over classes 0-{classes - 1} against phase 7 (one process): SGE bank per class "
        f"{'equal' if bank_equal else bank}; WRE "
        f"trajectories part at {[p['step'] for p in partings]} (gap <= 4 ulps of the first gain "
        f"+ rtol 1e-5: {[round(p['gap'], 9) if p['step'] is not None else None for p in partings]});"
        f" importance max |diff| {imp_diff:.3e}, sorted per class within rtol 1e-5")
    assert bank_equal, f"the SGE bank parts from phase 7's: {bank}"
    # milo_fixed: the single-device disparity-min indices
    mf = x[y == 0][:sizes["mf_rows"]]
    one = build_selector("milo_fixed", features=mf, k=sizes["mf_k"], gram_free=True,
                         device=dev).plan(0).indices
    np.testing.assert_array_equal(a["milo_fixed"], one)
    log(f"milo_fixed(shard_selection=True) on {len(mf)} rows, k {sizes['mf_k']}: the "
        "single-device disparity-min indices")
    for s in stats:
        la = s["launches"]
        peak = "not measured" if s["peak_mib"] is None else f"{s['peak_mib']:.1f} MiB"
        log(f"rank {s['rank']}: preprocess {s['preprocess_s']:.3f} s (SGE {s['stage_s']['sge']:.3f}"
            f", WRE {s['stage_s']['wre']:.3f} s; {s['lazy']['steps']} lazy-engine steps, "
            f"{s['lazy']['us_per_step']:.1f} us each); B2 {la['fl_gains_gram_free']} "
            f"({la['instances']['fl_gains_gram_free']}), B3 {la['fl_gains_gram_free_delta']} "
            f"({la['instances']['fl_gains_gram_free_delta']}); ring hops {s['hops']}, "
            f"collectives {s['collectives']}, staged {s['staged_calls']} calls / "
            f"{s['staged_bytes'] / 2**20:.1f} MiB; peak {peak} (phase 7: {gf7['peak_mib']}); "
            f"process start to done {s['seconds']:.1f} s")
        if dev.type == "cuda":
            assert la["fl_gains_gram_free"] > 0 and la["fl_gains_gram_free_delta"] > 0, la
            assert s["staged_calls"] > 0, "gloo on the card stages every collective"
        assert s["hops"] > 0
    log(f"phase 7 (one process): preprocess {gf7['preprocess_s']:.3f} s (SGE "
        f"{gf7['stage_s']['sge']:.3f}, WRE {gf7['stage_s']['wre']:.3f} s)")
    # 21c
    k = stats[0]["c8"]["k"]
    overlap = len(set(a["c8_idx"].tolist()) & set(a["exact_idx"].tolist()))
    gain_err = float(np.abs(a["c8_gains"] - a["exact_gains"]).max() /
                     np.abs(a["exact_gains"]).max())
    log(f"== phase 21c: int8 compression (2 rounds) on class 0, k {k}: {overlap} of {k} picks "
        f"shared with the exact run, gain error max {gain_err:.3e} of the largest gain; exact "
        f"{stats[0]['c8']['exact_s']:.3f} s, compressed {stats[0]['c8']['compressed_s']:.3f} s")
    for s in stats:
        assert s["corrupt"] == "CompressionIntegrityError", s["corrupt"]
    assert [s["corrupt_fired"] for s in stats] == [0, 1], [s["corrupt_fired"] for s in stats]
    log("a byte of rank 1's 5th compressed payload flipped after its checksum: both ranks raise "
        "CompressionIntegrityError")
    assert np.isfinite(a["c8_gains"]).all()
    return {"wall_s": wall, "ranks": stats, "bank": bank, "partings": partings,
            "importance_max_abs_diff": imp_diff,
            "c8": {"k": k, "overlap": overlap, "gain_err": gain_err}}


def phase_two_host_training(dev, x, y, *, sizes: dict, work: Path) -> dict:
    """21d: two hosts train phase 14's classifier with heartbeats and
    two-phase checkpoints; rank 1 is killed mid-epoch; the pair restarts."""
    import shutil
    import signal

    from repro_torch.checkpoint.checkpointer import CheckpointManager

    log("== phase 21d: two-host training, a killed host, the restart")
    data = work / "data.npz"
    out = {}
    ref, out["ref_s"] = _launch("train", ["run", str(data), str(work / "ck_ref"), "none",
                                          str(work / "ref")], sizes,
                                timeout=sizes["launch_timeout"])
    for r in ref:
        assert r.returncode == 0, (r.process_id, r.stderr[-4000:])
    one = _phase21_train("run", str(data), str(work / "ck_one"), "none", str(work / "one"),
                         sizes, dev)
    ck, hb = work / "ck", work / "hb"
    dead, out["kill_s"] = _launch("train", ["kill", str(data), str(ck), str(hb),
                                            str(work / "dead")], sizes,
                                  timeout=sizes["launch_timeout"])
    assert dead[1].returncode == -signal.SIGKILL, (dead[1].returncode, dead[1].stderr[-2000:])
    assert dead[0].returncode != 0, dead[0].returncode
    assert "PHASE21_TRAIN_DONE" not in dead[0].stdout
    assert "HostLossError" in dead[0].stderr, dead[0].stderr[-3000:]
    view = CheckpointManager(str(ck))
    latest = view.latest_valid_step()
    man = view.validate_step(latest)
    assert man["num_shards"] == 2 and man["hosts"] == [0, 1], man
    assert latest < sizes["kill_step"] + sizes["ckpt_every"], latest
    lost = [ln for ln in dead[0].stderr.splitlines() if "HostLossError" in ln][-1]
    log(f"kill at step {sizes['kill_step']}: rank 1 {dead[1].returncode} (SIGKILL), rank 0 "
        f"{dead[0].returncode}: {lost.strip()[:150]}; latest valid step {latest}, "
        f"{man['num_shards']} shards, format {man['format']} ({out['kill_s']:.1f} s)")
    restart, out["restart_s"] = _launch("train", ["run", str(data), str(ck), str(hb),
                                                  str(work / "res")], sizes,
                                        timeout=sizes["launch_timeout"])
    for r in restart:
        assert r.returncode == 0, (r.process_id, r.stderr[-4000:])

    def load(name):
        with np.load(work / f"{name}.npz") as f:
            return {key: f[key] for key in f.files}

    want = load("ref.0")
    for name in ("ref.1", "one.0", "res.0", "res.1"):
        got = load(name)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{name} {key}")
    log(f"final parameters and momenta at step {int(want['step'])} ({one['spe']} steps an epoch,"
        f" {sizes['epochs']} epochs, checkpoints every {sizes['ckpt_every']}): the restarted pair"
        f" bit-equal to the uninterrupted pair and to one process; launches {out['ref_s']:.1f} / "
        f"{out['kill_s']:.1f} / {out['restart_s']:.1f} s, one process {one['seconds']:.2f} s")
    out.update(latest=latest, steps=int(want["step"]), one_s=one["seconds"])
    for name in ("ck_ref", "ck_one", "ck", "hb"):
        shutil.rmtree(work / name, ignore_errors=True)
    return out


def phase_multi_device(dev, x, y, gf7: dict, *, rehearsal: bool, smi: str) -> dict:
    """Phase 21: 21a one NCCL rank, 21b-c two ranks on the card, 21d two hosts."""
    import shutil

    sizes = PHASE21_SIZES["rehearsal" if rehearsal else "full"]
    log(f"== phase 21: multi-device selection and multi-host execution on {smi}")
    work = ROOT / "build" / "phase21"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    out = {"21a": phase_sharded_one_rank(dev, x, y, sizes=sizes)}
    t = time.perf_counter()
    out["21bc"] = phase_sharded_two_ranks(dev, x, y, gf7, sizes=sizes, work=work)
    out["21bc"]["seconds"] = time.perf_counter() - t
    t = time.perf_counter()
    out["21d"] = phase_two_host_training(dev, x, y, sizes=sizes, work=work)
    out["21d"]["seconds"] = time.perf_counter() - t
    shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    out["smi"] = smi
    log("phase 21 summary: " + json.dumps(out, default=str))
    return out


# ---------------------------------------------------------------------------
# phase 22: the LM sharding rules on DTensor and the dry run
# ---------------------------------------------------------------------------

#: phase 22d's cells, each on both production meshes (32x8 and 2x32x8)
DRYRUN_CELLS = (("yi-6b", "train_4k"), ("yi-6b", "decode_32k"),
                ("jamba-1.5-large-398b", "prefill_32k"))

#: one dry run cell in a process of its own (a fake process group of 256 or
#: 512 ranks; the card hidden, so nothing can reach it)
DRYRUN_CHILD = ("import json, sys; from repro_torch.launch import dryrun; "
                "rec = dryrun.run_cell(sys.argv[1], sys.argv[2], multi_pod=sys.argv[3] == 'mp', "
                "out_dir=sys.argv[4], overrides=json.loads(sys.argv[5]) or None); "
                "sys.exit(0 if rec['status'] == 'ok' else 1)")


def _dry_run_overrides(arch: str, rehearsal: bool) -> dict:
    """The rehearsal's cut: the smoke config's widths and depth at the
    cell's full shapes (the full config's attention block and SSM chunk)."""
    if not rehearsal:
        return {}
    from repro_torch.configs import registry

    full, small = dataclasses.asdict(registry.get(arch)), dataclasses.asdict(registry.smoke(arch))
    keep = ("attention_impl", "remat", "attn_block", "ssm_chunk", "pattern")
    return {k: v for k, v in small.items() if v != full[k] and k not in keep}


class _DryRuns:
    """Phase 22d's cells as child processes, at most ``workers`` at a time,
    started now and run beside 22a-c (the dry run uses the host's cores
    only).  ``wait`` joins them all and kills what outlives ``timeout``.
    The rehearsal runs yi-6b ``decode_32k`` and Jamba ``prefill_32k`` on
    the single-pod mesh at smoke widths."""

    def __init__(self, out: Path, *, rehearsal: bool, workers: int = 6, timeout: float = 600.0):
        import os
        import threading

        self.out, self.timeout = out, timeout
        self.jobs = [(a, s, mp) for a, s in DRYRUN_CELLS for mp in ("sp", "mp")]
        if rehearsal:  # the rehearsal's cut: two cells, the single-pod mesh
            self.jobs = [j for j in self.jobs if j[1] != "train_4k" and j[2] == "sp"]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="1")
        self.results: dict = {}
        self.procs: list = []
        self.t0 = time.perf_counter()

        def run():
            pending = list(self.jobs)
            live: dict = {}
            while pending or live:
                while pending and len(live) < workers:
                    a, s, mp = pending.pop(0)
                    args = [sys.executable, "-c", DRYRUN_CHILD, a, s, mp, str(out),
                            json.dumps(_dry_run_overrides(a, rehearsal))]
                    p = subprocess.Popen(args, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)
                    self.procs.append(p)
                    live[(a, s, mp)] = (p, time.perf_counter())
                for key, (p, t) in list(live.items()):
                    if p.poll() is not None:
                        self.results[key] = (p.returncode, p.stdout.read()[-3000:],
                                             time.perf_counter() - t)
                        del live[key]
                time.sleep(0.2)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def wait(self) -> dict:
        self.thread.join(max(1.0, self.timeout - (time.perf_counter() - self.t0)))
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        missing = [j for j in self.jobs if j not in self.results]
        assert not missing, f"22d: dry run cells {missing} outlived {self.timeout:.0f} s"
        return self.results


def _from_local(mesh, tree, shardings):
    """``tree``'s tensors as DTensors on ``mesh`` whose local shards they
    are (no copy): on a mesh of one rank each tensor is its whole shard."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return {k: _from_local(mesh, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_from_local(mesh, t, s) for t, s in zip(tree, shardings))
    return DTensor.from_local(tree, mesh, list(shardings), run_check=False)


def _full(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def phase_sharded_yi(dev, mesh, *, rehearsal: bool, steps: int = 8) -> dict:
    """22a: phase 12's yi-6b on a (1, 1) mesh of one rank: ``lm.prefill`` of
    phase 12's first prompt and ``steps`` decode steps under the ambient
    mesh, the weights and caches as DTensors over the same tensors, against
    the same calls on the plain tensors."""
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch import specs
    from repro_torch.models import lm

    cfg = dataclasses.replace(registry.get("yi-6b"), attention_impl="pallas")
    traffic, max_len = dict(n=8, lo=256, hi=2048), 2304
    if rehearsal:
        cfg = dataclasses.replace(registry.smoke("yi-6b"), attention_impl="pallas")
        traffic, max_len = dict(n=8, lo=8, hi=40), 64
    prompt = serve_traffic(cfg.vocab_size, **traffic)[0]
    log(f"== phase 22a: {cfg.name} on a (1, 1) mesh of one {mesh.device_type} rank: prefill of "
        f"{len(prompt)} tokens and {steps} decode steps, DTensor against plain tensors")
    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed=0, device=dev)
    _sync(dev)
    log(f"22a: built in {time.perf_counter() - t0:.1f} s")
    tokens = torch.as_tensor(prompt[None], device=dev)

    def run(params, caches, feed=None):
        _sync(dev)
        t = time.perf_counter()
        _reset_launches()
        logits, caches = lm.prefill(params, cfg, tokens, caches)
        _sync(dev)
        pre_s, pre_launches = time.perf_counter() - t, fa.launches
        logits = _full(logits)
        fed = [int(torch.argmax(logits[0, -1]))] if feed is None else list(feed)
        dec, dec_s = [], []
        for j in range(steps):
            tok = torch.tensor([[fed[j]]], device=dev)
            _sync(dev)
            t = time.perf_counter()
            out, caches = lm.decode_step(params, cfg, tok, caches, len(prompt) + j)
            _sync(dev)
            dec_s.append(time.perf_counter() - t)
            dec.append(_full(out)[0, -1])
            if feed is None:
                fed.append(int(torch.argmax(dec[-1])))
        return dict(logits=logits, dec=torch.stack(dec), fed=fed[:steps], prefill_s=pre_s,
                    decode_s=dec_s, prefill_launches=pre_launches,
                    decode_launches=fa.launches - pre_launches)

    plain = run(model, lm.init_caches(cfg, 1, max_len, dev))
    caches = lm.init_caches(cfg, 1, max_len, dev)
    dparams = _from_local(mesh, model, shd.param_shardings(mesh, model))
    dcaches = specs.lay_out_caches(caches, specs.cache_placements(mesh, caches),
                                   lambda t, p: _from_local(mesh, t, p))
    with shd.use_mesh(mesh):
        sharded = run(dparams, dcaches, feed=plain["fed"])
    _bit_equal("22a prefill logits, DTensor against plain", sharded["logits"], plain["logits"])
    _bit_equal(f"22a {steps} decode steps' logits, DTensor against plain", sharded["dec"],
               plain["dec"])
    out = {"prompt": len(prompt), "steps": steps,
           "launches": {"prefill": sharded["prefill_launches"],
                        "decode": sharded["decode_launches"]}}
    for name, r in (("plain", plain), ("dtensor", sharded)):
        out[name] = {"prefill_ms": r["prefill_s"] * 1e3,
                     "decode_median_ms": float(np.median(r["decode_s"])) * 1e3,
                     "decode_ms": [s * 1e3 for s in r["decode_s"]]}
    log(f"22a: prefill {out['plain']['prefill_ms']:.2f} ms plain, "
        f"{out['dtensor']['prefill_ms']:.2f} ms DTensor; decode median "
        f"{out['plain']['decode_median_ms']:.2f} ms plain, "
        f"{out['dtensor']['decode_median_ms']:.2f} ms DTensor (reported); B5 launches on the "
        f"local-shard route {out['launches']}")
    if dev.type == "cuda":
        assert plain["prefill_launches"] == cfg.num_layers, plain["prefill_launches"]
        assert out["launches"] == {"prefill": cfg.num_layers, "decode": 0}, out["launches"]
    del model, dparams, dcaches, caches, plain, sharded
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_sharded_jamba(dev, mesh, *, rehearsal: bool, seq: int = 2048) -> dict:
    """22b: one Jamba block at published widths, a Mamba mixer and a MoE FFN
    of all 16 experts, prefill of ``seq`` tokens on a (1, 1) mesh under the
    ambient mesh against the plain tensors: B6 on the local-shard route."""
    from repro_torch.configs import registry
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.ssd_chunk import ssd_chunk as sc
    from repro_torch.models.blocks import apply_block, init_block

    cfg = dataclasses.replace(registry.get("jamba-1.5-large-398b"), attention_impl="pallas",
                              ssm_impl="pallas")
    if rehearsal:
        cfg = dataclasses.replace(registry.smoke("jamba-1.5-large-398b"), attention_impl="pallas",
                                  ssm_impl="pallas")
        seq = 40
    log(f"== phase 22b: one {cfg.name} block (mamba + moe, d_model {cfg.d_model}, "
        f"{cfg.num_experts} experts) over {seq} tokens on the (1, 1) mesh")
    gen = torch.Generator(device=dev).manual_seed(0)
    block = init_block(gen, cfg, "mamba", "moe", torch.bfloat16)
    x = torch.randn((1, seq, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    pos = torch.arange(seq, device=dev)[None]
    kw = dict(cfg=cfg, kinds=("mamba", "moe"), positions=pos, cache=None, mode="prefill")
    _reset_launches()
    y0, st0 = apply_block(block, x, **kw)
    plain_launches = sc.launches
    dblock = _from_local(mesh, block, shd.param_shardings(mesh, {"b": block})["b"])
    dx = _from_local(mesh, x, shd.data_spec(mesh, 1, 2))
    _sync(dev)
    _reset_launches()
    with shd.use_mesh(mesh):
        y1, st1 = apply_block(dblock, dx, **kw)
    _sync(dev)
    launches = sc.launches
    _bit_equal("22b block output, DTensor against plain", _full(y1), y0)
    _bit_equal("22b final SSM state, DTensor against plain", _full(st1), st0)
    chunks = -(-seq // cfg.ssm_chunk)
    log(f"22b: B6 launches {launches} on the local-shard route ({plain_launches} plain; "
        f"ceil({seq}/{cfg.ssm_chunk}) = {chunks})")
    if dev.type == "cuda":
        assert launches == plain_launches == chunks, (launches, plain_launches)
    del block, dblock, x, dx, y0, y1, st0, st1
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"seq": seq, "launches": launches}


def phase_b5_rank_shards(dev, *, rehearsal: bool, seq: int = 2048) -> dict:
    """22c: B5 on each rank's query heads, with the key/value heads its
    wrapper chooses, against the full kernel's rows: yi-6b's 32/4 heads of
    128 over a model axis of 8 (the 4 key/value heads replicated) and of 2
    (split), bit for bit."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops as fa_ops

    hq, hkv, d = 32, 4, 128
    if rehearsal:
        seq, d = 40, 16
    log(f"== phase 22c: B5 on rank shards of (1, {hq}/{hkv}, {seq}, {d}) bf16, model axis 8 "
        "and 2")
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((1, h, seq, d), generator=gen, device=dev).to(torch.bfloat16)
               for h in (hq, hkv, hkv))
    _reset_launches()
    fa_ops.copies = 0
    full = fa_ops.flash_attention(q, k, v, causal=True)
    for model in (8, 2):
        hl, split = hq // model, hkv % model == 0
        for r in range(model):
            kl, vl, off = k, v, 0
            if split:
                n = hkv // model
                kl, vl, off = k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n], r * n
            kr, vr = fa_ops.local_kv_heads(kl, vl, hq=hq, hkv=hkv, q_offset=r * hl, hq_local=hl,
                                           kv_offset=off)
            out = fa_ops.flash_attention(q[:, r * hl:(r + 1) * hl], kr, vr, causal=True)
            if not torch.equal(out, full[:, r * hl:(r + 1) * hl]):
                raise AssertionError(f"22c: model {model}, rank {r}: not bit-equal")
        log(f"22c: model axis {model} ({'split' if split else 'replicated'} key/value heads): "
            f"every rank's {hl} query heads bit-equal to the full kernel's rows")
    launches = fa.launches
    assert fa_ops.copies == 0, fa_ops.copies
    if dev.type == "cuda":
        assert launches == 1 + 8 + 2, launches
    return {"seq": seq, "launches": launches}


def phase_dry_run_report(runs: _DryRuns, smi: str) -> dict:
    """22d: the dry run's cells, read back from their records."""
    results = runs.wait()
    cells = {}
    failed = []
    for (arch, shape, mp), (code, tail, seconds) in sorted(results.items()):
        label = "2x32x8" if mp == "mp" else "32x8"
        path = runs.out / f"{arch}_{shape}_{mp}.json"
        rec = json.loads(path.read_text()) if path.exists() else {"status": "missing"}
        if code != 0 or rec["status"] != "ok":
            failed.append((arch, shape, label, rec.get("error", tail)[-1500:]))
            continue
        c, t, m = rec["cost"], rec["roofline"], rec["memory"]
        cells[f"{arch} {shape} {label}"] = {
            "flops_per_device": c["flops"], "bytes_per_device": c["bytes"],
            "collective_bytes_by_axis": c["collective_bytes_by_axis"],
            "collective_counts": c["collective_counts"],
            "argument_bytes": m["argument_size_in_bytes"],
            "peak_bytes": m["peak_memory_in_bytes"], "bound": t["bound"],
            "compute_s": t["compute_s"], "memory_s": t["memory_s"],
            "collective_s": t["collective_s"], "roofline_fraction": t["roofline_fraction"],
            "useful_flops_ratio": t["useful_flops_ratio"], "model_flops": t["model_flops"],
            "seconds": rec["seconds"], "process_s": seconds,
            "attention_impl": rec["attention_impl"], "ssm_impl": rec["ssm_impl"]}
        log(f"22d {arch} x {shape} ({label}): {c['flops']:.4g} FLOP, {c['bytes']:.4g} B, "
            f"collectives {c['collective_bytes_by_axis']} B, arguments "
            f"{m['argument_size_in_bytes'] / 1e9:.3f} GB a device; bound {t['bound']}, roofline "
            f"fraction {t['roofline_fraction']:.4f} (H100 SXM spec sheet); {rec['seconds']:.1f} s")
    assert not failed, f"22d: dry run cells failed: {failed}"
    from repro_torch.launch import report

    recs = report.load_all(str(runs.out))
    for label in ("32x8", "2x32x8"):
        log(f"22d roofline, {label} (analytic bounds, H100 SXM spec sheet; launch/report.py):\n"
            + report.fmt_table(recs, label))
    return {"cells": cells, "wall_s": time.perf_counter() - runs.t0, "smi": smi}


def phase_lm_sharding(dev, *, rehearsal: bool, smi: str) -> dict:
    """Phase 22: 22a-c on one rank of a (1, 1) mesh and B5's rank shards on
    the card, 22d the dry run on the card's host, all four in turn except
    22d, which runs beside them."""
    import shutil

    from repro_torch.launch.mesh import make_mesh

    log(f"== phase 22: the LM sharding rules on DTensor and the dry run on {smi}")
    work = ROOT / "build" / "phase22"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    runs = _DryRuns(work, rehearsal=rehearsal)
    dist = torch.distributed
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device_type=dev.type)
        out = {"22a": phase_sharded_yi(dev, mesh, rehearsal=rehearsal),
               "22b": phase_sharded_jamba(dev, mesh, rehearsal=rehearsal)}
    finally:
        dist.destroy_process_group()
    out["22c"] = phase_b5_rank_shards(dev, rehearsal=rehearsal)
    out["22abc_s"] = time.perf_counter() - t0
    out["22d"] = phase_dry_run_report(runs, smi)
    shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log("phase 22 summary: " + json.dumps(out, default=str))
    return out


# ---------------------------------------------------------------------------
# phase 23: the port's six examples on the card
# ---------------------------------------------------------------------------

#: the examples in phase 23's order (the two serving flows first)
EXAMPLES = ("serve_lm", "serve_selection", "quickstart", "tune_hparams", "targeted_selection",
            "train_lm_milo")
#: the examples with a kernel route (``--use-pallas``: B1 for the dense Gram)
PALLAS_EXAMPLES = ("quickstart", "tune_hparams", "train_lm_milo")
#: ``--cpu-rehearsal``'s sizes; the card runs the examples' own defaults
REHEARSAL_ARGV = {"serve_lm": ["--requests", "4", "--max-new", "4"],
                  "serve_selection": ["--n", "600", "--max-budget", "3"],
                  "quickstart": ["--n", "1200", "--epochs", "4"],
                  "tune_hparams": ["--n", "600", "--max-budget", "3"],
                  "targeted_selection": ["--n", "1200"],
                  "train_lm_milo": ["--steps", "40"]}


def _kernel_launches() -> dict:
    """Each hand-written kernel's launches since the last reset."""
    from repro_torch.kernels.fl_gains import fl_gains as fk
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.similarity import similarity as sk
    from repro_torch.kernels.ssd_chunk import ssd_chunk as sc

    return {"similarity": sk.launches, **fk.launches, "flash_attention": fa.launches,
            "ssd_chunk": sc.launches}


def _load_example(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_example(name: str, argv: list[str], dev) -> dict:
    """One example through its ``main(argv)``, in this process; its own
    asserts hold or the phase fails.  Wall time and kernel launches."""
    main_fn = _load_example(name).main
    gc.collect()
    _reset_launches()
    t0 = time.perf_counter()
    result = main_fn(argv)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _kernel_launches()
    log(f"23 {name} {' '.join(argv)}: exit 0, {wall:.2f} s, launches "
        f"{ {k: v for k, v in launches.items() if v} or 'none' }")
    return {"argv": argv, "status": 0, "wall_s": wall, "launches": launches, "result": result}


def phase_examples(dev, *, rehearsal: bool, smi: str) -> dict:
    """Phase 23: (a) the six ``examples/torch`` flows through their ``main``
    at the examples' own sizes (the reference's), on the card; (b) the three
    with a dense Gram again with ``--use-pallas`` (B1)."""
    import shutil

    log(f"== phase 23: the six examples on {smi}")
    work = ROOT / "build" / "phase23"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    paths = {"quickstart": ["--artifact", str(work / "quickstart.npz")],
             "serve_selection": ["--store-root", str(work / "store")],
             "train_lm_milo": ["--ckpt", str(work / "lm_ckpt")]}
    t0 = time.perf_counter()
    out: dict = {"23a": {}, "23b": {}}
    for name in EXAMPLES:
        argv = ["--device", dev.type, *paths.get(name, []),
                *(REHEARSAL_ARGV[name] if rehearsal else [])]
        out["23a"][name] = _run_example(name, argv, dev)
    for name in PALLAS_EXAMPLES:
        argv = [*out["23a"][name]["argv"], "--use-pallas"]
        out["23b"][name] = _run_example(name, argv, dev)
    if dev.type == "cuda":
        # the dense preprocess builds its class Grams through B1
        assert out["23b"]["quickstart"]["launches"]["similarity"] >= 1, out["23b"]["quickstart"]
    shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log("phase 23 summary: " + json.dumps(
        {sub: {name: {k: r[k] for k in ("wall_s", "status", "launches")}
               for name, r in runs.items()} for sub, runs in out.items() if sub != "seconds"}
        | {"seconds": out["seconds"]}, default=str))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run phases 1, 5-9 and 12-23 on the CPU at a tiny size (tests only)")
    args = ap.parse_args()
    if not args.cpu_rehearsal and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke runs on a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    t_start = time.perf_counter()
    dev_info = phase_device(args.cpu_rehearsal)
    if args.cpu_rehearsal:
        dev = torch.device("cpu")
        main_run = phase_main_path(dev, n=1200, n_classes=4, dim=32, epochs=12)
        phase_routes(dev, main_run["x"], main_run["y"], main_run["session"])
        gf = phase_gram_free_path(dev, main_run["x"], main_run["y"], main_run["tx"],
                                  main_run["ty"], epochs=12)
        phase_gram_free_routes(dev, main_run["x"], main_run["y"], gf["session"])
        phase_fl_dense(dev, main_run["x"], main_run["y"], gf["session"])
        phase_lm_serving(dev, rehearsal=True)
        md = main_run["session"].metadata
        phase_fused_training(dev, main_run["x"], main_run["y"], main_run["tx"], main_run["ty"],
                             md, epochs=4, superstep=2)
        phase_tuning(dev, main_run["x"], main_run["y"], main_run["tx"], main_run["ty"], md)
        phase_hierarchical(dev, main_run["x"], main_run["y"], main_run["tx"], main_run["ty"],
                           smi="cpu (rehearsal)", sizes=HIER_SIZES["rehearsal"], epochs=12)
        phase_baselines(dev, main_run["x"], main_run["y"], main_run["tx"], main_run["ty"],
                        smi="cpu (rehearsal)", sizes=BASELINE_SIZES["rehearsal"], epochs=12)
        phase_lm_training(dev, main_run["x"], main_run["y"], md, rehearsal=True,
                          smi="cpu (rehearsal)")
        phase_selection_service(dev, main_run["x"], main_run["y"], main_run["tx"], main_run["ty"],
                                rehearsal=True, smi="cpu (rehearsal)")
        phase_last_families(dev, rehearsal=True, smi="cpu (rehearsal)")
        phase_multi_device(dev, main_run["x"], main_run["y"], gf, rehearsal=True,
                           smi="cpu (rehearsal)")
        phase_lm_sharding(dev, rehearsal=True, smi="cpu (rehearsal)")
        phase_examples(dev, rehearsal=True, smi="cpu (rehearsal)")
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"ok": True, "rehearsal": "cpu"}))
        return 0

    dev = torch.device("cuda")
    report = phase_build()
    err = phase_kernel_checks(dev)
    fl_err = phase_fl_kernel_checks(dev)
    timing = phase_kernel_timing(dev, dev_info["smi"])
    fl_timing = phase_fl_kernel_timing(dev, dev_info["smi"])
    main_run = phase_main_path(dev, n=60000, n_classes=10, dim=768, epochs=12)
    phase_routes(dev, main_run["x"], main_run["y"], main_run["session"])
    gf = phase_gram_free_path(dev, main_run["x"], main_run["y"], main_run["tx"], main_run["ty"],
                              epochs=12)
    phase_gram_free_routes(dev, main_run["x"], main_run["y"], gf["session"])
    dense_launches = phase_fl_dense(dev, main_run["x"], main_run["y"], gf["session"])
    sim_launches, gf_launches = main_run["launches"], gf["launches"]
    delta_instances, gathers, b2_instances = gf["instances"], gf["gathers"], gf["b2_instances"]
    # phases 14-15 train and tune on phase 5's data and artifact; phase 21
    # holds its two-rank run against phase 7's artifact and trajectories
    train_data = {k: main_run[k] for k in ("x", "y", "tx", "ty")}
    md = main_run["session"].metadata
    gf7 = {k: gf[k] for k in ("md", "preprocess_s", "stage_s", "peak_mib", "trajectories")}
    del main_run, gf
    lm_err = phase_lm_kernel_checks(dev)
    lm_timing = phase_lm_kernel_timing(dev, dev_info["smi"])
    serving = phase_lm_serving(dev, rehearsal=False)
    phase_fused_training(dev, *train_data.values(), md, epochs=12)
    phase_tuning(dev, *train_data.values(), md)
    hier = phase_hierarchical(dev, *train_data.values(), smi=dev_info["smi"],
                              sizes=HIER_SIZES["full"], epochs=12)
    base = phase_baselines(dev, *train_data.values(), smi=dev_info["smi"],
                           sizes=BASELINE_SIZES["full"], epochs=12)
    phase_lm_training(dev, train_data["x"], train_data["y"], md, rehearsal=False,
                      smi=dev_info["smi"])
    service = phase_selection_service(dev, *train_data.values(), rehearsal=False,
                                      smi=dev_info["smi"])
    families = phase_last_families(dev, rehearsal=False, smi=dev_info["smi"])
    multi = phase_multi_device(dev, train_data["x"], train_data["y"], gf7, rehearsal=False,
                               smi=dev_info["smi"])
    sharding = phase_lm_sharding(dev, rehearsal=False, smi=dev_info["smi"])
    examples = phase_examples(dev, rehearsal=False, smi=dev_info["smi"])
    phase20_flash = families["20b"]["launches"] + families["20c"]["launches"]
    fl_src = "src/repro_torch/csrc/fl_gains.cu"
    fl_rows = [
        ("fl_gains_gram_free", "src/repro/kernels/fl_gains/fl_gains.py:178",
         gf_launches["fl_gains_gram_free"], "(8192, 8192, 768)"),
        ("fl_gains_gram_free_delta", "src/repro/kernels/fl_gains/fl_gains.py:133",
         gf_launches["fl_gains_gram_free_delta"], "(8, 8192, 768): b = 8 touched rows"),
        ("fl_gains", "src/repro/kernels/fl_gains/fl_gains.py:52", dense_launches, "(8192, 8192)"),
    ]
    kernels = [{
        "name": "similarity",
        "route": "cuda",
        "source": "src/repro_torch/csrc/similarity.cu",
        "replaces": "src/repro/kernels/similarity/similarity.py:39",
        "launches": sim_launches,
        "max_abs_err": err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": fl_src,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": fl_err[name],
        "ms": fl_timing[name]["ms"],
        "plain_ms": fl_timing[name]["plain_ms"],
        "bound_ms": fl_timing[name]["bound_ms"],
        "bound_by": fl_timing[name]["bound_by"],
        "library_ms": None,
        # no one PyTorch call computes these functions; the fused kernels'
        # fp32 product alone (torch.mm, TF32 off) is kept as a yardstick
        "product_ms": fl_timing[name]["product_ms"],
        "shape": shape,
    } for name, replaces, launches, shape in fl_rows] + [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": serving[name] + (phase20_flash if name == "flash_attention" else 0),
        "max_abs_err": lm_err[name],
        "ms": lm_timing[name]["ms"],
        "plain_ms": lm_timing[name]["plain_ms"],
        "bound_ms": lm_timing[name]["bound_ms"],
        "bound_by": lm_timing[name]["bound_by"],
        "library_ms": lm_timing[name]["library_ms"],
        "shape": shape,
    } for name, replaces, shape in (
        ("flash_attention", "src/repro/kernels/flash_attention/flash_attention.py:70",
         "(1, 32/4, 2048, 128) bf16 causal (yi-6b); launches: phase 12, yi-6b serving, and "
         "phase 20, whisper-small and llama-3.2-vision"),
        ("ssd_chunk", "src/repro/kernels/ssd_chunk/ssd_chunk.py:57",
         "(1, 256, 256, 64), N 128 f32 (Jamba); launches: phase 13, Jamba serving"))]
    from repro_torch.kernels import _build

    # the redesigned kernels' registers, spills and dynamic shared memory,
    # and the delta's per-size times and per-instance launches
    sim = kernels[0]
    sim["ptxas"] = ptxas_instances(report, SIMILARITY_INSTANCES)
    smem = _build.function("similarity_smem_bytes", [ctypes.c_int])
    sim["dynamic_smem_bytes"] = {"f32": smem(0), "bf16": smem(1)}
    delta = next(k for k in kernels if k["name"] == "fl_gains_gram_free_delta")
    delta["alone_ms"] = fl_timing["fl_gains_gram_free_delta"]["alone_ms"]
    delta["cold_ms"] = fl_timing["fl_gains_gram_free_delta"]["cold_ms"]
    delta["times"] = {f"b{b}": {key: fl_timing[f"fl_gains_gram_free_delta_b{b}"][key]
                                for key in ("instance", "ms", "alone_ms", "cold_ms", "bound_ms",
                                            "bound_by", "plain_ms", "tiled")
                                if key in fl_timing[f"fl_gains_gram_free_delta_b{b}"]}
                      for b in (1, 8, 64, 1024)}
    delta["instances"] = {
        "small_b": {"launches": delta_instances["small_b"],
                    "ptxas": ptxas_instances(report, SMALL_B_INSTANCES),
                    "dynamic_smem_bytes": _build.function(
                        "fl_gains_gram_free_delta_small_b_smem_bytes", [])()},
        "tiled": {"launches": delta_instances["tiled"],
                  "ptxas": ptxas_stats(report, "gram_free_kernelILb1EE")}}
    delta["gather_sizes"] = {str(b): n for b, n in gathers.items()}
    # B2: both shapes on both instances and measures, the bound over the
    # rows with a finite cover beside the all-rows bound, launches per instance
    b2 = next(k for k in kernels if k["name"] == "fl_gains_gram_free")
    b2["live_bound_ms"] = fl_timing["fl_gains_gram_free"]["live_bound_ms"]
    b2["times"] = {key: {k: fl_timing[f"fl_gains_gram_free_{key}"][k]
                         for k in ("ring", "tiled", "plain_ms", "product_ms", "bound_ms",
                                   "bound_by", "live_rows", "live_bound_ms")}
                   for key in ("path", "all_live", "rank_4096")}
    b2["instances"] = {
        "ring": {"launches": b2_instances["ring"],
                 "ptxas": ptxas_stats(report, "gram_free_ring_kernel"),
                 "dynamic_smem_bytes": _build.function("fl_gains_gram_free_ring_smem_bytes", [])()},
        "tiled": {"launches": b2_instances["tiled"],
                  "ptxas": ptxas_stats(report, "gram_free_kernelILb0EE")}}
    # phase 16: each kernel's launches on the hierarchical path (per
    # sub-phase, per instance) and its error against its plain version there
    sim["phase16"] = {"launches": {"16a": hier["16a"]["launches"]["similarity"]},
                      "max_abs_err": hier["16a"]["max_abs_err"]}
    for kern in (b2, delta):
        kern["phase16"] = {"launches": {sub: hier[sub]["launches"][kern["name"]]
                                        for sub in ("16b", "16c")},
                           "max_abs_err": hier["16c"]["max_abs_err"][kern["name"]]}
    # phase 21: each kernel's launches on the sharded path, one NCCL rank
    # (21a, the sharded engines alone) and each of the two ranks of 21b,
    # with instances
    for kern in (b2, delta):
        kern["phase21"] = {
            "21a": multi["21a"]["launches"][kern["name"]],
            "21b_per_rank": [{"launches": r["launches"][kern["name"]],
                              "instances": r["launches"]["instances"][kern["name"]]}
                             for r in multi["21bc"]["ranks"]]}
    # phase 17: B4 on CRAIG's path (one launch a greedy step), at its shape
    b4 = next(k for k in kernels if k["name"] == "fl_gains")
    b4["phase17"] = base["17d"]["b4"]
    # phase 19: B1 on the selection-serving path (the server's artifact build
    # and its warm-up's geometries)
    sim["phase19"] = {"launches": service["19a"]["b1_launches"]}
    spills = [v for k in (sim["ptxas"], delta["instances"]["small_b"]["ptxas"]) for v in k.values()]
    spills.append(b2["instances"]["ring"]["ptxas"])
    log(f"similarity: {sim['ptxas']}, dynamic shared memory {sim['dynamic_smem_bytes']} bytes")
    log(f"fl_gains_gram_free ring: {b2['instances']['ring']['ptxas']}, dynamic shared memory "
        f"{b2['instances']['ring']['dynamic_smem_bytes']} bytes")
    log(f"fl_gains_gram_free_delta small-b: {delta['instances']['small_b']['ptxas']}, dynamic "
        f"shared memory up to {delta['instances']['small_b']['dynamic_smem_bytes']} bytes")
    assert all(v["spill_store_bytes"] == v["spill_load_bytes"] == 0 for v in spills), spills

    flash = next(k for k in kernels if k["name"] == "flash_attention")
    # phase 20: B5's launches by shape and instance (whisper-small 20b,
    # llama-3.2-vision 20c, prefill and decode apart) and its times there
    flash["phase20"] = {
        "launches": {sub: {"total": families[sub]["launches"], **families[sub]["shapes"]}
                     for sub in ("20b", "20c")},
        "times": lm_timing["flash_attention_phase20"]}
    flash.update(ptxas_stats(report, "flash_wgmma_kernel"))
    flash["dynamic_smem_bytes"] = _build.function("flash_attention_bf16_smem_bytes", [])()
    log(f"flash_attention bf16 kernel: {flash['registers']} registers, spills "
        f"{flash['spill_store_bytes']} / {flash['spill_load_bytes']} bytes, "
        f"{flash['dynamic_smem_bytes']} bytes of dynamic shared memory")
    # B6: the mma instance on the card alone, beside the simt instance (the
    # kernel it replaced) and the split route's bound; launches, registers,
    # spills and dynamic shared memory per instance
    ssd = next(k for k in kernels if k["name"] == "ssd_chunk")
    ssd.update({key: lm_timing["ssd_chunk"][key] for key in (
        "alone_ms", "simt", "split_bound_ms", "split_bound_by", "sm_clock_mhz", "max_sm_clock_mhz")})
    ssd["simt"]["max_abs_err"] = lm_err["ssd_chunk_simt"]
    ssd["instances"] = {
        "mma": {"launches": serving["ssd_chunk_instances"]["mma"],
                "ptxas": ptxas_stats(report, "ssd_chunk_mma_kernel"),
                "dynamic_smem_bytes": _build.function("ssd_chunk_mma_smem_bytes", [])()},
        "simt": {"launches": serving["ssd_chunk_instances"]["simt"],
                 "ptxas": ptxas_stats(report, "16ssd_chunk_kernel"),
                 "dynamic_smem_bytes": _build.function("ssd_chunk_simt_smem_bytes",
                                                       [ctypes.c_int])(256)}}
    for name, inst in ssd["instances"].items():
        log(f"ssd_chunk {name}: {inst['ptxas']}, dynamic shared memory {inst['dynamic_smem_bytes']} "
            f"bytes at L 256, {inst['launches']} launches in phase 13")
    mma_ptxas = ssd["instances"]["mma"]["ptxas"]
    assert mma_ptxas["spill_store_bytes"] == mma_ptxas["spill_load_bytes"] == 0, mma_ptxas
    # phase 22: B5 and B6 on DTensor shards (22a's prefill, 22b's block) and
    # B5 on each rank's query heads (22c)
    flash["phase22"] = {"22a_prefill": sharding["22a"]["launches"]["prefill"],
                        "22c": sharding["22c"]["launches"]}
    flash["launches"] += sum(flash["phase22"].values())
    ssd["phase22"] = {"22b": sharding["22b"]["launches"]}
    ssd["launches"] += ssd["phase22"]["22b"]
    # phase 23: each kernel's launches in each example run
    for kern in kernels:
        kern["phase23"] = {f"{sub} {name}": run["launches"][kern["name"]]
                           for sub in ("23a", "23b") for name, run in examples[sub].items()}
        kern["launches"] += sum(kern["phase23"].values())
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(dev_info["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_info["kind"],
                                             "count": dev_info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
