#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                   # needs a CUDA card; exits non-zero without one
    python3 chip_smoke.py --cpu-rehearsal   # tiny CPU rehearsal of phases 1, 5-9, 12-13 (tests only)

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
   path's shape (5,000 live rows of 8,192) and with every row live, and the
   lazy delta, each also on the card alone (calls queued behind a spin
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
    chunks composed), repeated launches bit-equal; the bf16 flash kernel's
    worst error beside the CUDA-core kernel's (3.9e-3), held at 1e-2; every
    SSD chunk call on its mma instance (3xTF32 on the tensor cores), and
    its simt instance on the same chunk and scan through a misaligned x;
    the tensor cores' f32 sum (one ``mma.sync`` a tile) against its model
    ``kernels/ssd_chunk/tf32.py``, bit for bit.
11. their times beside their plain versions, their bounds and, for flash
    attention, ``scaled_dot_product_attention`` as the library yardstick,
    with its TFLOP/s and share of the bound at each shape; the SSD chunk
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

Then the ``-Xptxas -v`` registers, spills and dynamic shared memory of the
redesigned kernels, one ``{"kernels": [...]}`` line (launches: each kernel's path —
phase 5 for the similarity kernel, 7 for the gram-free kernels, 9 for the
dense ``fl_gains`` kernel, 12 for flash attention, 13 for the SSD chunk),
the card's name and power limit, and, last,
``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""
from __future__ import annotations

import argparse
import ctypes
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
    for key, zz, cc in (("path", z, c), ("all_live", z_live, c_live)):
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
        live_bound = fl_bound_ms("fl_gains_gram_free", n_live, n, d)[0]
        row = report("fl_gains_gram_free", f"({n}, {n}, {d}), {key} [ring]", ring["ms"], plain,
                     fl_bound_ms("fl_gains_gram_free", n, n, d), prod)
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
                b2_instances=b2_instances)


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
    for counts in (fk.launches, sc.instance_launches):
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
    from repro_torch.models import lm
    from repro_torch.serve import lm_engine

    t0 = time.perf_counter()
    model = lm.init_lm(cfg, seed=seed, device=dev)
    _sync(dev)
    n_params = sum(p.numel() for p in model.parameters())
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
        x = model.embed[tokens]
        for block in model.blocks:
            h = rms_norm(x, block.norm1, cfg.norm_eps)
            if block.mixer_kind == "attn":
                rope = dict(rope_theta=cfg.rope_theta, use_rope=cfg.use_rope)
                y_k, _ = attention(block.mixer, h, positions, impl=cfg.attention_impl, **rope)
                y_p, _ = attention(block.mixer, h, positions, impl=plain.attention_impl, **rope)
            else:
                y_k, _ = mamba(block.mixer, h, chunk=cfg.ssm_chunk, impl=cfg.ssm_impl)
                y_p, _ = mamba(block.mixer, h, chunk=cfg.ssm_chunk, impl=plain.ssm_impl)
            rels.append(_rel(y_k, y_p))
            x, _ = apply_block(block, x, cfg=cfg, positions=positions, cache=None, mode="train")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run phases 1, 5-9 and 12-13 on the CPU at a tiny size (tests only)")
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
    del main_run, gf
    lm_err = phase_lm_kernel_checks(dev)
    lm_timing = phase_lm_kernel_timing(dev, dev_info["smi"])
    serving = phase_lm_serving(dev, rehearsal=False)
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
        "launches": serving[name],
        "max_abs_err": lm_err[name],
        "ms": lm_timing[name]["ms"],
        "plain_ms": lm_timing[name]["plain_ms"],
        "bound_ms": lm_timing[name]["bound_ms"],
        "bound_by": lm_timing[name]["bound_by"],
        "library_ms": lm_timing[name]["library_ms"],
        "shape": shape,
    } for name, replaces, shape in (
        ("flash_attention", "src/repro/kernels/flash_attention/flash_attention.py:70",
         "(1, 32/4, 2048, 128) bf16 causal (yi-6b); launches: phase 12, yi-6b serving"),
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
                   for key in ("path", "all_live")}
    b2["instances"] = {
        "ring": {"launches": b2_instances["ring"],
                 "ptxas": ptxas_stats(report, "gram_free_ring_kernel"),
                 "dynamic_smem_bytes": _build.function("fl_gains_gram_free_ring_smem_bytes", [])()},
        "tiled": {"launches": b2_instances["tiled"],
                  "ptxas": ptxas_stats(report, "gram_free_kernelILb0EE")}}
    spills = [v for k in (sim["ptxas"], delta["instances"]["small_b"]["ptxas"]) for v in k.values()]
    spills.append(b2["instances"]["ring"]["ptxas"])
    log(f"similarity: {sim['ptxas']}, dynamic shared memory {sim['dynamic_smem_bytes']} bytes")
    log(f"fl_gains_gram_free ring: {b2['instances']['ring']['ptxas']}, dynamic shared memory "
        f"{b2['instances']['ring']['dynamic_smem_bytes']} bytes")
    log(f"fl_gains_gram_free_delta small-b: {delta['instances']['small_b']['ptxas']}, dynamic "
        f"shared memory up to {delta['instances']['small_b']['dynamic_smem_bytes']} bytes")
    assert all(v["spill_store_bytes"] == v["spill_load_bytes"] == 0 for v in spills), spills

    flash = next(k for k in kernels if k["name"] == "flash_attention")
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
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(dev_info["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_info["kind"],
                                             "count": dev_info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
