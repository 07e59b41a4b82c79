#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py                   # needs a CUDA card; exits non-zero without one
    python3 chip_smoke.py --cpu-rehearsal   # tiny CPU rehearsal of phases 1, 5, 6 (tests only)

Phases, in order; any failure ends the run with a non-zero exit:

1. device: name, count, ``nvidia-smi`` name and power limit; TF32 off.
2. build: every ``src/repro_torch/csrc/*.cu`` into the git-ignored build
   directory, with the ``-Xptxas -v`` register/shared-memory report.
3. each kernel against its plain version at the main path's shapes.
4. each kernel's time (CUDA events) beside its plain version, one PyTorch
   library call and the card's bound; one ``{"kernels": [...]}`` line.
5. MILO's main path at full width through ``MiloSession(use_pallas=True)``:
   CIFAR-10's geometry (50,000 training rows in 10 classes, 10,000 test
   rows, d = 768, the ViT-B embedding width), preprocess with the paper's
   defaults, 12 training epochs; phase times, kernel launch counts, peak
   memory, test accuracy, artifact round trip.
6. kernel route against plain route on one class: Gram, WRE importance,
   SGE graph-cut objective per bank slot.

The last line is ``{"ok": true, "device": {"platform": "gpu", ...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
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


def phase_build() -> None:
    from repro_torch.kernels import _build

    log("== phase 2: build")
    t0 = time.perf_counter()
    lib, report = _build.build()
    log(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s")
    log(report)


def phase_kernel_checks(dev) -> float:
    from repro_torch.kernels.similarity.ref import similarity_ref
    from repro_torch.kernels.similarity.similarity import similarity_cuda

    log("== phase 3: kernel against plain version")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
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
        f"(expected sum_c ceil(n_c/{block}) = {expected})")
    log(f"max_memory_allocated: {peak if peak is None else f'{peak / 2**20:.1f} MiB'}")

    k = md.k
    assert md.sge_subsets.shape == (session.config.n_sge_subsets, k), md.sge_subsets.shape
    assert all(len(np.unique(s)) == k and s.min() >= 0 and s.max() < len(x)
               for s in md.sge_subsets), "bank slots are subsets of the training set"
    assert np.isfinite(md.wre_importance).all() and np.isfinite(md.wre_probs).all()
    assert (md.wre_probs >= 0).all() and abs(float(md.wre_probs.sum()) - 1.0) < 1e-4
    assert report.final_acc >= 0.5, f"test accuracy {report.final_acc} is near chance"
    if dev.type == "cuda":
        assert launches == expected, f"{launches} similarity launches, expected {expected}"
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "milo.npz")
        md.save(path)
        back = MiloMetadata.load(path, expected_hash=md.config_hash())
        assert back.config_hash() == md.config_hash()
        np.testing.assert_array_equal(back.sge_subsets, md.sge_subsets)
    log(f"artifact round trip: config_hash {md.config_hash()} reloads equal")
    return dict(x=x, y=y, launches=launches, session=session)


def phase_routes(dev, x: np.ndarray, y: np.ndarray, session) -> None:
    from repro_torch.core import greedy, submodular
    from repro_torch.core.milo import _next_pow2
    from repro_torch.core.similarity import gram_matrix_blocked

    log("== phase 6: kernel route against plain route on class 0")
    cfg = session.config
    feats = x[y == 0]
    n_c = len(feats)
    k_c = max(1, int(round(cfg.subset_fraction * n_c)))
    n_pad = _next_pow2(n_c)
    k_run = min(n_pad, _next_pow2(k_c))
    z = torch.as_tensor(feats, device=dev)
    A_k = gram_matrix_blocked(z, block=cfg.gram_block, use_pallas=True, n_pad=n_pad)
    A_p = gram_matrix_blocked(z, block=cfg.gram_block, use_pallas=False, n_pad=n_pad)
    err = float((A_k - A_p).abs().max())
    log(f"gram ({n_c} rows, padded to {n_pad}): max_abs_err {err:.3e}")
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run phases 1, 5 and 6 on the CPU at a tiny size (tests only)")
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
        log(f"total {time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"ok": True, "rehearsal": "cpu"}))
        return 0

    dev = torch.device("cuda")
    phase_build()
    err = phase_kernel_checks(dev)
    timing = phase_kernel_timing(dev, dev_info["smi"])
    main_run = phase_main_path(dev, n=60000, n_classes=10, dim=768, epochs=12)
    phase_routes(dev, main_run["x"], main_run["y"], main_run["session"])
    kernels = [{
        "name": "similarity",
        "route": "cuda",
        "source": "src/repro_torch/csrc/similarity.cu",
        "replaces": "src/repro/kernels/similarity/similarity.py:39",
        "launches": main_run["launches"],
        "max_abs_err": err,
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(dev_info["smi"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev_info["kind"],
                                             "count": dev_info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
