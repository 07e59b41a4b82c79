"""Build the port's CUDA sources into one shared library and bind it.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own ``nvcc``
process, all started together, and linked into one
``build/kernels/libreprotorch_<hash>.so`` at the repo root, where the hash
covers the flags and every file under ``csrc/`` — the sources and the
headers they include — so an edited source or header builds anew, an
unchanged tree is reused.  Each source exposes plain C entry points, so no
PyTorch header is compiled (seconds, not minutes) and the library is loaded
with ``ctypes``.  Nothing here runs at import: the first kernel launch
builds, so the CPU tests import every module without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]          # src/repro_torch
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"  # <repo>/build/kernels (git-ignored)
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# -Xptxas -v: registers, shared memory and spills per kernel, kept as the report
NVCC_FLAGS = (ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_declared: set[str] = set()


def sources() -> list[Path]:
    """The files ``nvcc`` compiles: ``csrc/*.cu`` (headers are included)."""
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "build only where the CUDA toolkit is installed"
        )
    return path


def _digest() -> str:
    """Hash of the flags and of every file under ``csrc/``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(f.relative_to(CSRC).as_posix().encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, str]:
    """Compile the library unless this exact build exists; returns its path
    and the compiler's report (``-Xptxas -v`` output of every source)."""
    srcs = sources()
    lib = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for s in srcs:
            obj = Path(tmp) / f"{s.stem}.o"
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            jobs.append((s, obj, proc))
        reports = []
        for s, _, proc in jobs:
            out, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc failed on {s.name}:\n{out}")
            reports.append(f"== {s.name}\n{out.strip()}")
        staged = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, ARCH, "-shared", "-o", str(staged), *(str(o) for _, o, _ in jobs)],
            capture_output=True, text=True,
        )
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        report = "\n".join(reports)
        # log first, library last: whoever sees the library also sees its log;
        # os.replace keeps concurrent builders from reading a partial file
        log.write_text(report)
        os.replace(staged, lib)
    return lib, report


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The library's C entry point ``name`` with its ``argtypes`` declared
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits);
    every entry point returns a CUDA error code as ``c_int``."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        fn = getattr(_lib, name)
        if name not in _declared:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _declared.add(name)
    return fn


def check(code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code:
        msg = _lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
