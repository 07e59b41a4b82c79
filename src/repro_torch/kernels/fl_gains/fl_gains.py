"""Wrappers of the hand-written CUDA facility-location gain kernels
(``csrc/fl_gains.cu``).

Each replaces one TPU kernel of ``repro/kernels/fl_gains/fl_gains.py``:

- ``fl_gains_cuda``: ``fl_gains_pallas``, ``g_j = Σ_i relu(K_ij − c_i)``
  over a materialised K;
- ``fl_gains_gram_free_cuda``: ``fl_gains_gram_free_pallas``, the same with
  ``K_ij = 0.5 + 0.5·zᵢ·zc_j`` built on the fly;
- ``fl_gains_gram_free_delta_cuda``: ``fl_gains_gram_free_delta_pallas``,
  ``Σ_i relu(K_ij − c_new_i) − relu(K_ij − c_old_i)`` over touched rows.

The kernels mask ragged rows, candidates and depth themselves, so no
padding copy is made.  A batch of covers (one per run of a bank) is a grid
dimension of one launch, with a batch stride of 0 for a shared operand.
Every candidate's sum follows a fixed order over the ground rows (see the
source), so repeated launches are bit-identical and a candidate's gain does
not depend on the other candidates of the launch.

The gram-free gains and the delta have two instances each, chosen inside
their C entry points.  The gram-free gains run the ring instance (the Gram
kernel's 128×128 tiles and ``cp.async`` ring, 256-row chunks whose covers
are all ``+inf`` left out) when ``d % 4 == 0`` and ``z`` and ``zc`` are
16-byte aligned, else the tiled one.  The delta runs a small-b instance for
b ≤ 64 touched rows (the lazy engine's common gathers) that streams ``zc``
at memory speed under the same alignment rule, else the tiled one.  The two
instances of a kernel give the same value bit for bit; each entry point
reports which one it launched.

``launches`` counts, per kernel, the calls that launched it, and
``gram_free_launches`` and ``delta_launches`` the launches per instance, as
the C entry points reported them; set the entries to 0 before a run to read
how many that run made.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = {"fl_gains": 0, "fl_gains_gram_free": 0, "fl_gains_gram_free_delta": 0}
gram_free_launches = {"ring": 0, "tiled": 0}
delta_launches = {"small_b": 0, "tiled": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "fl_gains_f32": [_P, _L, _L, _P, _L, _P, _P, _I, _I, _I, _P],
    "fl_gains_gram_free_f32": [_P, _P, _L, _P, _L, _P, _P, _I, _I, _I, _I,
                               ctypes.POINTER(_I), _P],
    "fl_gains_gram_free_delta_f32": [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     ctypes.POINTER(_I), _P],
}
_CHUNK = 256           # ground rows per chunk (csrc/fl_gains.cu CHUNK)
_INT_MAX = 2**31 - 1
_GRID_YZ = 65535


def _check_f32(name: str, dev: torch.device, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise _build.KernelInputError(f"{name} needs every input on one CUDA device "
                             f"(got {t.device} and {dev})")
        if t.dtype != torch.float32:
            raise _build.KernelTypeError(f"{name} takes float32 inputs (got {t.dtype})")
        if not t.is_contiguous():
            raise _build.KernelInputError(f"{name} needs contiguous row-major inputs")


def _batch(name: str, n: int, c: torch.Tensor, other: torch.Tensor, other_dim: int) -> int:
    """The launch's batch: the cover's (``c`` (n,) or (B, n)) and the other
    operand's (batched when it has ``other_dim`` dimensions); an unbatched
    operand is shared across the batch (batch stride 0)."""
    if c.dim() not in (1, 2) or c.shape[-1] != n:
        raise _build.KernelInputError(f"{name}: cover of shape {tuple(c.shape)} is not ({n},) or (B, {n})")
    batches = {t.shape[0] for t, dim in ((c, 2), (other, other_dim)) if t.dim() == dim}
    if len(batches) > 1:
        raise _build.KernelInputError(f"{name}: batch sizes {sorted(batches)} differ")
    return batches.pop() if batches else 0


def _outputs(dev, batch: int, n: int, n_cand: int) -> tuple[torch.Tensor, torch.Tensor | None]:
    n_chunks = -(-n // _CHUNK)
    if n_chunks > _GRID_YZ or batch > _GRID_YZ or max(n, n_cand) > _INT_MAX:
        raise _build.KernelInputError(f"shape (batch {batch}, n {n}, n_cand {n_cand}) exceeds the kernel's grid")
    out = torch.empty((batch, n_cand), dtype=torch.float32, device=dev)
    scratch = (torch.empty((batch, n_chunks, n_cand), dtype=torch.float32, device=dev)
               if n_chunks > 1 else None)
    return out, scratch


def _run(entry: str, args: list, dev: torch.device) -> None:
    fn = _build.function(entry, _ARGTYPES[entry])
    with torch.cuda.device(dev):
        code = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, f"{entry} launch")


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def fl_gains_gram_free_cuda(z: torch.Tensor, zc: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``z`` (n, d) ground rows, ``zc`` (n_cand, d) or (B, n_cand, d)
    candidates, ``c`` (n,) or (B, n) covers → (n_cand,) or (B, n_cand)."""
    name = "fl_gains_gram_free_cuda"
    _check_f32(name, z.device, z, zc, c)
    if z.dim() != 2 or zc.dim() not in (2, 3) or zc.shape[-1] != z.shape[1]:
        raise _build.KernelInputError(f"{name}: shapes {tuple(z.shape)} and {tuple(zc.shape)} are not "
                         "(n, d) and ([B,] n_cand, d)")
    n, d = z.shape
    n_cand = zc.shape[-2]
    batch = _batch(name, n, c, zc, 3)
    out, scratch = _outputs(z.device, max(batch, 1), n, n_cand)
    if n_cand and n:
        ring = _I()
        _run("fl_gains_gram_free_f32",
             [z.data_ptr(), zc.data_ptr(), n_cand * d if zc.dim() == 3 else 0,
              c.data_ptr(), n if c.dim() == 2 else 0, out.data_ptr(), _ptr(scratch),
              n, n_cand, d, max(batch, 1), ctypes.byref(ring)], z.device)
        launches["fl_gains_gram_free"] += 1
        gram_free_launches["ring" if ring.value else "tiled"] += 1
    else:
        out.zero_()
    return out if batch else out[0]


def fl_gains_gram_free_delta_cuda(z: torch.Tensor, zc: torch.Tensor, c_old: torch.Tensor,
                                  c_new: torch.Tensor) -> torch.Tensor:
    """``z`` (b, d) touched rows, ``zc`` (n_cand, d), ``c_old``/``c_new`` (b,)
    → (n_cand,) gain corrections."""
    name = "fl_gains_gram_free_delta_cuda"
    _check_f32(name, z.device, z, zc, c_old, c_new)
    if z.dim() != 2 or zc.dim() != 2 or zc.shape[1] != z.shape[1]:
        raise _build.KernelInputError(f"{name}: shapes {tuple(z.shape)} and {tuple(zc.shape)} are not "
                         "(b, d) and (n_cand, d)")
    b, d = z.shape
    n_cand = zc.shape[0]
    if tuple(c_old.shape) != (b,) or tuple(c_new.shape) != (b,):
        raise _build.KernelInputError(f"{name}: covers {tuple(c_old.shape)} and {tuple(c_new.shape)} "
                         f"are not ({b},)")
    out, scratch = _outputs(z.device, 1, b, n_cand)
    if n_cand and b:
        small_b = _I()
        _run("fl_gains_gram_free_delta_f32",
             [z.data_ptr(), zc.data_ptr(), c_old.data_ptr(), c_new.data_ptr(),
              out.data_ptr(), _ptr(scratch), b, n_cand, d, ctypes.byref(small_b)], z.device)
        launches["fl_gains_gram_free_delta"] += 1
        delta_launches["small_b" if small_b.value else "tiled"] += 1
    else:
        out.zero_()
    return out[0]


def fl_gains_cuda(K: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``K`` (n, n_cand) or (B, n, n_cand) with unit column stride (rows may
    be strided, batches must be dense), ``c`` (n,) or (B, n) → (n_cand,) or
    (B, n_cand)."""
    name = "fl_gains_cuda"
    _check_f32(name, K.device, c)
    if K.device != c.device or K.dtype != torch.float32:
        raise _build.KernelTypeError(f"{name} takes a float32 K on the covers' CUDA device "
                        f"(got {K.dtype} on {K.device})")
    if (K.dim() not in (2, 3) or K.stride(-1) != 1 or K.stride(-2) < K.shape[-1]
            or (K.dim() == 3 and K.stride(0) != K.shape[1] * K.stride(1))):
        raise _build.KernelInputError(f"{name}: K must be ([B,] n, n_cand) with unit column stride")
    n, n_cand = K.shape[-2:]
    batch = _batch(name, n, c, K, 3)
    out, scratch = _outputs(K.device, max(batch, 1), n, n_cand)
    if n_cand and n:
        _run("fl_gains_f32",
             [K.data_ptr(), K.stride(0) if K.dim() == 3 else 0, K.stride(-2),
              c.data_ptr(), n if c.dim() == 2 else 0, out.data_ptr(), _ptr(scratch),
              n, n_cand, max(batch, 1)], K.device)
        launches["fl_gains"] += 1
    else:
        out.zero_()
    return out if batch else out[0]
