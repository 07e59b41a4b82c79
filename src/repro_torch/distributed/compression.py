"""Payload compression for slow links (port of
``repro.distributed.compression``).

Two schemes, both with *error feedback* so compression noise does not bias
what accumulates ([Seide'14, Karimireddy'19]):

  * int8 symmetric per-tensor quantization (stochastic rounding when a
    ``torch.Generator`` is given, the reference's ``key=``),
  * top-k magnitude sparsification (configurable density).

``CheckedPayload`` adds an integrity layer for payloads that cross a wire:
the int8 tensor carries a position-weighted int32 checksum computed
*before* the collective and re-verified *after* it, so a corrupted transfer
is detected instead of silently skewing every gain downstream.  The
mismatch poisons the decompressed value with NaN (``decompress_checked``);
``check_payload`` raises ``CompressionIntegrityError``.  The sharded
selection engines (``core.sharded``) use it for their compressed
cross-rank sums.

The checksum is the reference's bit for bit: its int32 arithmetic wraps, so
here it is computed in int64 and reduced modulo 2³² (a ring homomorphism:
the same residue), then read as a signed int32.  ``torch.round`` and
``jnp.round`` both round half to even.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as T


class Int8Compressed(NamedTuple):
    q: torch.Tensor       # int8 payload
    scale: torch.Tensor   # per-tensor scale ()


def int8_compress(x: torch.Tensor, generator: torch.Generator | None = None) -> Int8Compressed:
    """Symmetric per-tensor int8 quantization (stochastic if a generator is
    given: uniform noise in [-0.5, 0.5) before rounding)."""
    q, scale = int8_compress_rows(x.reshape(1, -1), generator)
    return Int8Compressed(q.reshape(x.shape), scale[0])


def int8_compress_rows(x: torch.Tensor, generator: torch.Generator | None = None,
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """``int8_compress`` of each row of a (B, n) tensor on its own: the
    (B, n) int8 block and the (B,) scales."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(-1), min=1e-12) / 127.0
    y = x32 / scale[..., None]
    if generator is not None:
        y = y + (torch.rand(y.shape, generator=generator, device=y.device) - 0.5)
    q = torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return q, scale


def int8_decompress(c: Int8Compressed, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (c.q.float() * c.scale).to(dtype)


def topk_compress(x: torch.Tensor, density: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Keep the top ``density`` fraction by magnitude; returns (values, idx)."""
    flat = x.reshape(-1).float()
    k = max(1, int(flat.shape[0] * density))
    idx = flat.abs().topk(k).indices
    return flat[idx], idx


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor, shape,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
    out[idx] = vals.float()
    return out.reshape(shape).to(dtype)


class CompressionIntegrityError(RuntimeError):
    """A compressed payload's checksum disagrees with its contents — the
    collective (or storage) corrupted it in flight."""


class CheckedPayload(NamedTuple):
    q: torch.Tensor         # int8 payload
    scale: torch.Tensor     # per-tensor scale ()
    checksum: torch.Tensor  # () int32 position-weighted fold of ``q``


# odd multiplier (Knuth) so equal-magnitude flips at different positions
# cannot cancel; the reference's int32 arithmetic wraps
_CHECKSUM_MULT = 2654435761 & 0x7FFFFFFF
_MASK32 = (1 << 32) - 1


def payload_checksums(q: torch.Tensor) -> torch.Tensor:
    """``payload_checksum`` of every row (last axis) of an int8 block: the
    leading shape's int32 checksums."""
    flat = q.reshape(q.shape[:-1] + (-1,)).to(torch.int64)
    pos = torch.arange(flat.shape[-1], dtype=torch.int64, device=flat.device)
    weights = ((pos * _CHECKSUM_MULT) & _MASK32) | 1
    weights = torch.where(weights >= 1 << 31, weights - (1 << 32), weights)  # as int32
    s = (flat * weights).sum(-1) & _MASK32        # int64 wraps mod 2^64: same residue
    return torch.where(s >= 1 << 31, s - (1 << 32), s).to(torch.int32)


def payload_checksum(q: torch.Tensor) -> torch.Tensor:
    """Deterministic int32 checksum of an int8 payload: position-weighted so
    both value flips and transpositions change the fold; integer math, so
    the pre-send and post-receive computations agree on every backend."""
    return payload_checksums(q.reshape(-1))


def int8_compress_checked(x: torch.Tensor,
                          generator: torch.Generator | None = None) -> CheckedPayload:
    """``int8_compress`` plus the integrity checksum, stamped pre-send."""
    c = int8_compress(x, generator)
    return CheckedPayload(c.q, c.scale, payload_checksum(c.q))


def payload_ok(p: CheckedPayload) -> torch.Tensor:
    """Bool tensor: does the payload still match its checksum?"""
    return payload_checksum(p.q) == p.checksum


def decompress_checked(p: CheckedPayload, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Decompress with integrity enforcement: on a checksum mismatch every
    element becomes NaN, so corruption cannot skew results by a
    plausible-looking epsilon (no host read)."""
    val = int8_decompress(Int8Compressed(p.q, p.scale), dtype)
    return torch.where(payload_ok(p), val, torch.full_like(val, float("nan")))


def check_payload(p: CheckedPayload) -> None:
    """Host-side integrity check; raises ``CompressionIntegrityError``."""
    if not bool(payload_ok(p)):
        raise CompressionIntegrityError(
            "compressed payload failed its integrity checksum "
            f"(stored {int(p.checksum)}, recomputed {int(payload_checksum(p.q))})"
        )


class ErrorFeedbackState(NamedTuple):
    residual: Any  # tree matching grads


def init_error_feedback(grads: Any) -> ErrorFeedbackState:
    return ErrorFeedbackState(T.map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads))


def compress_with_feedback(
    grads: Any,
    ef: ErrorFeedbackState,
    *,
    scheme: str = "int8",
    density: float = 0.01,
    generator: torch.Generator | None = None,
) -> tuple[Any, ErrorFeedbackState]:
    """Compress+decompress each leaf, accumulating the residual locally.

    Returns the *decompressed* tree (what the collective would deliver) and
    the new residual state.  With a ``generator`` every leaf's stochastic
    rounding draws from it in leaf order, so a re-seeded generator replays
    the same outputs."""

    def one(g, r):
        g32 = g.float() + r
        if scheme == "int8":
            out = int8_decompress(int8_compress(g32, generator))
        elif scheme == "topk":
            vals, idx = topk_compress(g32, density)
            out = topk_decompress(vals, idx, g32.shape)
        else:
            raise ValueError(scheme)
        return out.to(g.dtype), g32 - out

    outs, resids = [], []
    for g, r in zip(T.leaves(grads), T.leaves(ef.residual)):
        o, nr = one(g, r)
        outs.append(o)
        resids.append(nr)
    return T.unflatten(grads, outs), ErrorFeedbackState(T.unflatten(grads, resids))
