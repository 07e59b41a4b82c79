"""Public dispatch for flash attention: the CUDA kernel for a tensor on the
card, the plain version for a tensor on the CPU (or ``use_pallas=False``).

Unlike the TPU dispatch (``repro/kernels/flash_attention/ops.py``) nothing
is padded on the model's path: the kernels mask ragged query rows, keys and
head dims themselves, and read strided q, k and v (so the model's (B, S, H,
D) activations go in without a transpose copy).  Only a bf16 input that the
tensor-core kernel's TMA maps cannot address in place — a base off 16-byte
alignment, a stride that is not a multiple of 8 elements, or D % 8 != 0 —
is copied first: exactly, into a contiguous tensor, with D zero-padded to a
multiple of 8 (zero columns add nothing to q·kᵀ, and the output's pad
columns are sliced off).  Mixed dtypes (a bf16 q against f32 keys and
values, as cross-attention to an f32 context gives them) take what the
reference's kernel computes — every input upcast to f32 in its body, the
output in q's dtype: each bf16 input is copied to f32 and the f32 kernel
runs.  ``copies`` counts all those copies and each one is logged; the
serving path makes none.

**On DTensor shards** (a mesh ambient in the models) the kernel runs on
each rank's local shard.  Attention is independent across the batch and the
heads, so those splits stay; a split of the sequence or of D, or a pending
partial sum, is redistributed first.  The query heads can be split where the
key/value heads are not (yi-6b's 32/4 heads over a model axis of 8: 4 query
heads a rank, the 4 key/value heads replicated), and the kernel pairs query
head j with key/value head j // (Hq / Hkv) of what it is given: so the
rank's query heads get the key/value heads they use in the full model
(``local_kv_heads``), a slice when they are contiguous, else a gather
(copied, counted in ``copies``).  The plain version on CPU shards does the
same.

**Fake tensors** (the dry run's ``FakeTensorMode``) have no data, so they
take the kernel's meta form, the custom op ``repro_torch::flash_attention``:
its fake implementation gives the output's shape, and its FLOP formula
(``torch.utils.flop_counter``) is the bound's, 4·Hq·D per kept (row, key)
pair.
"""
from __future__ import annotations

import logging

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.flash_attention import (
    D_MAX,
    flash_attention_cuda,
    tma_ready,
)
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import register_flop_formula

from repro_torch.device import has_data
from repro_torch.kernels import _shards
from repro_torch.kernels.flash_attention.ref import gqa_attention_ref

copies = 0
_log = logging.getLogger(__name__)


def tma_operands(*ts: torch.Tensor, names=("q", "k", "v")) -> list[torch.Tensor]:
    """q, k and v (or the tensors ``ts``, named by ``names`` in the log) as
    the bf16 kernels' TMA maps take them: each one that is not ``tma_ready``
    (or all, when D % 8 != 0: zero-padded to the next multiple of 8) becomes
    an exact contiguous copy, counted and logged."""
    global copies
    d = ts[0].shape[-1]
    pad = -d % 8
    out = []
    for name, t in zip(names, ts):
        if not pad and tma_ready(t):
            out.append(t)
            continue
        why = (f"head dim {d} padded to {d + pad}" if pad else
               f"base {t.data_ptr() % 16} bytes off 16-byte alignment, strides {t.stride()}")
        t = F.pad(t, (0, pad)) if pad else t.clone(memory_format=torch.contiguous_format)
        copies += 1
        _log.warning("flash_attention: copied %s %s for the bf16 kernel's TMA maps (%s)",
                     name, tuple(t.shape), why)
        out.append(t)
    return out


def f32_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> list[torch.Tensor]:
    """q, k and v of mixed bf16/f32 dtypes as f32: each bf16 one becomes an
    exact f32 copy, counted and logged."""
    global copies
    out = []
    for name, t in zip("qkv", (q, k, v)):
        if t.dtype == torch.bfloat16:
            copies += 1
            _log.warning("flash_attention: copied %s %s from bf16 to f32 (mixed input dtypes "
                         "%s, %s, %s)", name, tuple(t.shape), q.dtype, k.dtype, v.dtype)
            t = t.float()
        out.append(t)
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    use_pallas: bool = True,
) -> torch.Tensor:
    """Causal (or full) GQA attention: q (B, Hq, Sq, D), k and v (B, Hkv,
    Sk, D) → (B, Hq, Sq, D) in q's dtype.  A CUDA tensor launches the kernel
    (or raises); only a CPU tensor or ``use_pallas=False`` takes the plain
    version.  DTensors run on their local shards, fake tensors take the
    meta form (module docstring)."""
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        return on_shards(flash_attention, q, k, v, causal=causal, use_pallas=use_pallas)
    if not has_data(q):
        return torch.ops.repro_torch.flash_attention(q, k, v, causal)
    return _on_tensors(q, k, v, causal=causal, use_pallas=use_pallas)


def _on_tensors(q, k, v, *, causal: bool, use_pallas: bool) -> torch.Tensor:
    if not use_pallas or q.device.type == "cpu":
        return gqa_attention_ref(q, k, v, causal=causal).to(q.dtype)
    dtypes = {q.dtype, k.dtype, v.dtype}
    if len(dtypes) > 1 and dtypes <= {torch.bfloat16, torch.float32}:
        return flash_attention_cuda(*f32_operands(q, k, v), causal=causal).to(q.dtype)
    d = q.shape[-1]
    if (all(t.dtype == torch.bfloat16 and t.dim() == 4 for t in (q, k, v)) and d <= D_MAX
            and min(q.numel(), k.numel()) > 0):
        out = flash_attention_cuda(*tma_operands(q, k, v), causal=causal, scale=1.0 / d ** 0.5)
        return out if out.shape[-1] == d else out[..., :d]
    return flash_attention_cuda(q, k, v, causal=causal)


def local_kv_heads(k: torch.Tensor, v: torch.Tensor, *, hq: int, hkv: int, q_offset: int,
                   hq_local: int, kv_offset: int = 0, dim: int = 1
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The key/value heads that global query heads ``q_offset`` ..
    ``q_offset + hq_local - 1`` (of ``hq``) read, out of ``k`` and ``v``,
    whose head axis ``dim`` holds global key/value heads ``kv_offset`` ..
    ``kv_offset + n - 1`` (of ``hkv``): global query head h reads key/value
    head h // (hq / hkv).  The result makes an attention's own pairing
    (local query head j with local key/value head j // (hq_local / its
    heads)) the full model's: a slice when the heads are contiguous and
    evenly shared, else one head per query head, gathered (a copy,
    counted)."""
    global copies
    group = hq // hkv
    want = [(q_offset + j) // group - kv_offset for j in range(hq_local)]
    lo, n = want[0], want[-1] - want[0] + 1
    if hq_local % n == 0 and want == [lo + j // (hq_local // n) for j in range(hq_local)]:
        return k.narrow(dim, lo, n), v.narrow(dim, lo, n)
    idx = torch.tensor(want, device=k.device)
    copies += 2
    _log.warning("flash_attention: gathered key/value heads %s for query heads %d..%d",
                 want, q_offset, q_offset + hq_local - 1)
    return k.index_select(dim, idx), v.index_select(dim, idx)


def on_shards(fn, q, k, v, *, head_dim: int = 1, batch_args: dict | None = None, **kw):
    """``fn(q, k, v, **kw)``, an attention independent across the batch (dim
    0) and the heads (dim ``head_dim``), on each rank's local shards of
    DTensors ``q``, ``k``, ``v`` (a plain one counts as replicated); the
    result is laid out as q.  Every other split, and a pending partial sum,
    is redistributed first; key/value heads stay split only where the query
    heads are, and otherwise each rank passes the ones its query heads read
    (``local_kv_heads``).  ``batch_args``: more arguments of ``fn`` whose
    dim 0 is the batch (per-slot key lengths), cut to the rank's rows."""
    mesh = next(t.device_mesh for t in (q, k, v) if isinstance(t, DTensor))
    q, k, v = (_shards.as_dtensor(t, mesh) for t in (q, k, v))
    qp = _shards.keep(q.placements, (0, head_dim))
    kvp = []  # the batch split follows q's; key/value heads stay split where q's are
    for i, p in enumerate(_shards.keep(k.placements, (0, head_dim))):
        kvp.append(qp[i] if qp[i] == Shard(0) or (qp[i] == Shard(head_dim) and p == qp[i])
                   else Replicate())
    q = q.redistribute(mesh, qp)
    k, v = k.redistribute(mesh, kvp), v.redistribute(mesh, kvp)
    hq, hkv = q.shape[head_dim], k.shape[head_dim]
    # where the query heads are split and the key/value heads are not, each
    # rank's gradient of k and v is its own heads' part of a sum
    kvg = _shards.partial_where_split(kvp, qp, head_dim)
    ql, kl, vl = q.to_local(), k.to_local(grad_placements=kvg), v.to_local(grad_placements=kvg)
    kl, vl = local_kv_heads(kl, vl, hq=hq, hkv=hkv, q_offset=_shards.offset(mesh, qp, head_dim, hq),
                            hq_local=ql.shape[head_dim],
                            kv_offset=_shards.offset(mesh, kvp, head_dim, hkv), dim=head_dim)
    rows = _shards.follow(qp, {0: 0})
    for name, t in (batch_args or {}).items():
        if isinstance(t, torch.Tensor) and t.dim() > 0:
            t = _shards.as_dtensor(t, mesh).redistribute(mesh, rows).to_local()
        elif isinstance(t, DTensor):
            t = t.to_local()
        kw[name] = t
    return _shards.to_global(fn(ql, kl, vl, **kw), mesh, qp)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """B5 as an operator: what ``flash_attention`` computes on real tensors."""
    return _on_tensors(q, k, v, causal=causal, use_pallas=True)


@_flash_op.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


def kept_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query row, key) pairs the mask keeps: the causal mask aligned to the
    end of the key axis keeps key j for row i when j <= i + sk - sq."""
    if not causal:
        return sq * sk
    return sum(min(sk, i + sk - sq + 1) for i in range(sq)) if sq <= sk else 0


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, *args, out_shape=None, **kwargs) -> int:
    b, hq, sq, d = q_shape
    return 4 * b * hq * d * kept_pairs(sq, k_shape[2], causal)
