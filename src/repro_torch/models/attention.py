"""GQA attention: the port of ``repro/models/attention.py``.

Inner implementations:

  * ``naive``   — materialised scores in f32; the plain version of the path,
                  and every decode step of ``naive`` and ``pallas`` (as in
                  the reference, whose flash kernel takes one scalar key
                  count, not per-slot lengths);
  * ``chunked`` (the presets' default) — the reference's pure-JAX flash: an
                  online softmax over ``block``-key blocks, an explicit loop
                  of plain tensor ops here, bf16 operands with f32
                  accumulation, each block step recomputed in backward
                  (``torch.utils.checkpoint``, the reference's
                  ``jax.checkpoint``); every mode, decode included.  On the
                  card, bf16 self-attention without key lengths (q, k and v
                  bf16 CUDA tensors with data, Sq = Sk, D <= 128 and
                  D % 8 == 0) takes the fused pair instead: the flash
                  kernel's train instance and its backward
                  (``kernels/flash_attention``), through one autograd
                  function, on the same operands (q / √d rounded to bf16, k,
                  v), f32 scores and sums, p rounded to bf16 before p·v, and
                  128-key tiles in place of ``block``.  Everything else (the
                  CPU, f32, decode's key lengths, cross-attention, fake
                  tensors) keeps the loop;
  * ``pallas``  — the hand-written CUDA flash-attention kernel
                  (``kernels/flash_attention``), prefill and train modes.  It
                  has no backward (the reference cannot differentiate its
                  Pallas kernel either): under autograd it raises.

Modes: ``train`` (full causal self-attention), ``prefill`` (train, and
returns K/V for the cache), ``decode`` (new tokens against a fixed-size
cache, written in place at each slot's own length).  KV heads are not
repeated in memory on either path.

QK-norm (``q_norm`` and ``k_norm`` in the weights, each (Dh,) f32): a
per-head RMSNorm of the queries and of the keys, f32 statistics, before the
rotary embedding (LFM2's attention).

Cross-attention (``kv_x``): keys and values are projected from the context
and are not rotated.  A context in another dtype than the weights is
promoted as JAX promotes it (an f32 context gives f32 keys and values
against bf16 queries); each inner implementation then computes what the
reference's does on such mixed inputs.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.device import has_data
from repro_torch.distributed.sharding import ambient_mesh, constrain, maybe
from repro_torch.kernels._shards import as_dtensor
from repro_torch.kernels.flash_attention import flash_attention as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope, init_dense, rms_norm

NEG_INF = -1e30


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # (B, S_max, Hkv, D)
    v: torch.Tensor        # (B, S_max, Hkv, D)
    length: torch.Tensor   # (B,) int32 — valid positions of each slot


def init_attention(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   dtype=torch.bfloat16, *, qk_norm: bool = False) -> dict:
    p = {
        "wq": init_dense(gen, d_model, n_heads * head_dim, dtype).reshape(d_model, n_heads, head_dim),
        "wk": init_dense(gen, d_model, n_kv * head_dim, dtype).reshape(d_model, n_kv, head_dim),
        "wv": init_dense(gen, d_model, n_kv * head_dim, dtype).reshape(d_model, n_kv, head_dim),
        "wo": init_dense(gen, n_heads * head_dim, d_model, dtype).reshape(n_heads, head_dim, d_model),
    }
    if qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = torch.ones((head_dim,), dtype=torch.float32, device=gen.device)
    return p


def _naive_attn(q, k, v, *, causal: bool, k_len: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, Hkv, D) → (B, Sq, H, D) in q's dtype.

    ``k_len`` may be a scalar or (B,): per-slot cache lengths (batched decode).
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    qg = q.float().reshape(b, sq, hkv, group, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    logits = logits * (1.0 / (d ** 0.5))
    kj = torch.arange(sk, device=q.device)
    mask = torch.ones((1, 1, 1, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        mask = mask & (kj[None, :] <= qi)[None, None, None]
    if k_len is not None:
        kl = torch.as_tensor(k_len, device=q.device)
        if kl.dim() == 0:
            mask = mask & (kj < kl)[None, None, None, None, :]
        else:
            mask = mask & (kj[None, :] < kl[:, None])[:, None, None, None, :]
    logits = torch.where(mask, logits, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)


def _as_operand(t: torch.Tensor, op_dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to the operand dtype, held in f32: a product of two such
    values is exact in f32, so an f32 contraction of them is the reference's
    bf16-operand, f32-accumulation ``einsum``."""
    return t.to(op_dtype).float()


def _clamped_sum(lo: int, hi: int, w: int) -> int:
    """Σ min(max(a, 0), w) over the integers a in [lo, hi]."""
    def run(p, q):  # Σ a over [p, q]
        return (p + q) * (q - p + 1) // 2 if q >= p else 0

    return run(max(lo, 1), min(hi, w)) + w * max(0, hi - max(lo, w + 1) + 1)


def _count_block(shape, k0: int, msk, *, causal: bool, offset: int, valid_len) -> None:
    """The counters of one block step over scores of ``shape`` (B, Hkv, G,
    Sq, block): ``attn.block_steps``; ``attn.pairs_computed``, the (query,
    key) pairs of every head scored; ``attn.pairs_kept``, those the causal
    mask and the valid length keep.  With a Python ``valid_len`` the kept
    count is worked out on the host; per-slot lengths (a tensor) are counted
    on the device and read when the counters are."""
    b, hkv, g, sq, block = shape
    heads = b * hkv * g
    obs.count("attn.block_steps", 1)
    obs.count("attn.pairs_computed", heads * sq * block)
    if torch.is_tensor(valid_len):
        kept = msk.expand(msk.shape[0], 1, 1, sq, block).sum() * (hkv * g)
        obs.count("attn.pairs_kept", kept * (b // msk.shape[0]))
        return
    w = max(0, min(k0 + block, valid_len) - k0)      # keys below the valid length
    if causal:   # row r keeps the keys k0 .. r + offset
        kept = _clamped_sum(offset + 1 - k0, sq + offset - k0, w)
    else:
        kept = sq * w
    obs.count("attn.pairs_kept", heads * kept)


def _chunk_step(qg, m, l, acc, kblk, vblk, k0: int, *, op_dtype, causal: bool, offset: int,
                valid_len):
    """One KV block of the online softmax: (m, l, acc) → (m, l, acc)."""
    block = kblk.shape[1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, _as_operand(kblk, op_dtype))
    cols = k0 + torch.arange(block, device=qg.device)
    if not torch.is_tensor(valid_len) or valid_len.dim() == 0:
        msk = (cols < valid_len)[None, None, None, None, :]
    else:  # per-slot (B,)
        msk = (cols[None, :] < valid_len[:, None])[:, None, None, None, :]
    if causal:
        rows = torch.arange(qg.shape[1], device=qg.device)[:, None] + offset
        msk = msk & (cols[None, :] <= rows)[None, None, None]
    s = torch.where(msk, s, torch.full((), NEG_INF, device=s.device))
    if obs.recording():
        _count_block(s.shape, k0, msk, causal=causal, offset=offset, valid_len=valid_len)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + torch.sum(p, dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bhgqk,bkhd->bhgqd", _as_operand(p, op_dtype), _as_operand(vblk, op_dtype))
    return m_new, l_new, acc_new


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and has_data(t)


def _fused_route(q, k, v, *, k_len, op_dtype) -> bool:
    """Whether ``_chunked_attn`` takes the fused kernels (module
    docstring): decided from the inputs alone."""
    d = q.shape[-1]
    return (k_len is None and op_dtype == torch.bfloat16 and q.shape[1] == k.shape[1]
            and d <= fa_kernel.D_MAX and d % 8 == 0 and min(q.numel(), k.numel()) > 0
            and all(t.dtype == torch.bfloat16 and _on_card(t) for t in (q, k, v)))


def _count_fused(shape, causal: bool, plans: tuple[bool, ...]) -> None:
    """The attention counters of fused kernels over one (B, Hq, S, D) call,
    one pass over the scores for each entry of ``plans`` (whether that
    kernel walks them by keys, as the dK/dV kernel does): a block step is one
    128-row query tile's pass over its key tiles, per head;
    ``pairs_computed`` the pairs the kernels' warpgroups score
    (``scored_pairs``); ``pairs_kept`` the causal count."""
    b, h, s, _ = shape
    heads = b * h
    obs.count("attn.block_steps", heads * -(-s // fa_kernel.BQ_BF16) * len(plans))
    obs.count("attn.pairs_computed",
              heads * sum(fa_kernel.scored_pairs(s, causal, by_keys) for by_keys in plans))
    kept = _clamped_sum(1, s, s) if causal else s * s
    obs.count("attn.pairs_kept", heads * kept * len(plans))


def _fused_forward(q, k, v, *, causal: bool, for_backward: bool):
    """The train kernel's forward, counted: (o, o_lo, lse), the last two
    None where no backward follows."""
    res = fa_kernel.flash_attention_train_cuda(q, k, v, causal=causal, for_backward=for_backward)
    if obs.recording():
        obs.count("attn.fused_calls", 1)
        _count_fused(q.shape, causal, (False,))
    return res


class _FusedAttention(torch.autograd.Function):
    """The fused flash-attention pair at scale 1: q (B, Hq, S, D), k and v
    (B, Hkv, S, D), bf16 and TMA-ready."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, out_lo, lse = _fused_forward(q, k, v, causal=causal, for_backward=True)
        ctx.save_for_backward(q, k, v, out, out_lo, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, out_lo, lse = ctx.saved_tensors
        if 0 in dout.stride():   # a broadcast gradient (of a sum) has no rows to map
            dout = dout.contiguous()
        (dout,) = fa_ops.tma_operands(dout, names=("dout",))
        dq, dk, dv = fa_kernel.flash_attention_bwd_cuda(q, k, v, out, out_lo, lse, dout,
                                                        causal=ctx.causal)
        if obs.recording():   # the dK/dV kernel's and the dQ kernel's score passes
            _count_fused(q.shape, ctx.causal, (True, False))
        return dq, dk, dv, None


def _fused_attn(q, k, v, *, causal: bool) -> torch.Tensor:
    """(B, S, H, D) activations through ``_FusedAttention``, or, where no
    gradient can reach q, k or v (serving's prefill, an encoder under
    ``no_grad``), through the forward alone, which writes no lse and no
    remainder.  The kernels read the activations through strides; a view
    TMA cannot address is copied, counted in ``fa_ops.copies``."""
    q, k, v = fa_ops.tma_operands(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FusedAttention.apply(q, k, v, causal).transpose(1, 2)
    return _fused_forward(q, k, v, causal=causal, for_backward=False)[0].transpose(1, 2)


def _chunked_attn(q, k, v, *, causal: bool, block: int = 512, k_len=None,
                  bf16_operands: bool = True) -> torch.Tensor:
    """The ``chunked`` route: the fused kernels where ``_fused_route``
    admits the inputs, else the loop (``_chunked_loop``).  Both divide q by
    √d rounded to q's dtype, in q's dtype."""
    op_dtype = q.dtype if (bf16_operands and q.dtype == torch.bfloat16) else torch.float32
    if _fused_route(q, k, v, k_len=k_len, op_dtype=op_dtype):
        return _fused_attn(q / _sqrt_d(q), k, v, causal=causal)
    return _chunked_loop(q, k, v, causal=causal, block=block, k_len=k_len, op_dtype=op_dtype)


def _sqrt_d(q: torch.Tensor) -> float:
    """√d rounded to q's dtype, as the reference divides by it; a Python
    number, since a tensor made from one on the card is a host-to-device
    copy, which waits for the stream, in every layer."""
    return torch.tensor(q.shape[-1] ** 0.5, dtype=q.dtype).item()


def _chunked_loop(q, k, v, *, causal: bool, block: int, k_len, op_dtype) -> torch.Tensor:
    """Online-softmax attention over KV blocks of ``block`` keys (the
    reference's ``_chunked_attn``).  bf16 operands stay bf16-valued, the
    scores, (m, l, acc) and both contractions are f32.  Under autograd each
    block step is recomputed in backward instead of saving its
    (B, Hkv, G, Sq, block) scores."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    pad = (-sk) % block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qg = _as_operand((q / _sqrt_d(q)).reshape(b, sq, hkv, group, d), op_dtype)
    valid_len = sk if k_len is None else torch.as_tensor(k_len, device=q.device)
    m = torch.full((b, hkv, group, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, group, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, group, sq, d), dtype=torch.float32, device=q.device)
    kw = dict(op_dtype=op_dtype, causal=causal, offset=sk - sq, valid_len=valid_len)
    remat = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    for k0 in range(0, k.shape[1], block):
        kblk, vblk = k[:, k0:k0 + block], v[:, k0:k0 + block]
        if remat:
            m, l, acc = checkpoint(_chunk_step, qg, m, l, acc, kblk, vblk, k0,
                                   use_reentrant=False, **kw)
        else:
            m, l, acc = _chunk_step(qg, m, l, acc, kblk, vblk, k0, **kw)
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def _pallas_attn(q, k, v, *, causal: bool) -> torch.Tensor:
    """The flash kernel on (B, S, H, D) activations: the kernel reads them
    through strides, so the head/sequence swap is a view, not a copy."""
    out = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 causal=causal)
    return out.transpose(1, 2)


def _inner_attn(q, k, v, *, impl: str, mode: str, causal: bool, block: int, k_len):
    """q (B, Sq, H, D), k and v (B, Sk, Hkv, D) → (B, Sq, H, D) by ``impl``
    (decode steps of ``naive`` and ``pallas`` take the naive route)."""
    if impl == "chunked":
        return _chunked_attn(q, k, v, causal=causal, block=block, k_len=k_len)
    if impl == "naive" or mode == "decode":
        return _naive_attn(q, k, v, causal=causal, k_len=k_len)
    return _pallas_attn(q, k, v, causal=causal)


def _project(src: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """src (B, S, D) @ w (D, H, Dh) → (B, S, H, Dh), in the promoted dtype
    of the two (as JAX's ``einsum`` promotes an f32 context against bf16
    weights)."""
    dt = torch.promote_types(src.dtype, w.dtype)
    return _split_heads(src.to(dt) @ _flat(w).to(dt), w.shape[1])


def _flat(w: torch.Tensor, *, out: bool = False) -> torch.Tensor:
    """A (D, H, Dh) projection as (D, H·Dh), or with ``out`` the (H, Dh, D)
    output projection as (H·Dh, D).  Under a mesh it is laid out so that a
    split of H·Dh falls on whole heads (``model`` only where H divides it),
    here and for its gradient: a split that H does not take evenly cannot
    be viewed back as (H, Dh)."""
    mesh = ambient_mesh()
    if out:
        w2 = w.reshape(-1, w.shape[2])
        return w2 if mesh is None else constrain(w2, maybe(mesh, w.shape[0], "model"), "data")
    w2 = w.reshape(w.shape[0], -1)
    return w2 if mesh is None else constrain(w2, "data", maybe(mesh, w.shape[1], "model"))


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, Dh) → (B, S, H·Dh), the flat result laid out on whole heads
    under a mesh (``_flat``), and so its gradient."""
    b, s, h, hd = t.shape
    mesh = ambient_mesh()
    if mesh is None:
        return t.reshape(b, s, h * hd)
    t = constrain(t, "batch", None, "model", None)
    return constrain(t.reshape(b, s, h * hd), "batch", None, maybe(mesh, h, "model"))


def _split_heads(y: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, H·Dh) → (B, S, H, Dh), laid out as the reference's projection
    (the batch split, the heads over ``model`` where they divide it), the
    flat product first on whole heads (``_flat``)."""
    mesh = ambient_mesh()
    if mesh is not None:
        y = constrain(y, "batch", None, maybe(mesh, heads, "model"))
    b, s, hd = y.shape
    return constrain(y.view(b, s, heads, hd // heads), "batch", None, "model", None)


def _write_cache(cache: KVCache, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write the new keys and values of every slot at its own length, in
    place.  The reference's ``dynamic_update_slice`` clamps an index past the
    end; this raises instead (on the card, ``lm.decode_step`` checks the
    lengths once per step on the host, and an index past the end that gets
    here anyway stops the launch with a device-side assertion)."""
    bsz, s = k.shape[:2]
    s_max = cache.k.shape[1]
    idx = cache.length.long()
    if isinstance(cache.k, DTensor):
        return _write_cache_shards(cache, k, v)
    if idx.device.type == "cpu" and has_data(idx) and bool((idx + s > s_max).any()):
        raise ValueError(f"cache write at lengths {idx.tolist()} + {s} past the cache's {s_max} "
                         "positions")
    rows = torch.arange(bsz, device=k.device)[:, None]
    cols = idx[:, None] + torch.arange(s, device=k.device)[None, :]
    cache.k[rows, cols] = k.to(cache.k.dtype)
    cache.v[rows, cols] = v.to(cache.v.dtype)


def _write_cache_shards(cache: KVCache, k: torch.Tensor, v: torch.Tensor) -> None:
    """``_write_cache`` for a cache of DTensors (laid out by
    ``sharding.cache_spec``).  A cache split over the batch and the heads is
    written in place on each rank's local shard, at its own slots' lengths.
    A cache split over the sequence (long-context decode with a tiny batch)
    takes one new position a step, selected into the positions of every
    shard (out of place: ``cache.k`` and ``cache.v`` become new tensors)."""
    mesh, pls = cache.k.device_mesh, cache.k.placements
    k, v = (t.to(cache.k.dtype) for t in (k, v))
    if any(isinstance(p, Shard) and p.dim == 1 for p in pls):
        if k.shape[1] != 1:
            raise NotImplementedError("a sequence-split cache takes one new position a step")
        at = cache.length.long()[:, None] == torch.arange(cache.k.shape[1], device=k.device)
        cache.k = torch.where(at[:, :, None, None], k, cache.k)
        cache.v = torch.where(at[:, :, None, None], v, cache.v)
        return
    rows_pls = [p if isinstance(p, Shard) and p.dim == 0 else Replicate() for p in pls]
    idx = as_dtensor(cache.length, mesh).redistribute(mesh, rows_pls).to_local().long()
    kl, vl = (as_dtensor(t, mesh).redistribute(mesh, pls).to_local() for t in (k, v))
    rows = torch.arange(kl.shape[0], device=kl.device)[:, None]
    cols = idx[:, None] + torch.arange(kl.shape[1], device=kl.device)[None, :]
    cache.k.to_local()[rows, cols] = kl
    cache.v.to_local()[rows, cols] = vl


def attention(
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    impl: str = "naive",
    rope_theta: float = 10000.0,
    use_rope: bool = True,
    kv_x: torch.Tensor | None = None,
    cache: KVCache | None = None,
    mode: str = "train",
    block: int = 512,
    norm_eps: float = 1e-6,
) -> tuple[torch.Tensor, KVCache | None]:
    """Full attention sublayer: qkv projection → rope → attention → output
    projection.  Returns (output, cache): in ``prefill`` mode a new cache of
    the prompt's K/V, in ``decode`` mode ``cache`` itself, updated in place;
    None in ``train`` mode.  ``block`` is the chunked loop's KV block (the
    fused pair on the card tiles by 128 keys).
    ``kv_x`` (B, Sk, D): the cross-attention source of the keys and values
    (only queries rotate).  ``norm_eps``: the QK-norm's epsilon, where the
    weights hold ``q_norm`` and ``k_norm``."""
    if impl not in ("naive", "chunked", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown attention mode {mode!r}")
    if impl == "pallas" and mode == "train" and torch.is_grad_enabled() and (
            x.requires_grad or any(params[w].requires_grad for w in ("wq", "wk", "wv", "wo"))):
        raise NotImplementedError(
            "attention_impl='pallas' has no backward: the reference cannot differentiate its "
            "Pallas flash kernel either; train with 'chunked' or 'naive'")
    b, s, dm = x.shape
    wq, wk, wv, wo = params["wq"], params["wk"], params["wv"], params["wo"]
    q = _split_heads(x @ _flat(wq), wq.shape[1])
    k, v = (_project(x if kv_x is None else kv_x, w) for w in (wk, wv))
    if "q_norm" in params:
        q = rms_norm(q, params["q_norm"], norm_eps)
        k = rms_norm(k, params["k_norm"], norm_eps)
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        if kv_x is None:  # self-attention: keys rotate with their own positions
            k = apply_rope(k, positions, rope_theta)

    new_cache = None
    k_len = None
    if mode == "decode":
        if cache is None:
            raise ValueError("decode mode needs a cache")
        idx = cache.length
        _write_cache(cache, k, v)
        cache.length = idx + s
        new_cache = cache
        k, v = cache.k, cache.v
        k_len = idx + s
        causal = False  # masking handled by k_len (decode attends all past)
    elif mode == "prefill":
        new_cache = KVCache(k, v, torch.full((b,), s, dtype=torch.int32, device=x.device))

    if any(isinstance(t, DTensor) for t in (q, k, v)):
        # on each rank's local shards: the batch and the heads split, the
        # sequence whole, each rank's query heads with their key/value heads
        out = fa_ops.on_shards(_inner_attn, q, k, v, head_dim=2, batch_args={"k_len": k_len},
                               impl=impl, mode=mode, causal=causal, block=block)
    else:
        out = _inner_attn(q, k, v, impl=impl, mode=mode, causal=causal, block=block, k_len=k_len)
    h, hd = wo.shape[:2]
    y = _merge_heads(out.to(x.dtype)) @ _flat(wo, out=True)
    return y, new_cache
