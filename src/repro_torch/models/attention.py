"""GQA attention: the port of ``repro/models/attention.py``, forward only.

Inner implementations:

  * ``naive``  — materialised scores in f32; the plain version of the path,
                 and every decode step (as in the reference, whose flash
                 kernel takes one scalar key count, not per-slot lengths);
  * ``pallas`` — the hand-written CUDA flash-attention kernel
                 (``kernels/flash_attention``), prefill and train modes;
  * ``chunked`` (the presets' default) is not ported: it raises.

Modes: ``train`` (full causal self-attention), ``prefill`` (train, and
returns K/V for the cache), ``decode`` (new tokens against a fixed-size
cache, written in place at each slot's own length).  KV heads are not
repeated in memory on either path.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.layers import apply_rope, init_dense

NEG_INF = -1e30


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # (B, S_max, Hkv, D)
    v: torch.Tensor        # (B, S_max, Hkv, D)
    length: torch.Tensor   # (B,) int32 — valid positions of each slot


def init_attention(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   dtype=torch.bfloat16) -> dict:
    return {
        "wq": init_dense(gen, d_model, n_heads * head_dim, dtype).reshape(d_model, n_heads, head_dim),
        "wk": init_dense(gen, d_model, n_kv * head_dim, dtype).reshape(d_model, n_kv, head_dim),
        "wv": init_dense(gen, d_model, n_kv * head_dim, dtype).reshape(d_model, n_kv, head_dim),
        "wo": init_dense(gen, n_heads * head_dim, d_model, dtype).reshape(n_heads, head_dim, d_model),
    }


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


def _pallas_attn(q, k, v, *, causal: bool) -> torch.Tensor:
    """The flash kernel on (B, S, H, D) activations: the kernel reads them
    through strides, so the head/sequence swap is a view, not a copy."""
    out = fa_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 causal=causal)
    return out.transpose(1, 2)


def _write_cache(cache: KVCache, k: torch.Tensor, v: torch.Tensor) -> None:
    """Write the new keys and values of every slot at its own length, in
    place.  The reference's ``dynamic_update_slice`` clamps an index past the
    end; this raises instead (on the card, ``lm.decode_step`` checks the
    lengths once per step on the host, and an index past the end that gets
    here anyway stops the launch with a device-side assertion)."""
    bsz, s = k.shape[:2]
    s_max = cache.k.shape[1]
    idx = cache.length.long()
    if idx.device.type == "cpu" and bool((idx + s > s_max).any()):
        raise ValueError(f"cache write at lengths {idx.tolist()} + {s} past the cache's {s_max} "
                         "positions")
    rows = torch.arange(bsz, device=k.device)[:, None]
    cols = idx[:, None] + torch.arange(s, device=k.device)[None, :]
    cache.k[rows, cols] = k.to(cache.k.dtype)
    cache.v[rows, cols] = v.to(cache.v.dtype)


def attention(
    params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    causal: bool = True,
    impl: str = "naive",
    rope_theta: float = 10000.0,
    use_rope: bool = True,
    cache: KVCache | None = None,
    mode: str = "train",
) -> tuple[torch.Tensor, KVCache | None]:
    """Full attention sublayer: qkv projection → rope → attention → output
    projection.  Returns (output, cache): in ``prefill`` mode a new cache of
    the prompt's K/V, in ``decode`` mode ``cache`` itself, updated in place;
    None in ``train`` mode."""
    if impl == "chunked":
        raise NotImplementedError(
            "attention_impl='chunked' is not ported yet (ROADMAP A12); use 'pallas' (the CUDA "
            "flash kernel) or 'naive'")
    if impl not in ("naive", "pallas"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown attention mode {mode!r}")
    b, s, dm = x.shape
    wq, wk, wv, wo = params["wq"], params["wk"], params["wv"], params["wo"]
    q = (x @ wq.reshape(dm, -1)).view(b, s, wq.shape[1], wq.shape[2])
    k = (x @ wk.reshape(dm, -1)).view(b, s, wk.shape[1], wk.shape[2])
    v = (x @ wv.reshape(dm, -1)).view(b, s, wv.shape[1], wv.shape[2])
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
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

    if impl == "naive" or mode == "decode":
        out = _naive_attn(q, k, v, causal=causal, k_len=k_len)
    else:
        out = _pallas_attn(q, k, v, causal=causal)
    h, hd = wo.shape[:2]
    y = out.to(x.dtype).reshape(b, s, h * hd) @ wo.reshape(h * hd, dm)
    return y, new_cache
