"""Port parity: the encoder-decoder and cross-attention path of
``repro_torch`` — ``attn_nc`` and ``xattn`` blocks, the encoder, whisper and
llama-3.2-vision — against the JAX reference on the CPU, with the
reference's weights carried across by ``lm.params_from_jax``.

Inputs and contexts are made with numpy from a seed and given to both
packages.  The reference runs ``attention_impl="pallas"`` in interpret mode;
the port's flash wrapper takes its plain version on CPU tensors.
Tolerances: f32 ``rtol=1e-4, atol=2e-4`` (the reference's kernel
tolerance).  bf16 (and an f32 context against bf16 weights, as the
reference's llama-vision tests feed it): an attention sublayer no farther
from the reference's bf16 result than the reference's own bf16 result lies
from its f32 one; the whole model's bf16 error against the f32 logits
within the reference's own plus one rounding flip (see
``test_bf16_forward_within_the_references_own_bf16_error``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as tattn
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.train import train_state as tts

torch.set_num_threads(1)
F32 = dict(rtol=1e-4, atol=2e-4)
ARCHS = ["whisper-small", "llama-3.2-vision-90b"]
IMPLS = ["naive", "chunked", "pallas"]


def _t(x):
    """A JAX array (or a dict of them) as the port's tensors, bit for bit."""
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return tlm._to_torch(np.asarray(x), "cpu")


def _n(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _cfgs(arch, dtype="float32", **kw):
    jcfg = dataclasses.replace(jreg.smoke(arch), dtype=dtype, **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _model(arch, dtype="float32", **kw):
    jcfg, tcfg = _cfgs(arch, dtype, **kw)
    params = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, tlm.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                                   device="cpu")


def _context(cfg, B, seed=2):
    """f32 context, as ``tests/test_models.py`` feeds it: frames of
    ``encoder_seq`` for an encoder-decoder, else ``num_context_tokens``
    patches."""
    n = cfg.encoder_seq if cfg.is_encdec else cfg.num_context_tokens
    return np.random.default_rng(seed).normal(size=(B, n, cfg.d_model)).astype(np.float32)


def _gap(a, b):
    return float(np.abs(_n(a) - _n(b)).max())


# -- attention with kv_x ------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("sq", [1, 13])
def test_cross_attention_matches(impl, sq):
    """Keys and values from a context of another length (Sk 29), non-causal,
    queries rotated and keys not (``use_rope`` at the attention level), one
    query (a decode step's) and a prompt's."""
    p = jattn.init_attention(jax.random.PRNGKey(0), 32, 4, 2, 8, jnp.float32)
    rng = np.random.default_rng(sq)
    x = jnp.asarray(rng.normal(size=(2, sq, 32)), jnp.float32)
    ctx = jnp.asarray(rng.normal(size=(2, 29, 32)), jnp.float32)
    pos = jnp.arange(sq)[None, :] + 5
    yj, _ = jattn.attention(p, x, pos, causal=False, impl=impl, kv_x=ctx, interpret=True)
    yt, _ = tattn.attention(_t(p), _t(x), _t(pos), causal=False, impl=impl, kv_x=_t(ctx))
    np.testing.assert_allclose(_n(yt), _n(yj), **F32)


@pytest.mark.parametrize("impl", IMPLS)
def test_cross_attention_with_an_f32_context_against_bf16_weights(impl):
    """Mixed dtypes: bf16 queries against the f32 keys and values an f32
    context gives (JAX promotes the projection); each impl computes what the
    reference's does on them, the result in the weights' dtype."""
    p32 = jattn.init_attention(jax.random.PRNGKey(1), 32, 4, 2, 8, jnp.float32)
    pb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p32)
    rng = np.random.default_rng(3)
    x32 = jnp.asarray(rng.normal(size=(2, 11, 32)), jnp.float32)
    ctx = jnp.asarray(rng.normal(size=(2, 29, 32)), jnp.float32)
    pos = jnp.arange(11)[None, :]
    kw = dict(causal=False, impl=impl, use_rope=False)
    yb, _ = jattn.attention(pb, x32.astype(jnp.bfloat16), pos, kv_x=ctx, interpret=True, **kw)
    y32, _ = jattn.attention(p32, x32, pos, kv_x=ctx, interpret=True, **kw)
    yt, _ = tattn.attention(_t(pb), _t(x32.astype(jnp.bfloat16)), _t(pos), kv_x=_t(ctx), **kw)
    assert yt.dtype == torch.bfloat16 and yb.dtype == jnp.bfloat16
    assert _gap(yt, yb) <= _gap(yb, y32), (_gap(yt, yb), _gap(yb, y32))


def test_flash_wrapper_upcasts_mixed_dtypes_and_counts_the_copies():
    """``ops.flash_attention`` on mixed bf16/f32 inputs: the plain route on
    the CPU computes in f32 and returns q's dtype; ``f32_operands`` (the
    card's route into the f32 kernel) copies each bf16 input once, counted."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(1, 4, 3, 16)).astype(np.float32)).bfloat16()
    k, v = (torch.from_numpy(rng.normal(size=(1, 2, 21, 16)).astype(np.float32))
            for _ in range(2))
    out = fa_ops.flash_attention(q, k, v, causal=False)
    assert out.dtype == torch.bfloat16
    ref = fa_ops.gqa_attention_ref(q.float(), k, v, causal=False).bfloat16()
    assert torch.equal(out, ref)
    before = fa_ops.copies
    ops = fa_ops.f32_operands(q, k, v)
    assert fa_ops.copies == before + 1
    assert all(t.dtype == torch.float32 for t in ops) and ops[1] is k and ops[2] is v
    assert torch.equal(ops[0], q.float())


# -- blocks ---------------------------------------------------------------------

@pytest.mark.parametrize("mixer", ["attn_nc", "xattn"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_block_matches(mixer, impl, mode):
    """An ``attn_nc`` or ``xattn`` block (+ dense FFN) in every mode: both
    run stateless in train mode (a decode step's one query against the whole
    context), their cache slot stays empty; rope on for the config, which
    cross-attention ignores."""
    jcfg, tcfg = _cfgs("llama-3.2-vision-90b", attention_impl=impl)
    bp = jblocks.init_block(jax.random.PRNGKey(5), jcfg, mixer, "dense", jnp.float32)
    rng = np.random.default_rng(6)
    s = 1 if mode == "decode" else 13
    x = jnp.asarray(rng.normal(size=(2, s, jcfg.d_model)), jnp.float32)
    ctx = jnp.asarray(rng.normal(size=(2, 8, jcfg.d_model)), jnp.float32)
    pos = jnp.arange(s)[None, :] + (13 if mode == "decode" else 0)
    jc = jblocks.init_block_cache(jcfg, mixer, 2, 24, jnp.float32)
    tc = tblocks.init_block_cache(tcfg, mixer, 2, 24, torch.float32, "cpu")
    assert jc == () and tc is None
    yj, ncj = jblocks.apply_block(bp, x, cfg=jcfg, mixer=mixer, ffn="dense", positions=pos,
                                  context=ctx if mixer == "xattn" else None, cache=jc,
                                  mode=mode, interpret=True)
    yt, nct = tblocks.apply_block(_t(bp), _t(x), cfg=tcfg, kinds=(mixer, "dense"),
                                  positions=_t(pos), cache=tc, mode=mode,
                                  context=_t(ctx) if mixer == "xattn" else None)
    np.testing.assert_allclose(_n(yt), _n(yj), **F32)
    assert ncj == () and nct is None


def test_xattn_block_without_a_context_raises():
    _, tcfg = _cfgs("llama-3.2-vision-90b")
    bp = tblocks.init_block(torch.Generator().manual_seed(0), tcfg, "xattn", "dense",
                            torch.float32)
    with pytest.raises(ValueError, match="context"):
        tblocks.apply_block(bp, torch.zeros(1, 2, tcfg.d_model), cfg=tcfg,
                            kinds=("xattn", "dense"), positions=torch.zeros(1, 2), cache=None,
                            mode="train")


@pytest.mark.parametrize("impl", IMPLS)
def test_encoder_matches(impl):
    """The encoder alone: frames cast to the activation dtype, ``attn_nc``
    blocks at positions 0..Nf-1, the final norm."""
    jcfg, tcfg, params, model = _model("whisper-small", attention_impl=impl)
    frames = _context(jcfg, 2)
    ej = jlm._run_encoder(params, jcfg, jnp.asarray(frames), True)
    et = tlm.run_encoder(model, tcfg, torch.as_tensor(frames))
    assert tuple(et.shape) == ej.shape == (2, jcfg.encoder_seq, jcfg.d_model)
    np.testing.assert_allclose(_n(et), _n(ej), **F32)


# -- the model ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", IMPLS)
def test_forward_matches(arch, impl):
    jcfg, tcfg, params, model = _model(arch, attention_impl=impl)
    tok = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 37)).astype(np.int32)
    ctx = _context(jcfg, 2)
    lj, _ = jlm.forward(params, jcfg, jnp.asarray(tok), context=jnp.asarray(ctx))
    lt, _ = tlm.forward(model, tcfg, torch.as_tensor(tok), context=torch.as_tensor(ctx))
    np.testing.assert_allclose(_n(lt), _n(lj), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_without_a_needed_context_raises(arch):
    _, tcfg, _, model = _model(arch)
    with pytest.raises(ValueError, match="context"):
        tlm.forward(model, tcfg, torch.zeros((1, 3), dtype=torch.long))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_steps_match(arch):
    """Prefill into a cache longer than the prompt, then decode steps at
    per-slot positions with the same context: logits and every cache leaf
    (the self-attention layers' K/V; none for the xattn layers)."""
    jcfg, tcfg, params, model = _model(arch, attention_impl="pallas")
    B, S, CACHE = 2, 16, 24
    tok = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, S + 3)).astype(np.int32)
    ctx = _context(jcfg, B)
    jc = jlm.init_caches(jcfg, B, CACHE)
    lj, jc = jlm.prefill(params, jcfg, jnp.asarray(tok[:, :S]), jc, context=jnp.asarray(ctx))
    tc = tlm.init_caches(tcfg, B, CACHE, "cpu")
    lt, tc = tlm.prefill(model, tcfg, torch.as_tensor(tok[:, :S]), tc,
                         context=torch.as_tensor(ctx))
    np.testing.assert_allclose(_n(lt), _n(lj), **F32)
    for step in range(3):
        pos = np.full((B,), S + step, np.int32)
        nxt = tok[:, S + step:S + step + 1]
        lj, jc = jlm.decode_step(params, jcfg, jnp.asarray(nxt), jc, jnp.asarray(pos),
                                 context=jnp.asarray(ctx))
        lt, tc = tlm.decode_step(model, tcfg, torch.as_tensor(nxt), tc, pos,
                                 context=torch.as_tensor(ctx))
        np.testing.assert_allclose(_n(lt), _n(lj), **F32)
    for layer, (mixer, _) in enumerate(tlm.layer_kinds(tcfg)):
        g, i = divmod(layer, len(tcfg.pattern))
        if mixer == "xattn":
            assert tc[layer] is None and jc[i] == ()
            continue
        np.testing.assert_allclose(_n(tc[layer].k), np.asarray(jc[i].k)[g], **F32)
        np.testing.assert_allclose(_n(tc[layer].v), np.asarray(jc[i].v)[g], **F32)
        np.testing.assert_array_equal(tc[layer].length.numpy(), np.asarray(jc[i].length)[g])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_full_forward(arch, dtype):
    """``tests/test_models.py``'s ``test_decode_matches_full_forward`` on the
    port (relative error < 0.02; f32 far tighter), on the reference's
    weights, with the pallas impl (the serving route)."""
    _, tcfg, _, model = _model(arch, dtype, attention_impl="pallas")
    B, S, CACHE = 2, 16, 24
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, S + 1)))
    ctx = torch.as_tensor(_context(tcfg, B))
    full, _ = tlm.forward(model, tcfg, tok, context=ctx)
    caches = tlm.init_caches(tcfg, B, CACHE, "cpu")
    _, caches = tlm.prefill(model, tcfg, tok[:, :S], caches, context=ctx)
    dec, _ = tlm.decode_step(model, tcfg, tok[:, S:S + 1], caches, S, context=ctx)
    rel = float((dec[:, 0].float() - full[:, S].float()).abs().max()) / (
        float(full[:, S].float().abs().max()) + 1e-9)
    assert rel < (1e-5 if dtype == "float32" else 0.02), rel


def _ulp(x: float) -> float:
    """One bf16 unit in the last place at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_within_the_references_own_bf16_error(arch):
    """bf16 weights and the f32 context (llama-vision's xattn keys and
    values are f32 in both packages; whisper's encoder casts the frames).

    The two frameworks round bf16 products at other points (some 80% of
    these logits differ in their last bits between them, yi-6b's too), so
    the measure is each package's bf16 error against the f32 logits of the
    same weights: the port's largest is within the reference's largest plus
    one bf16 unit in the last place at the logits' scale (one rounding
    flip), and its mean within 10% of the reference's (measured: within
    5%)."""
    jcfg, tcfg, params, model = _model(arch, "bfloat16", attention_impl="pallas")
    tok = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 29)).astype(np.int32)
    ctx = _context(jcfg, 2)
    lb, _ = jlm.forward(params, jcfg, jnp.asarray(tok), context=jnp.asarray(ctx))
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    l32, _ = jlm.forward(p32, dataclasses.replace(jcfg, dtype="float32"), jnp.asarray(tok),
                         context=jnp.asarray(ctx))
    lt, _ = tlm.forward(model, tcfg, torch.as_tensor(tok), context=torch.as_tensor(ctx))
    assert lt.dtype == torch.bfloat16
    port, ref = np.abs(_n(lt) - _n(l32)), np.abs(_n(lb) - _n(l32))
    ulp = _ulp(float(np.abs(_n(l32)).max()))
    assert port.max() <= ref.max() + ulp, (port.max(), ref.max(), ulp)
    assert port.mean() <= 1.1 * ref.mean(), (port.mean(), ref.mean())


def _assert_tree_close(j_tree, t_tree, tol):
    """A reference params tree against the port's training tree."""
    tj = tlm.params_to_jax(t_tree)
    paths = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    tleaves = jax.tree.leaves(tj)
    assert len(paths) == len(tleaves)
    for (path, a), b in zip(paths, tleaves):
        assert b.shape == a.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(np.asarray(b, np.float32), np.asarray(a, np.float32),
                                   err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_and_gradients_match(arch, impl, remat):
    """Loss and every gradient leaf (the encoder's included) against
    ``jax.value_and_grad``, the context in ``batch["context"]``, with plan
    weights and a loss mask."""
    jcfg, tcfg = _cfgs(arch, attention_impl=impl, remat=remat)
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, jcfg.vocab_size, (3, 41)).astype(np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:],
             "weights": rng.uniform(0.2, 2.0, 3).astype(np.float32),
             "loss_mask": (rng.random((3, 40)) > 0.2).astype(np.float32),
             "context": _context(jcfg, 3)}
    (jl, _), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    tp = tlm.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tl, tg = tts._loss_and_grads(tp, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), **F32)
    _assert_tree_close(jg, tg, F32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_gives_the_references_tree(arch, dtype):
    """``params_to_jax(params_from_jax(p))`` is the reference's tree, leaf
    for leaf and bit for bit, the encoder's stacked layers included."""
    _, tcfg, params, model = _model(arch, dtype)
    assert ("encoder" in model) == tcfg.is_encdec
    back = tlm.params_to_jax(model)
    jflat = jax.tree_util.tree_flatten_with_path(params)[0]
    tflat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [jax.tree_util.keystr(p) for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        a = np.asarray(a)
        assert b.shape == a.shape, jax.tree_util.keystr(path)
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(b.view(np.int16), a.view(np.int16))
        else:
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_has_the_references_leaves(arch):
    """The port's own draws, in the reference's layout: every leaf's path,
    shape and dtype (the encoder's subtree included)."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jshapes = jax.eval_shape(lambda: jlm.init_lm(jax.random.PRNGKey(0), jcfg))
    tflat = jax.tree_util.tree_flatten_with_path(
        tlm.params_to_jax(tlm.init_lm(tcfg, seed=0, device="cpu")))[0]
    jflat = jax.tree_util.tree_flatten_with_path(jshapes)[0]
    assert len(jflat) == len(tflat)
    for (pj, a), (pt, b) in zip(jflat, tflat):
        assert jax.tree_util.keystr(pj) == jax.tree_util.keystr(pt)
        assert b.shape == a.shape, jax.tree_util.keystr(pj)
        assert (b.dtype == np.dtype("V2")) == (a.dtype == jnp.bfloat16), jax.tree_util.keystr(pj)
