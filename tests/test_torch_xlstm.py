"""Port parity: xLSTM's mixers (mLSTM, sLSTM) and the xlstm-125m family of
``repro_torch`` against the JAX reference on the CPU, with the reference's
weights carried across by ``lm.params_from_jax``.

Inputs are made with numpy from a seed and given to both packages.
Tolerances: f32 ``rtol=1e-4, atol=2e-4`` (the reference's kernel
tolerance).  bf16: the port's logits lie no farther from the reference's
bf16 logits than the reference's own bf16 logits lie from its f32 ones, and
greedy tokens agree up to a parting that is a near-tie by that measure.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.serve.lm_engine import Request as JRequest
from repro.serve.lm_engine import ServeEngine as JEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.serve import lm_engine as tengine
from repro_torch.train import train_state as tts

torch.set_num_threads(1)
F32 = dict(rtol=1e-4, atol=2e-4)
ARCH = "xlstm-125m"
CHUNK = 16                     # registry.smoke's ssm_chunk
LENGTHS = [7, CHUNK, 37]       # below, at and across the chunk


def _t(x):
    """A JAX array (or a dict of them) as the port's tensors, bit for bit."""
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return tlm._to_torch(np.asarray(x), "cpu")


def _n(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _cfgs(dtype="float32", **kw):
    jcfg = dataclasses.replace(jreg.smoke(ARCH), dtype=dtype, **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _model(dtype="float32", **kw):
    jcfg, tcfg = _cfgs(dtype, **kw)
    params = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, tlm.params_from_jax(jax.tree.map(np.asarray, params), tcfg,
                                                   device="cpu")


def _x(S, seed, d=32):
    # scaled up so that the gates leave their linear range
    return jnp.asarray(3.0 * np.random.default_rng(seed).normal(size=(2, S, d)), jnp.float32)


def test_init_leaves_match_the_references():
    """The port's mixers draw their own numbers, but every leaf has the
    reference's name, shape and dtype (f32 gates against bf16 projections)."""
    g = torch.Generator().manual_seed(0)
    for jp, tp in ((jssm.init_mlstm(jax.random.PRNGKey(0), 32, expand=2, head_dim=8),
                    tssm.init_mlstm(g, 32, expand=2, head_dim=8)),
                   (jssm.init_slstm(jax.random.PRNGKey(0), 32), tssm.init_slstm(g, 32))):
        assert sorted(jp) == sorted(tp)
        for k in jp:
            assert tuple(tp[k].shape) == jp[k].shape, k
            assert str(tp[k].dtype)[6:] == str(jp[k].dtype), k
    assert tssm.mlstm_state_shape(32, head_dim=8, batch=3) == jssm.mlstm_state_shape(
        32, head_dim=8, batch=3)


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mlstm_matches(S, mode):
    """Output (and the final state (B, H, P, P) at prefill) with the heads
    folded into the chunked scan's batch, against the reference's vmap."""
    p = jssm.init_mlstm(jax.random.PRNGKey(1), 32, expand=2, head_dim=8, dtype=jnp.float32)
    x = _x(S, S)
    yj, sj = jssm.mlstm(p, x, chunk=CHUNK, mode=mode)
    yt, st = tssm.mlstm(_t(p), _t(x), chunk=CHUNK, mode=mode)
    np.testing.assert_allclose(_n(yt), _n(yj), **F32)
    if mode == "prefill":
        assert tuple(st.shape) == sj.shape == (2, 8, 8, 8)
        np.testing.assert_allclose(_n(st), _n(sj), **F32)
    else:
        assert sj is None and st is None


@pytest.mark.parametrize("S", LENGTHS)
def test_mlstm_decode_after_prefill_matches(S):
    """Three one-token updates from the prefill's state."""
    p = jssm.init_mlstm(jax.random.PRNGKey(2), 32, expand=2, head_dim=8, dtype=jnp.float32)
    x = _x(S + 3, S + 100)
    _, sj = jssm.mlstm(p, x[:, :S], chunk=CHUNK, mode="prefill")
    _, st = tssm.mlstm(_t(p), _t(x[:, :S]), chunk=CHUNK, mode="prefill")
    for t in range(S, S + 3):
        yj, sj = jssm.mlstm(p, x[:, t:t + 1], state=sj, mode="decode")
        yt, st = tssm.mlstm(_t(p), _t(x[:, t:t + 1]), state=st, mode="decode")
        np.testing.assert_allclose(_n(yt), _n(yj), **F32)
        np.testing.assert_allclose(_n(st), _n(sj), **F32)
    # and decode continues the prefill: the last step against a prefill over all
    y_full, _ = tssm.mlstm(_t(p), _t(x), chunk=CHUNK, mode="train")
    np.testing.assert_allclose(_n(yt[:, 0]), _n(y_full[:, -1]), **F32)


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_slstm_matches(S, mode):
    """Output (and the final (c, n, m) at prefill): the port's loop over
    time against the reference's ``lax.scan``."""
    p = jssm.init_slstm(jax.random.PRNGKey(3), 32, dtype=jnp.float32)
    x = _x(S, S + 7)
    yj, sj = jssm.slstm(p, x, mode=mode)
    yt, st = tssm.slstm(_t(p), _t(x), mode=mode)
    np.testing.assert_allclose(_n(yt), _n(yj), **F32)
    if mode == "prefill":
        assert len(st) == len(sj) == 3
        for a, b in zip(st, sj):
            np.testing.assert_allclose(_n(a), _n(b), **F32)
    else:
        assert sj is None and st is None


@pytest.mark.parametrize("S", LENGTHS)
def test_slstm_decode_after_prefill_matches(S):
    p = jssm.init_slstm(jax.random.PRNGKey(4), 32, dtype=jnp.float32)
    x = _x(S + 3, S + 200)
    _, sj = jssm.slstm(p, x[:, :S], mode="prefill")
    _, st = tssm.slstm(_t(p), _t(x[:, :S]), mode="prefill")
    for t in range(S, S + 3):
        yj, sj = jssm.slstm(p, x[:, t:t + 1], state=sj, mode="decode")
        yt, st = tssm.slstm(_t(p), _t(x[:, t:t + 1]), state=st, mode="decode")
        np.testing.assert_allclose(_n(yt), _n(yj), **F32)
        for a, b in zip(st, sj):
            np.testing.assert_allclose(_n(a), _n(b), **F32)
    y_full, _ = tssm.slstm(_t(p), _t(x), mode="train")
    np.testing.assert_allclose(_n(yt[:, 0]), _n(y_full[:, -1]), **F32)


def test_block_caches_match_the_references():
    """``init_block_cache``: the mLSTM's zeros (B, H, P, P) and the sLSTM's
    (0, 0, -1e30), each (B, D) f32."""
    from repro.models import blocks as jblocks

    jcfg, tcfg = _cfgs()
    for mixer in ("mlstm", "slstm"):
        jc = jblocks.init_block_cache(jcfg, mixer, 3, 8, jnp.float32)
        tc = tblocks.init_block_cache(tcfg, mixer, 3, 8, torch.float32, "cpu")
        for a, b in zip(jax.tree.leaves(jc), tc if isinstance(tc, tuple) else [tc]):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_forward_matches():
    jcfg, tcfg, params, model = _model()
    tok = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 37)).astype(np.int32)
    lj, _ = jlm.forward(params, jcfg, jnp.asarray(tok))
    lt, _ = tlm.forward(model, tcfg, torch.as_tensor(tok))
    np.testing.assert_allclose(_n(lt), _n(lj), **F32)


def test_prefill_and_decode_steps_match():
    """Prefill, then decode steps at per-slot positions: logits and every
    cache leaf (mLSTM state, sLSTM (c, n, m)) match."""
    jcfg, tcfg, params, model = _model()
    B, S, CACHE = 2, 21, 32
    tok = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, S + 3)).astype(np.int32)
    jc = jlm.init_caches(jcfg, B, CACHE)
    lj, jc = jlm.prefill(params, jcfg, jnp.asarray(tok[:, :S]), jc)
    tc = tlm.init_caches(tcfg, B, CACHE, "cpu")
    lt, tc = tlm.prefill(model, tcfg, torch.as_tensor(tok[:, :S]), tc)
    np.testing.assert_allclose(_n(lt), _n(lj), **F32)
    for step in range(3):
        pos = np.full((B,), S + step, np.int32)
        nxt = tok[:, S + step:S + step + 1]
        lj, jc = jlm.decode_step(params, jcfg, jnp.asarray(nxt), jc, jnp.asarray(pos))
        lt, tc = tlm.decode_step(model, tcfg, torch.as_tensor(nxt), tc, pos)
        np.testing.assert_allclose(_n(lt), _n(lj), **F32)
    for layer, (mixer, _) in enumerate(tlm.layer_kinds(tcfg)):
        g, i = divmod(layer, len(tcfg.pattern))
        jleaves = [np.asarray(a)[g] for a in jax.tree.leaves(jc[i])]
        tleaves = list(tc[layer]) if mixer == "slstm" else [tc[layer]]
        assert len(jleaves) == len(tleaves) == (3 if mixer == "slstm" else 1)
        for a, b in zip(tleaves, jleaves):
            np.testing.assert_allclose(_n(a), b, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_full_forward(dtype):
    """tests/test_models.py's check (relative error < 0.02) on the port's
    own bf16 weights and on the reference's f32 ones."""
    if dtype == "bfloat16":
        _, tcfg = _cfgs(dtype)
        model = tlm.init_lm(tcfg, seed=0, device="cpu")
    else:
        _, tcfg, _, model = _model(dtype)
    B, S, CACHE = 2, 16, 24
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, S + 1)))
    full, _ = tlm.forward(model, tcfg, tok)
    caches = tlm.init_caches(tcfg, B, CACHE, "cpu")
    _, caches = tlm.prefill(model, tcfg, tok[:, :S], caches)
    dec, _ = tlm.decode_step(model, tcfg, tok[:, S:S + 1], caches, S)
    rel = float((dec[:, 0].float() - full[:, S].float()).abs().max()) / (
        float(full[:, S].float().abs().max()) + 1e-9)
    assert rel < (1e-5 if dtype == "float32" else 0.02), rel


def _own_bf16_gap(params, jcfg, prompts):
    """The reference's own bf16 error: its bf16 logits against its f32
    logits of the same weights, the largest gap over ``prompts``."""
    p32 = jax.tree.map(lambda a: a.astype(np.float32), params)
    c32 = dataclasses.replace(jcfg, dtype="float32")
    gap = 0.0
    for prompt in prompts:
        lb, _ = jlm.forward(params, jcfg, jnp.asarray(prompt)[None])
        l32, _ = jlm.forward(p32, c32, jnp.asarray(prompt)[None])
        gap = max(gap, float(np.abs(np.asarray(lb, np.float32) - np.asarray(l32)).max()))
    return gap


def test_bf16_forward_within_the_references_own_bf16_error():
    jcfg, tcfg, params, model = _model("bfloat16")
    tok = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 29)).astype(np.int32)
    lb, _ = jlm.forward(params, jcfg, jnp.asarray(tok))
    lt, _ = tlm.forward(model, tcfg, torch.as_tensor(tok))
    assert lt.dtype == torch.bfloat16
    gap = _own_bf16_gap(params, jcfg, list(tok))
    assert float(np.abs(_n(lt) - _n(lb)).max()) <= gap, gap


def _batch(cfg, rng, b=3, s=40):
    tok = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:],
            "weights": rng.uniform(0.2, 2.0, b).astype(np.float32),
            "loss_mask": (rng.random((b, s)) > 0.2).astype(np.float32)}


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


@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_and_gradients_match(impl, remat):
    """Loss and every gradient leaf (the f32 gate matrices included) against
    ``jax.value_and_grad``, with plan weights and a loss mask; the sequence
    crosses the mLSTM's chunk."""
    jcfg, tcfg = _cfgs(attention_impl=impl, remat=remat)
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    batch = _batch(jcfg, np.random.default_rng(0))
    (jl, _), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    tp = tlm.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tl, tg = tts._loss_and_grads(tp, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), **F32)
    _assert_tree_close(jg, tg, F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_gives_the_references_tree(dtype):
    _, tcfg, params, model = _model(dtype)
    back = tlm.params_to_jax(model)
    jflat = jax.tree_util.tree_flatten_with_path(params)[0]
    tflat = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [jax.tree_util.keystr(p) for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        a = np.asarray(a)
        assert b.shape == a.shape, jax.tree_util.keystr(path)
        if a.dtype.name == "bfloat16":
            assert b.dtype == np.dtype("V2")
            np.testing.assert_array_equal(b.view(np.int16), a.view(np.int16))
        else:
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(b, a)


# -- ServeEngine -------------------------------------------------------------

MAX_LEN = 24
REQUESTS = [(5, 4), (9, 7), (5, 3), (9, 30)]   # (prompt length, new tokens)


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, p).astype(np.int32) for p, _ in REQUESTS]


def test_engine_generates_the_references_tokens_in_f32():
    """The port's ``ServeEngine`` against the reference's on xlstm: two
    slots for four requests (slots freed and taken again, the sLSTM's
    (c, n, m) copied member by member), the last cut at MAX_LEN - 1."""
    jcfg, tcfg, params, model = _model()
    prompts = _prompts(jcfg.vocab_size)
    jeng = JEngine(params, jcfg, max_batch=2, max_len=MAX_LEN)
    teng = tengine.ServeEngine(model, tcfg, max_batch=2, max_len=MAX_LEN)
    for i, (prompt, (_, n)) in enumerate(zip(prompts, REQUESTS)):
        jeng.submit(JRequest(i, prompt, max_new_tokens=n))
        teng.submit(tengine.Request(i, prompt, max_new_tokens=n))
    jdone = {r.rid: r.generated for r in jeng.run()}
    tdone = {r.rid: r.generated for r in teng.run()}
    assert sorted(tdone) == list(range(len(REQUESTS)))
    for rid, (p, n) in enumerate(REQUESTS):
        assert len(tdone[rid]) == min(n, MAX_LEN - p), (rid, tdone[rid])
        assert tdone[rid] == jdone[rid], (rid, tdone[rid], jdone[rid])


def test_engine_in_bf16_follows_the_reference_up_to_a_near_tie():
    """bf16: each request's tokens agree up to the first parting, and there
    the two candidates are a near-tie in the port's logits (no farther
    apart than the reference's own bf16 error on the same prompts)."""
    jcfg, tcfg, params, model = _model("bfloat16")
    prompts = _prompts(jcfg.vocab_size)
    jeng = JEngine(params, jcfg, max_batch=2, max_len=MAX_LEN)
    for i, (prompt, (_, n)) in enumerate(zip(prompts, REQUESTS)):
        jeng.submit(JRequest(i, prompt, max_new_tokens=n))
    jdone = {r.rid: r.generated for r in jeng.run()}
    tol = _own_bf16_gap(params, jcfg, prompts[:2])
    for rid, (prompt, (_, n)) in enumerate(zip(prompts, REQUESTS)):
        theirs = jdone[rid]
        # the port's greedy run of this request alone, with its logits
        caches = tlm.init_caches(tcfg, 1, MAX_LEN, "cpu")
        logits, caches = tlm.prefill(model, tcfg, torch.as_tensor(prompt[None]), caches)
        rows, ours = [logits[0, -1]], [int(torch.argmax(logits[0, -1]))]
        for j in range(len(theirs) - 1):
            out, caches = tlm.decode_step(model, tcfg, torch.tensor([[theirs[j]]]), caches,
                                          len(prompt) + j)
            rows.append(out[0, -1])
            ours.append(int(torch.argmax(out[0, -1])))
        parted = [t for t, (a, b) in enumerate(zip(ours, theirs)) if a != b]
        if parted:
            t = parted[0]
            gap = abs(float(rows[t][ours[t]]) - float(rows[t][theirs[t]]))
            assert gap <= tol, (rid, t, gap, tol)


@pytest.mark.parametrize("max_batch", [1, 2])
def test_freed_slot_decodes_as_a_fresh_engine(max_batch):
    """A slot that served one request and admits the next decodes it bit for
    bit as a fresh engine does: every member of the sLSTM's (c, n, m) and the
    mLSTM's state is taken from the new prefill, none left from the last
    request."""
    _, tcfg, _, model = _model()
    prompts = _prompts(tcfg.vocab_size)
    logits = {}
    decode = tlm.decode_step

    def run(reqs, key):
        eng = tengine.ServeEngine(model, tcfg, max_batch=max_batch, max_len=MAX_LEN)
        rows = logits.setdefault(key, [])

        def recording(*args, **kwargs):
            out = decode(*args, **kwargs)
            rows.append(out[0][:, -1].clone())
            return out

        for rid, p, n in reqs:
            eng.submit(tengine.Request(rid, prompts[p], max_new_tokens=n))
        tengine.lm.decode_step = recording
        try:
            return {r.rid: r.generated for r in eng.run()}, eng
        finally:
            tengine.lm.decode_step = decode

    # the first requests run to their end and free their slots; request 9
    # (prompt 3) is then admitted into slot 0, already used
    first = [(i, i, 6) for i in range(max_batch)]
    used, eng_used = run(first + [(9, 3, 8)], "used")
    fresh, eng_fresh = run([(9, 3, 8)], "fresh")
    assert used[9] == fresh[9] and len(fresh[9]) == 8
    # its last decode steps ran alone in slot 0 in both engines
    for a, b in zip(logits["used"][-7:], logits["fresh"][-7:]):
        assert torch.equal(a[0], b[0])
    for a, b in zip(eng_used.caches, eng_fresh.caches):
        for u, f in zip(tengine._leaves(a), tengine._leaves(b)):
            assert torch.equal(u[0], f[0])


def test_full_width_bf16_decode_gap_is_the_references():
    """At xlstm-125m's published width and depth (random weights, bf16) the
    recurrent decode and the chunked full forward part by more than the LM
    phases' 0.02 bound — in the reference as in the port, so the card's
    check (``chip_smoke.py`` phase 20a) is held in f32.  Here: one 48-token
    prompt and two decode steps; the reference's own gap exceeds 0.02, the
    port's is no larger than the reference's, and on the same weights in f32
    the port's two forms agree to 1e-4 of max |logit|."""
    from repro_torch import tree as T

    jcfg = dataclasses.replace(jreg.get(ARCH), dtype="bfloat16")
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = tlm.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    P, steps = 48, 2
    tok = np.random.default_rng(0).integers(0, jcfg.vocab_size, (1, P + steps)).astype(np.int32)

    def rel(a, b):
        a, b = _n(a), _n(b)
        return float(np.abs(a - b).max() / np.abs(b).max())

    def port_gaps(m, c):
        with torch.no_grad():
            full, _ = tlm.forward(m, c, torch.as_tensor(tok))
            caches = tlm.init_caches(c, 1, P + steps, "cpu")
            _, caches = tlm.prefill(m, c, torch.as_tensor(tok[:, :P]), caches)
            gaps = []
            for j in range(steps):
                d, caches = tlm.decode_step(m, c, torch.as_tensor(tok[:, P + j:P + j + 1]), caches,
                                            P + j)
                gaps.append(rel(d[0, 0], full[0, P + j]))
        return gaps

    fj, _ = jlm.forward(params, jcfg, jnp.asarray(tok))
    cj = jlm.init_caches(jcfg, 1, P + steps)
    _, cj = jlm.prefill(params, jcfg, jnp.asarray(tok[:, :P]), cj)
    ref = []
    for j in range(steps):
        d, cj = jlm.decode_step(params, jcfg, jnp.asarray(tok[:, P + j:P + j + 1]), cj,
                                jnp.asarray(P + j, jnp.int32))
        ref.append(rel(d[0, 0], fj[0, P + j]))
    port = port_gaps(model, tcfg)
    assert max(ref) > 0.02, ref
    assert max(port) <= max(ref), (port, ref)
    f32 = port_gaps(T.map(lambda t: t.float(), model), dataclasses.replace(tcfg, dtype="float32"))
    assert max(f32) < 1e-4, f32
