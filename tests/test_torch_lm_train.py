"""Port parity: the LM training path of ``repro_torch`` — the custom VJPs of
``rms_norm`` and ``unembed``, chunked attention, ``loss_fn`` and the train
steps — against the JAX reference on the CPU.

Inputs and weights are made with numpy from a seed (the reference's
``init_lm`` weights carried across by ``lm.params_from_jax``) and given to
both packages; JAX gradients come from ``jax.value_and_grad``, the port's
from ``torch.autograd``.  Tolerances: f32 ``rtol=1e-4, atol=2e-4`` (the
reference's kernel tolerance).  Measured on the CPU (the worst element of
any leaf, as a fraction of its tolerance ``atol + rtol·|ref|``): ``loss_fn``'s
loss and gradients ≤ 1.9e-3 on both smoke archs, naive and chunked, remat
on and off; three ``make_train_step`` steps ≤ 4.3e-2 (parameters, moments,
``grad_norm``, ``lr``); three accumulated steps ≤ 7.0e-2; the layers' VJPs
≤ 7.6e-3; chunked attention ≤ 5.6e-3.  bf16: ``rtol=atol=2e-2``
(``tests/test_kernels.py``'s bf16 tolerance); measured ≤ 0.21 of it for
chunked attention (bf16 rounding of p before p·v in both packages) and
7.4e-6 for the layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsch
from repro.train import train_state as jts
from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsch
from repro_torch.train import train_state as tts

torch.set_num_threads(1)
F32 = dict(rtol=1e-4, atol=2e-4)
BF16 = dict(rtol=2e-2, atol=2e-2)
ARCHS = ["internlm2-1.8b", "granite-moe-1b-a400m"]


def _n(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _t(x, dtype):
    return torch.as_tensor(np.asarray(x, np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_unembed_gradients(dtype):
    """The custom VJPs: dx in x's dtype, dscale in scale's (f32), the
    unembedding's cotangent in the storage dtype before both products."""
    rng = np.random.default_rng(0)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    tol = BF16 if dtype == "bfloat16" else F32
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=16).astype(np.float32)
    table = (rng.normal(size=(24, 16)) * 0.3).astype(np.float32)
    cot = rng.normal(size=(2, 5, 16)).astype(np.float32)
    cot_v = rng.normal(size=(2, 5, 24)).astype(np.float32)

    def jfn(x, s, w):
        h = jlayers.rms_norm(x, s, 1e-6)
        return (jnp.sum(h.astype(jnp.float32) * cot)
                + jnp.sum(jlayers.unembed(h, w).astype(jnp.float32) * cot_v))

    jg = jax.grad(jfn, argnums=(0, 1, 2))(jnp.asarray(x, jd), jnp.asarray(scale),
                                          jnp.asarray(table, jd))
    tx, ts, tw = (_t(x, td).requires_grad_(True), torch.as_tensor(scale).requires_grad_(True),
                  _t(table, td).requires_grad_(True))
    h = tlayers.rms_norm(tx, ts, 1e-6)
    out = (torch.sum(h.float() * torch.as_tensor(cot))
           + torch.sum(tlayers.unembed(h, tw).float() * torch.as_tensor(cot_v)))
    tg = torch.autograd.grad(out, (tx, ts, tw))
    assert [g.dtype for g in tg] == [td, torch.float32, td]
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(_n(b), _n(a), **tol)
    # the forward numbers are the plain path's, bit for bit
    with torch.no_grad():
        assert torch.equal(tlayers.rms_norm(tx, ts, 1e-6), tlayers._rms_norm_fwd(tx, ts, 1e-6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_forward_and_gradients(dtype, causal):
    """S = 64 over KV blocks of 16 (4 online-softmax steps), GQA 4/2."""
    rng = np.random.default_rng(1)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    tol = BF16 if dtype == "bfloat16" else F32
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16)))
    cot = rng.normal(size=(2, 64, 4, 16)).astype(np.float32)

    def jfn(q, k, v):
        o = jattn._chunked_attn(q, k, v, causal=causal, block=16)
        return jnp.sum(o.astype(jnp.float32) * cot), o

    (_, jo), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a, jd) for a in (q, k, v)))
    tq, tk, tv = (_t(a, td).requires_grad_(True) for a in (q, k, v))
    to = tattn._chunked_attn(tq, tk, tv, causal=causal, block=16)
    tg = torch.autograd.grad(torch.sum(to.float() * torch.as_tensor(cot)), (tq, tk, tv))
    np.testing.assert_allclose(_n(to), _n(jo), **tol)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(_n(b), _n(a), **tol)
    # without autograd the same numbers (no recompute)
    with torch.no_grad():
        assert torch.equal(tattn._chunked_attn(tq, tk, tv, causal=causal, block=16), to.detach())


def test_chunked_decode_with_slot_lengths():
    """Chunked attention in decode mode masks each slot at its own length,
    as the reference's chunked route does."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(3, 1, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(3, 40, 2, 16)).astype(np.float32) for _ in range(2))
    k_len = np.array([5, 17, 40], np.int32)
    jo = jattn._chunked_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                             block=16, k_len=jnp.asarray(k_len))
    to = tattn._chunked_attn(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                             causal=False, block=16, k_len=torch.as_tensor(k_len))
    np.testing.assert_allclose(_n(to), _n(jo), **F32)


def test_pallas_attention_refuses_autograd():
    cfg = ModelConfig(**dataclasses.asdict(dataclasses.replace(
        jreg.smoke("internlm2-1.8b"), attention_impl="pallas", dtype="float32")))
    params = tlm.init_lm(cfg, device="cpu")
    params = T.map(lambda p: p.requires_grad_(True), params)
    with pytest.raises(NotImplementedError, match="cannot differentiate"):
        tlm.loss_fn(params, cfg, {"tokens": np.zeros((1, 8), np.int32),
                                  "labels": np.zeros((1, 8), np.int32)})
    with torch.no_grad():   # the forward (serving) route is the kernel's
        tlm.forward(params, cfg, torch.zeros((1, 8), dtype=torch.long))


def _cfgs(arch, impl, remat, dtype="float32"):
    jcfg = dataclasses.replace(jreg.smoke(arch), attention_impl=impl, remat=remat, dtype=dtype)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _batch(cfg, rng, b=3, s=40):
    tok = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:],
            "weights": rng.uniform(0.2, 2.0, b).astype(np.float32),
            "loss_mask": (rng.random((b, s)) > 0.2).astype(np.float32)}


def _assert_tree_close(j_tree, t_tree, tol):
    """A reference params tree against the port's training tree."""
    tj = tlm.params_to_jax(t_tree)
    paths = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    for (path, a), b in zip(paths, jax.tree.leaves(tj)):
        b = b.view(np.uint16).astype(np.uint32) << 16 if b.dtype == np.dtype("V2") else b
        b = b.view(np.float32) if b.dtype == np.uint32 else b
        np.testing.assert_allclose(np.asarray(b, np.float32), np.asarray(a, np.float32),
                                   err_msg=jax.tree_util.keystr(path), **tol)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["naive", "chunked"])
@pytest.mark.parametrize("remat", [False, True])
def test_loss_fn_and_gradients_match(arch, impl, remat):
    """Loss and every gradient leaf with plan weights and a loss mask."""
    jcfg, tcfg = _cfgs(arch, impl, remat)
    jp = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    batch = _batch(jcfg, np.random.default_rng(0))
    (jl, _), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    tp = tlm.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tl, tg = tts._loss_and_grads(tp, tcfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), **F32)
    _assert_tree_close(jg, tg, F32)
    # without weights and mask: the plain mean over tokens
    plain = {k: batch[k] for k in ("tokens", "labels")}
    jl2, _ = jlm.loss_fn(jp, jcfg, {k: jnp.asarray(v) for k, v in plain.items()})
    tl2, _ = tlm.loss_fn(tp, tcfg, plain)
    np.testing.assert_allclose(float(tl2), float(jl2), **F32)


def test_params_round_trip_and_bf16_bits():
    """``params_to_jax`` inverts ``params_from_jax`` bit for bit, bf16
    included, and the port's own ``init_lm`` weights survive the round trip
    to the same logits."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m", "naive", False, dtype="bfloat16")
    jp = jlm.init_lm(jax.random.PRNGKey(3), jcfg)
    npp = jax.tree.map(np.asarray, jp)
    back = tlm.params_to_jax(tlm.params_from_jax(npp, tcfg, device="cpu"))
    for a, b in zip(jax.tree.leaves(npp), jax.tree.leaves(back)):
        assert a.shape == b.shape
        assert np.array_equal(a.view(np.uint16) if a.dtype.itemsize == 2 else a,
                              b.view(np.uint16) if b.dtype.itemsize == 2 else b)
    own = tlm.init_lm(tcfg, seed=1, device="cpu")
    again = tlm.params_from_jax(tlm.params_to_jax(own), tcfg, device="cpu")
    for a, b in zip(T.leaves(own), T.leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 7))
    with torch.no_grad():
        la, _ = tlm.forward(own, tcfg, tokens)
        lb, _ = tlm.forward(again, tcfg, tokens)
    assert torch.equal(la, lb)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_train_steps_match(arch, impl):
    """Three ``make_train_step`` steps: parameters, both moments,
    ``grad_norm`` and ``lr``."""
    jcfg, tcfg = _cfgs(arch, impl, True)
    jopt_, topt_ = jopt.adamw(), topt.adamw()
    js = jts.init_train_state(jax.random.PRNGKey(0), jcfg, jopt_)
    ts = tts.TrainState(tlm.params_from_jax(jax.tree.map(np.asarray, js.params), tcfg,
                                            device="cpu"),
                        None, torch.zeros((), dtype=torch.int32))
    ts = ts._replace(opt_state=topt_.init(ts.params))
    jstep = jax.jit(jts.make_train_step(jcfg, jopt_, jsch.cosine(1e-2, 6, warmup=1)))
    tstep = tts.make_train_step(tcfg, topt_, tsch.cosine(1e-2, 6, warmup=1))
    rng = np.random.default_rng(1)
    for _ in range(3):
        batch = _batch(jcfg, rng, s=24)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tstep(ts, {k: torch.as_tensor(v) for k, v in batch.items()})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), **F32)
    assert int(ts.step) == int(js.step) == 3 and ts.step.dtype == torch.int32
    _assert_tree_close(js.params, ts.params, F32)
    for mom in ("m", "v"):
        _assert_tree_close(js.opt_state[mom], ts.opt_state[mom], F32)


def test_grad_accum_train_step_matches():
    jcfg, tcfg = _cfgs("internlm2-1.8b", "chunked", False)
    jopt_, topt_ = jopt.adamw(), topt.adamw()
    js = jts.init_train_state(jax.random.PRNGKey(0), jcfg, jopt_)
    params = tlm.params_from_jax(jax.tree.map(np.asarray, js.params), tcfg, device="cpu")
    ts = tts.TrainState(params, topt_.init(params), torch.zeros((), dtype=torch.int32))
    jstep = jax.jit(jts.make_grad_accum_train_step(jcfg, jopt_, jsch.constant(1e-2), accum=2))
    tstep = tts.make_grad_accum_train_step(tcfg, topt_, tsch.constant(1e-2), accum=2)
    rng = np.random.default_rng(2)
    for _ in range(3):
        b = _batch(jcfg, rng, b=4, s=16)
        b = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in b.items()}
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.as_tensor(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **F32)
        assert sorted(tm) == sorted(jm)
    _assert_tree_close(js.params, ts.params, F32)
    _assert_tree_close(js.opt_state["v"], ts.opt_state["v"], F32)
