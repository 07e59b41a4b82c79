"""Port parity: the LM serving path of ``repro_torch`` (layers, attention,
Mamba, MoE, blocks, the model) against the JAX reference, module by module,
with the reference's weights carried across by ``params_from_jax``.

Inputs are made with numpy from a seed and given to both packages.  JAX stays
on the CPU and runs its Pallas kernels in interpret mode; the port's
wrappers take their plain versions on CPU tensors.  Tolerances: f32
``rtol=1e-4, atol=2e-4`` (the reference's kernel tolerance); where a test
departs, it says why.
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
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)
F32 = dict(rtol=1e-4, atol=2e-4)
ARCHS = ["yi-6b", "jamba-1.5-large-398b"]


def _t(x):
    """A JAX array (or a tree of them) as the port's tensors, bit for bit."""
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return tlm._to_torch(np.asarray(x), "cpu")


def _n(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def _cfgs(arch, dtype="float32"):
    jcfg = dataclasses.replace(jreg.smoke(arch), attention_impl="pallas", ssm_impl="pallas",
                               dtype=dtype)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def test_model_configs_build_from_each_other():
    """The port's ModelConfig has the reference's fields and defaults, and
    every preset and its smoke reduction are the reference's."""
    for name, jc in jreg.ARCHS.items():
        tc = treg.get(name)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert dataclasses.asdict(treg.smoke(name)) == dataclasses.asdict(jreg.smoke(name))
        assert tc.param_count() == jc.param_count()
    assert sorted(treg.ARCHS) == sorted(jreg.ARCHS)


def test_bf16_weight_conversion_is_bit_exact():
    w = jax.random.normal(jax.random.PRNGKey(0), (37, 11), jnp.float32).astype(jnp.bfloat16)
    t = _t(w)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(), np.asarray(w).view(np.int16))
    f = jax.random.normal(jax.random.PRNGKey(1), (5,), jnp.float32)
    assert torch.equal(_t(f), torch.from_numpy(np.asarray(f)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match(dtype):
    rng = np.random.default_rng(0)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = jnp.asarray(rng.normal(size=(2, 9, 4, 16)), jd)
    scale = jnp.asarray(rng.uniform(0.5, 1.5, size=16), jnp.float32)
    pos = jnp.asarray(rng.integers(0, 500, size=(2, 9)), jnp.int32)
    # bf16: one rounding of the output apart (2^-8 relative)
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_n(tlayers.rms_norm(_t(x), _t(scale))),
                               _n(jlayers.rms_norm(x, scale)), **tol)
    np.testing.assert_allclose(_n(tlayers.apply_rope(_t(x), _t(pos), 10000.0)),
                               _n(jlayers.apply_rope(x, pos, 10000.0)), **tol)
    mp = jlayers.init_mlp(jax.random.PRNGKey(2), 16, 32, jd)
    xs = x[:, :, 0, :]
    np.testing.assert_allclose(_n(tlayers.mlp(_t(mp), _t(xs))), _n(jlayers.mlp(mp, xs)), **tol)
    table = jlayers.init_embedding(jax.random.PRNGKey(3), 50, 16, jd)
    np.testing.assert_allclose(_n(tlayers.unembed(_t(xs), _t(table))),
                               _n(jlayers.unembed(xs, table)), **tol)


def _attn_setup(seed=0):
    p = jattn.init_attention(jax.random.PRNGKey(seed), 32, 4, 2, 8, jnp.float32)
    x = jnp.asarray(np.random.default_rng(seed).normal(size=(2, 13, 32)), jnp.float32)
    return p, x


@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_attention_train_and_prefill_match(impl):
    p, x = _attn_setup()
    pos = jnp.arange(13)[None, :]
    for mode in ("train", "prefill"):
        yj, cj = jattn.attention(p, x, pos, impl=impl, mode=mode, interpret=True)
        yt, ct = tattn.attention(_t(p), _t(x), _t(pos), impl=impl, mode=mode)
        np.testing.assert_allclose(_n(yt), _n(yj), **F32)
        if mode == "prefill":
            np.testing.assert_allclose(_n(ct.k), _n(cj.k), **F32)
            np.testing.assert_allclose(_n(ct.v), _n(cj.v), **F32)
            np.testing.assert_array_equal(ct.length.numpy(), np.asarray(cj.length))
        else:
            assert cj is None and ct is None


def test_attention_decode_per_slot_lengths():
    """Batched decode: each slot writes its new K/V at its own length and
    attends only its valid positions."""
    p, _ = _attn_setup(1)
    rng = np.random.default_rng(1)
    B, S_MAX = 3, 20
    k0 = jnp.asarray(rng.normal(size=(B, S_MAX, 2, 8)), jnp.float32)
    v0 = jnp.asarray(rng.normal(size=(B, S_MAX, 2, 8)), jnp.float32)
    lengths = jnp.asarray([5, 17, 0], jnp.int32)
    x = jnp.asarray(rng.normal(size=(B, 1, 32)), jnp.float32)
    pos = lengths[:, None]
    yj, cj = jattn.attention(p, x, pos, impl="pallas", mode="decode",
                             cache=jattn.KVCache(k0, v0, lengths), interpret=True)
    cache = tattn.KVCache(_t(k0).clone(), _t(v0).clone(), _t(lengths).clone())
    yt, ct = tattn.attention(_t(p), _t(x), _t(pos), impl="pallas", mode="decode", cache=cache)
    assert ct is cache, "the cache is updated in place"
    np.testing.assert_allclose(_n(yt), _n(yj), **F32)
    np.testing.assert_allclose(_n(ct.k), _n(cj.k), **F32)
    np.testing.assert_allclose(_n(ct.v), _n(cj.v), **F32)
    np.testing.assert_array_equal(ct.length.numpy(), np.asarray(cj.length))


def test_attention_decode_write_past_the_cache_raises():
    p, _ = _attn_setup(2)
    B, S_MAX = 2, 4
    cache = tattn.KVCache(torch.zeros(B, S_MAX, 2, 8), torch.zeros(B, S_MAX, 2, 8),
                          torch.tensor([1, S_MAX], dtype=torch.int32))
    with pytest.raises(ValueError, match="past the cache"):
        tattn.attention(_t(p), torch.zeros(B, 1, 32), torch.zeros(B, 1, dtype=torch.long),
                        mode="decode", cache=cache)


def _mamba_setup(seed=0):
    p = jssm.init_mamba(jax.random.PRNGKey(seed), 32, expand=2, head_dim=8, d_state=6,
                        dtype=jnp.float32)
    # non-trivial decay and bias (the init's zeros would hide them)
    rng = np.random.default_rng(seed)
    p["a_log"] = jnp.asarray(rng.normal(size=p["a_log"].shape), jnp.float32)
    p["dt_bias"] = jnp.asarray(rng.normal(size=p["dt_bias"].shape), jnp.float32)
    return p


@pytest.mark.parametrize("S", [16, 21])
def test_mamba_prefill_and_decode_match(S):
    p = _mamba_setup()
    rng = np.random.default_rng(S)
    x = jnp.asarray(rng.normal(size=(2, S, 32)), jnp.float32)
    for impl in ("chunked", "pallas"):
        yj, hj = jssm.mamba(p, x, chunk=8, mode="prefill", impl=impl, interpret=True)
        yt, ht = tssm.mamba(_t(p), _t(x), chunk=8, mode="prefill", impl=impl)
        np.testing.assert_allclose(_n(yt), _n(yj), **F32)
        np.testing.assert_allclose(_n(ht), _n(hj), **F32)
    x1 = jnp.asarray(rng.normal(size=(2, 1, 32)), jnp.float32)
    yj, sj = jssm.mamba(p, x1, state=hj, mode="decode")
    yt, st = tssm.mamba(_t(p), _t(x1), state=ht, mode="decode")
    np.testing.assert_allclose(_n(yt), _n(yj), **F32)
    np.testing.assert_allclose(_n(st), _n(sj), **F32)


def _moe_setup(d=16, f=32, e=4, seed=2):
    pm = jmoe.init_moe(jax.random.PRNGKey(seed), d, f, e, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (4, 32, d))
    return pm, x


@pytest.mark.parametrize("cf,gs", [(0.25, 128), (0.5, 48), (1.25, 64), (8.0, 64)])
def test_moe_capacity_routing_matches(cf, gs):
    """Which tokens are dropped under tight capacity decides the output
    (a token that loses both choices gets zero); the capacity is claimed in
    the reference's order — every first choice before any second choice."""
    pm, x = _moe_setup()
    yj = jmoe.moe(pm, x, top_k=2, group_size=gs, capacity_factor=cf)
    yt = tmoe.moe(_t(pm), _t(x), top_k=2, group_size=gs, capacity_factor=cf)
    np.testing.assert_allclose(_n(yt), _n(yj), **F32)
    zero_j = np.all(np.asarray(yj) == 0, axis=-1)
    np.testing.assert_array_equal(np.all(_n(yt) == 0, axis=-1), zero_j)
    if cf < 1:
        loose = jmoe.moe(pm, x, top_k=2, group_size=gs, capacity_factor=8.0)
        assert float(jnp.max(jnp.abs(yj - loose))) > 1e-4, "this case drops tokens"


def test_moe_capacity_order_first_choices_first():
    """A hand-built router: with capacity 1 per expert, token 1's first
    choice (expert 0) beats token 0's second choice (expert 0)."""
    d, e = 4, 2
    pm = {"router": jnp.asarray([[4.0, 0.0], [0.0, 4.0], [0.0, 0.0], [0.0, 0.0]], jnp.float32),
          "w_gate": jnp.ones((e, d, 3)), "w_up": jnp.ones((e, d, 3)), "w_down": jnp.ones((e, 3, d))}
    x = jnp.asarray([[[0.0, 1.0, 0.0, 0.0], [1.0, 0.0, 0.0, 0.0]]], jnp.float32)  # expert 1, then 0
    kw = dict(top_k=2, group_size=2, capacity_factor=0.5)            # cap = max(1, int(1)) = 1
    yj = jmoe.moe(pm, x, **kw)
    yt = tmoe.moe(_t(pm), _t(x), **kw)
    np.testing.assert_allclose(_n(yt), _n(yj), **F32)


def test_moe_dropless_matches():
    pm, x = _moe_setup(seed=5)
    np.testing.assert_allclose(_n(tmoe.moe_dropless(_t(pm), _t(x), top_k=2)),
                               _n(jmoe.moe_dropless(pm, x, top_k=2)), **F32)
    np.testing.assert_allclose(_n(tmoe.moe(_t(pm), _t(x), top_k=2, dropless=True)),
                               _n(jmoe.moe(pm, x, top_k=2, dropless=True)), **F32)


@pytest.fixture(scope="module", params=ARCHS)
def smoke_model(request):
    jcfg, tcfg = _cfgs(request.param)
    params = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = tlm.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return jcfg, tcfg, params, model


def test_forward_matches(smoke_model):
    jcfg, tcfg, params, model = smoke_model
    tok = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 37)).astype(np.int32)
    lj, _ = jlm.forward(params, jcfg, jnp.asarray(tok))
    lt, _ = tlm.forward(model, tcfg, torch.as_tensor(tok))
    np.testing.assert_allclose(_n(lt), _n(lj), **F32)


def test_prefill_and_decode_steps_match(smoke_model):
    """Prefill into a cache longer than the prompt, then decode steps at
    per-slot positions: logits and every cache leaf match."""
    jcfg, tcfg, params, model = smoke_model
    B, S, CACHE = 2, 16, 24
    tok = np.random.default_rng(4).integers(0, jcfg.vocab_size, (B, S + 3)).astype(np.int32)
    jc = jlm.init_caches(jcfg, B, CACHE)
    lj, jc = jlm.prefill(params, jcfg, jnp.asarray(tok[:, :S]), jc)
    tc = tlm.init_caches(tcfg, B, CACHE, "cpu")
    lt, tc = tlm.prefill(model, tcfg, torch.as_tensor(tok[:, :S]), tc)
    np.testing.assert_allclose(_n(lt), _n(lj), **F32)
    for step in range(3):
        pos = np.full((B,), S + step, np.int32)
        lj, jc = jlm.decode_step(params, jcfg, jnp.asarray(tok[:, S + step:S + step + 1]), jc,
                                 jnp.asarray(pos))
        lt, tc = tlm.decode_step(model, tcfg, torch.as_tensor(tok[:, S + step:S + step + 1]), tc,
                                 pos)
        np.testing.assert_allclose(_n(lt), _n(lj), **F32)
    for layer, (mixer, _) in enumerate(tlm.layer_kinds(tcfg)):
        g, i = divmod(layer, len(tcfg.pattern))
        jleaf = jax.tree.map(lambda a: np.asarray(a)[g], jc[i])
        if mixer == "attn":
            np.testing.assert_allclose(_n(tc[layer].k), _n(jleaf.k), **F32)
            np.testing.assert_array_equal(tc[layer].length.numpy(), jleaf.length)
        else:
            np.testing.assert_allclose(_n(tc[layer]), _n(jleaf), **F32)


def test_decode_matches_full_forward_bf16():
    """tests/test_models.py's check on the port, in the presets' bf16: decode
    after prefill against the full forward at the same position (relative
    error < 0.02, the reference's bound)."""
    for arch in ARCHS:
        _, tcfg = _cfgs(arch, "bfloat16")
        model = tlm.init_lm(tcfg, seed=0, device="cpu")
        B, S, CACHE = 2, 16, 24
        tok = torch.from_numpy(np.random.default_rng(1).integers(0, tcfg.vocab_size, (B, S + 1)))
        full, _ = tlm.forward(model, tcfg, tok)
        caches = tlm.init_caches(tcfg, B, CACHE, "cpu")
        _, caches = tlm.prefill(model, tcfg, tok[:, :S], caches)
        dec, _ = tlm.decode_step(model, tcfg, tok[:, S:S + 1], caches, S)
        rel = float((dec[:, 0].float() - full[:, S].float()).abs().max()) / (
            float(full[:, S].float().abs().max()) + 1e-9)
        assert rel < 0.02, (arch, rel)


def test_bf16_forward_within_the_references_own_bf16_error(smoke_model):
    """In bf16 the two frameworks round at slightly different points, and the
    model amplifies that; the yardstick is the reference's own gap between
    its bf16 and f32 runs of the same weights.  The port's bf16 logits must
    lie no farther from the reference's bf16 logits than that gap."""
    jcfg = smoke_model[0]
    jb = dataclasses.replace(jcfg, dtype="bfloat16")
    pb = jlm.init_lm(jax.random.PRNGKey(0), jb)
    tb = ModelConfig(**dataclasses.asdict(jb))
    model = tlm.params_from_jax(jax.tree.map(np.asarray, pb), tb, device="cpu")
    tok = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 29)).astype(np.int32)
    lb, _ = jlm.forward(pb, jb, jnp.asarray(tok))
    l32, _ = jlm.forward(jax.tree.map(lambda a: a.astype(jnp.float32), pb), jcfg, jnp.asarray(tok))
    lt, _ = tlm.forward(model, tb, torch.as_tensor(tok))
    assert lt.dtype == torch.bfloat16
    gap = float(np.abs(_n(lb) - _n(l32)).max())
    assert float(np.abs(_n(lt) - _n(lb)).max()) <= gap, gap
