"""LFM2-8B-A1B on the port's LM path (``make_train_step`` → ``lm.loss_fn`` →
``apply_block``) against the plain float32 reference
``repro_torch.testing.lfm2_reference`` at a smoke size on the CPU: the
whole model's loss and every gradient leaf, the conv mixer, QK-norm
attention, the sigmoid-plus-bias router, the dropless expert layer (against
every held expert evaluated on every token), one expert-parallel share
against the uncut layer, ``expert_bias`` left as it was by training, and
per-block recomputation.

Tolerances are f32 round-off: the port and the reference compute the same
functions in other orders (the port's convolution as shifted sums, its
attention as an online softmax, its experts over gathered rows), so
``rtol=1e-4, atol=2e-5`` (the port's f32 parity tolerance) unless a test
says otherwise.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.configs.hybrid import HybridConfig
from repro_torch.launch import roofline
from repro_torch.models import attention as tattn
from repro_torch.models import blocks, lm, moe
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import cosine
from repro_torch.testing import lfm2_reference as ref
from repro_torch.train.train_state import init_train_state, make_train_step

torch.set_num_threads(1)
F32 = dict(rtol=1e-4, atol=2e-5)
NAME = "lfm2-8b-a1b"


def _cfg(**kw) -> HybridConfig:
    return dataclasses.replace(registry.smoke(NAME), dtype="float32", attention_impl="chunked",
                               **kw)


def _spec(cfg: HybridConfig) -> dict:
    return {"kinds": lm.layer_kinds(cfg), "num_heads": cfg.num_heads,
            "num_kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
            "norm_eps": cfg.norm_eps, "rope_theta": cfg.rope_theta,
            "top_k": cfg.experts_per_token, "expert_offset": cfg.expert_offset,
            "routed_scaling_factor": cfg.routed_scaling_factor}


def _plain(node):
    """A port weight tree as the reference's plain tensors (buffers read)."""
    if isinstance(node, dict):
        return {k: _plain(v) for k, v in node.items()}
    return node.value if isinstance(node, T.Buffer) else node


def _ref_params(params: dict, cfg) -> dict:
    return {"embed": params["embed"], "final_norm": params["final_norm"],
            "layers": [_plain(p) for p in lm.layer_params(params, cfg)]}


def _set_bias(params: dict, cfg, seed: int) -> None:
    """Random expert biases, as large as the benchmark's (±0.1)."""
    gen = torch.Generator().manual_seed(seed)
    for p in lm.layer_params(params, cfg):
        if "expert_bias" in p.get("ffn", {}):
            p["ffn"]["expert_bias"].value.copy_(0.1 * (2 * torch.rand(cfg.num_experts,
                                                                      generator=gen) - 1))


def _batch(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(b, s + 1)))
    return {"tokens": t[:, :-1], "labels": t[:, 1:],
            "weights": torch.tensor([1.0, 0.5][:b])}


def _grads(loss, leaves):
    return torch.autograd.grad(loss, leaves)


def test_preset_resolves_and_counts_its_parameters():
    """The preset (port-only: ``ARCHS`` is the reference's ten) and its
    share: 8.34 B published, 1.56 B active a token, 2.53 B held by an
    expert-parallel rank of 8 experts (``test_parameter_count_equals_the_
    weights_held`` ties the count to the weights ``init_lm`` draws)."""
    cfg = registry.get(NAME)
    assert NAME not in registry.ARCHS and NAME in registry.PORT_ONLY
    assert [i for i, (m, _) in enumerate(cfg.pattern) if m == "attn"] == [2, 6, 10, 14, 18, 21]
    assert [f for _, f in cfg.pattern[:3]] == ["dense", "dense", "moe"]
    assert cfg.n_groups == 1 and cfg.head_dim == 64 and cfg.moe_d_ff == 1792
    # the analytic counts, and the published figures they round to
    assert (cfg.param_count(), cfg.active_param_count()) == (8_339_929_856, 1_557_740_288)
    assert round(cfg.param_count() / 1e9, 2) == 8.34
    assert round(cfg.active_param_count() / 1e9, 2) == 1.56
    share = dataclasses.replace(cfg, experts_held=8)
    assert share.param_count() == 2_526_624_512
    assert round(share.param_count() / 1e9, 2) == 2.53
    assert share.active_param_count() == cfg.active_param_count()
    shape = SHAPES["train_4k"]   # the dry run's roofline reads the active count
    assert roofline.model_flops(cfg, shape) == 6.0 * 1_557_740_288 * shape.global_batch * 4096
    smoke = registry.smoke(NAME)
    assert isinstance(smoke, HybridConfig) and smoke.n_held == smoke.num_experts == 4
    with pytest.raises(ValueError):
        dataclasses.replace(cfg, experts_held=8, expert_offset=28)


def test_parameter_count_equals_the_weights_held():
    cfg = _cfg(experts_held=2, expert_offset=1)
    params = lm.init_lm(cfg, seed=0, device="cpu")
    assert sum(t.numel() for t in T.leaves(params)) == cfg.param_count()


@pytest.mark.parametrize("held,offset", [(4, 0), (2, 1)])
def test_loss_and_every_gradient_leaf_match_the_reference(held, offset):
    cfg = _cfg(experts_held=held, expert_offset=offset)
    params = lm.init_lm(cfg, seed=1, device="cpu")
    _set_bias(params, cfg, 2)
    batch = _batch(cfg)
    leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
    tree = T.unflatten(params, leaves)
    loss, _ = lm.loss_fn(tree, cfg, batch)
    got = _grads(loss, leaves)
    r_leaves = [p.detach().clone().requires_grad_(True) for p in leaves]
    r_loss = ref.loss_fn(_ref_params(T.unflatten(params, r_leaves), cfg), batch, _spec(cfg))
    want = _grads(r_loss, r_leaves)
    assert float(loss.detach()) == pytest.approx(float(r_loss.detach()), rel=1e-5)
    assert len(got) == len(want) == len(T.leaves(params))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=f"leaf {i}", **F32)


def test_conv_mixer_matches_the_reference():
    gen = torch.Generator().manual_seed(3)
    p = blocks.init_short_conv(gen, 32, 3, torch.float32)
    h = torch.randn(2, 17, 32, generator=gen, requires_grad=True)
    y = blocks.short_conv(p, h)
    want = ref.short_conv(p, h)
    np.testing.assert_allclose(y.detach().numpy(), want.detach().numpy(), **F32)
    g = torch.randn_like(y)
    np.testing.assert_allclose(torch.autograd.grad(y, h, g)[0],
                               torch.autograd.grad(want, h, g)[0], **F32)
    # causal: the first token's output depends on no later token
    h2 = h.detach().clone()
    h2[:, 1:] += 1.0
    np.testing.assert_allclose(blocks.short_conv(p, h2)[:, 0].detach(), y[:, 0].detach(), **F32)
    bf = {k: v.to(torch.bfloat16) for k, v in p.items()}
    yb = blocks.short_conv(bf, h.detach().to(torch.bfloat16))
    assert yb.dtype == torch.bfloat16
    np.testing.assert_allclose(yb.float(), ref.short_conv({k: v.float() for k, v in bf.items()},
                                                          h.detach().to(torch.bfloat16).float()),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("impl", ["naive", "chunked"])
def test_qk_norm_attention_matches_the_reference(impl):
    cfg = _cfg()
    gen = torch.Generator().manual_seed(4)
    p = tattn.init_attention(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                             torch.float32, qk_norm=True)
    p["q_norm"] = 0.5 + torch.rand(cfg.head_dim, generator=gen)
    p["k_norm"] = 0.5 + torch.rand(cfg.head_dim, generator=gen)
    h = torch.randn(2, 40, cfg.d_model, generator=gen)
    pos = torch.arange(40)[None]
    y, _ = tattn.attention(p, h, pos, impl=impl, rope_theta=cfg.rope_theta, block=16,
                           norm_eps=cfg.norm_eps)
    np.testing.assert_allclose(y.numpy(), ref.attention(p, h, _spec(cfg)).numpy(), **F32)
    plain = {k: v for k, v in p.items() if k not in ("q_norm", "k_norm")}
    y0, _ = tattn.attention(plain, h, pos, impl=impl, rope_theta=cfg.rope_theta, block=16)
    assert not torch.allclose(y, y0, rtol=1e-3, atol=1e-3)


def _router_params(logits: torch.Tensor, bias: torch.Tensor) -> dict:
    """Router weights that give the tokens ``x = I`` exactly these logits."""
    return {"router": logits.clone(), "expert_bias": T.Buffer(bias)}


def test_router_choices_and_weights_with_near_ties_and_a_bias_flip():
    e, k = 8, 2
    logits = torch.zeros((4, e))
    logits[0] = torch.tensor([0.0, 1.0, 1.0, -1.0, 1.0, 0.0, 0.0, 0.0])     # exact ties
    logits[1] = torch.tensor([0.3, 0.3 + 1e-6, 0.3, 0.0, 0.0, 0.0, 0.0, -2.0])  # near-tie
    logits[2] = torch.tensor([2.0, 1.9, 0.0, 1.8, 0.0, 0.0, 0.0, 0.0])     # the bias flips 1 for 3
    logits[3] = torch.randn(e, generator=torch.Generator().manual_seed(5))
    bias = torch.zeros(e)
    bias[3] = 0.02    # sigmoid(1.8) + 0.02 lies between sigmoid(1.9) and sigmoid(2)
    p = _router_params(logits, bias)
    x = torch.eye(4)
    w, ids = moe._sigmoid_router(p, x, k)
    rw, rids = ref.route({"router": p["router"], "expert_bias": bias}, x, {"top_k": k,
                         "routed_scaling_factor": 1.0})
    assert torch.equal(ids, rids)
    np.testing.assert_allclose(w.numpy(), rw.numpy(), rtol=1e-6, atol=0)
    assert ids[0].tolist() == [1, 2]          # ties to the lower index
    assert ids[1].tolist() == [1, 0]
    assert ids[2].tolist() == [0, 3]          # the bias chose 3 over 1
    assert torch.equal(moe._sigmoid_router(
        _router_params(logits, torch.zeros(e)), x, k)[1][2], torch.tensor([0, 1]))
    s = torch.sigmoid(logits[2])
    np.testing.assert_allclose(w[2].numpy(), (s[[0, 3]] / (s[[0, 3]].sum() + 1e-6)).numpy(),
                               rtol=1e-6)
    w2, _ = moe._sigmoid_router(p, x, k, scale=2.5)
    np.testing.assert_allclose(w2.numpy(), 2.5 * w.numpy(), rtol=1e-6)


def _moe_case(e=8, k=2, d=32, f=48, t=(3, 40), seed=6, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    p = moe.init_moe(gen, d, f, e, dtype, expert_bias=True)
    p["expert_bias"].value.copy_(0.1 * (2 * torch.rand(e, generator=gen) - 1))
    x = torch.randn(*t, d, generator=gen).to(dtype)
    return p, x


def _share(p: dict, lo: int, n: int) -> dict:
    out = {k: (v[lo:lo + n] if k.startswith("w_") else v) for k, v in p.items()}
    return out


def test_dropless_layer_matches_every_expert_on_every_token():
    p, x = _moe_case()
    x.requires_grad_(True)
    spec = {"top_k": 2, "expert_offset": 0, "routed_scaling_factor": 1.0}
    y = moe.moe_routed(p, x, top_k=2)
    want = ref.moe(_plain(p), x, spec)
    np.testing.assert_allclose(y.detach().numpy(), want.detach().numpy(), **F32)
    g = torch.randn_like(y)
    np.testing.assert_allclose(torch.autograd.grad(y, x, g)[0].numpy(),
                               torch.autograd.grad(want, x, g)[0].numpy(), **F32)
    again = moe.moe_routed(p, x, top_k=2)
    assert torch.equal(y, again)
    # an uneven load: one expert's bias takes every token's first choice
    p["expert_bias"].value[5] = 10.0
    np.testing.assert_allclose(moe.moe_routed(p, x, top_k=2).detach().numpy(),
                               ref.moe(_plain(p), x, spec).detach().numpy(), **F32)


def test_expert_shares_sum_to_the_uncut_layer():
    """E 8, k 2 over 4 ranks of 2 experts: the ranks' partial outputs add up
    to the layer that holds all 8."""
    p, x = _moe_case()
    whole = moe.moe_routed(p, x, top_k=2)
    parts = [moe.moe_routed(_share(p, 2 * r, 2), x, top_k=2, offset=2 * r) for r in range(4)]
    assert all(float(q.abs().max()) > 0 for q in parts)
    np.testing.assert_allclose(sum(parts).numpy(), whole.numpy(), **F32)
    spec = {"top_k": 2, "expert_offset": 4, "routed_scaling_factor": 1.0}
    np.testing.assert_allclose(parts[2].numpy(), ref.moe(_plain(_share(p, 4, 2)), x,
                                                         spec).numpy(), **F32)


def test_grouped_products_equal_the_expert_loop_in_bf16(monkeypatch):
    """The card's route (``torch._grouped_mm`` over the whole row buffer)
    against the loop over the experts, in bf16: the held experts' products
    alone, then the whole layer, forward and gradients (the rows past the
    held experts' come out zero, and the gather drops their gradient)."""
    if not hasattr(torch, "_grouped_mm"):
        pytest.skip("this torch has no _grouped_mm")
    p, x = _moe_case(d=32, f=48, dtype=torch.bfloat16)
    ws = [p[w].requires_grad_(True) for w in ("w_gate", "w_up", "w_down")]
    xs = x.reshape(-1, 32)[torch.randperm(120, generator=torch.Generator().manual_seed(0))]
    ends = torch.tensor([10, 10, 31, 40, 41, 60, 77, 90])
    x = x.detach().requires_grad_(True)
    outs = []
    for grouped in (False, True):
        monkeypatch.setattr(moe, "_grouped_route", lambda *a, grouped=grouped: grouped)
        y = moe.held_experts(p, xs, ends)
        gw = torch.autograd.grad(y, ws, torch.ones_like(y))
        layer = moe.moe_routed(p, x, top_k=2)
        g = torch.autograd.grad(layer, [x, *ws], torch.ones_like(layer))
        outs.append([y.detach(), *gw, layer.detach(), *g])
    assert float(outs[1][0][90:].abs().max()) == 0.0
    for a, b in zip(*outs):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=2e-2, atol=2e-2)


def test_expert_bias_is_left_as_it_was_by_three_train_steps():
    cfg = _cfg()
    opt = adamw()
    state = init_train_state(cfg, opt, seed=3, device="cpu")
    _set_bias(state.params, cfg, 4)
    before = [p["ffn"]["expert_bias"].value.clone() for p in lm.layer_params(state.params, cfg)
              if "expert_bias" in p["ffn"]]
    step = make_train_step(cfg, opt, cosine(1e-3, 10))
    first = T.leaves(state.params)
    for i in range(3):
        state, _ = step(state, _batch(cfg, seed=i))
    after = [p["ffn"]["expert_bias"].value for p in lm.layer_params(state.params, cfg)
             if "expert_bias" in p["ffn"]]
    assert len(before) == 22
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert all(not torch.equal(a, b) for a, b in zip(first, T.leaves(state.params)))
    assert len(T.leaves(state.opt_state["m"])) == len(first)


def test_per_block_remat_gives_the_gradients_of_no_remat():
    grads = []
    for remat in (False, True):
        cfg = _cfg(remat=remat)
        params = lm.init_lm(cfg, seed=7, device="cpu")
        _set_bias(params, cfg, 8)
        leaves = [p.detach().requires_grad_(True) for p in T.leaves(params)]
        loss, _ = lm.loss_fn(T.unflatten(params, leaves), cfg, _batch(cfg))
        grads.append(_grads(loss, leaves))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_conv_has_no_decode_path():
    cfg = _cfg()
    with pytest.raises(NotImplementedError, match="decode"):
        lm.init_caches(cfg, 1, 16, device="cpu")
    params = lm.init_lm(cfg, seed=0, device="cpu")
    logits, caches = lm.forward(params, cfg, _batch(cfg)["tokens"], mode="prefill")
    assert caches is None and logits.shape == (2, 24, cfg.vocab_size)


def test_spans_and_counters_of_the_new_layers():
    """A recorded step holds ``lm.conv`` and the expert layer's three spans,
    each with its backward, and the expert layer's counters: every
    (token, choice) pair routed, those held here, the busiest held
    expert's rows."""
    from repro_torch import obs

    cfg = _cfg(experts_held=2, expert_offset=1)
    state = init_train_state(cfg, adamw(), seed=2, device="cpu")
    _set_bias(state.params, cfg, 3)
    step = make_train_step(cfg, adamw(), cosine(1e-3, 10))
    obs.reset()
    obs.enable()
    try:
        step(state, _batch(cfg))
    finally:
        obs.REGISTRY.enabled = False
    snap = obs.snapshot()
    obs.reset()
    for name in ("lm.conv", "lm.moe.route", "lm.moe.experts", "lm.moe.combine"):
        assert snap["spans"][name]["count"] > 0 and snap["spans"][name + ".bwd"]["count"] > 0
    route = snap["spans"]["lm.moe.route"]
    n_moe = sum(f == "moe" for _, f in cfg.pattern)
    assert route["count"] - route["recompute"]["count"] == n_moe
    c = route["counters"]
    assert c["moe.rows_routed"] == n_moe * 2 * 24 * cfg.experts_per_token
    assert 0 < c["moe.rows_max"] <= c["moe.rows_held"] < c["moe.rows_routed"]
