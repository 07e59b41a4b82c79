"""The model-agnostic encoder step on PyTorch (``repro_torch.encoders``,
``repro_torch.core.preprocess_with_encoder``) against the reference's
(``repro.encoders``, ``repro.core.milo.preprocess_with_encoder``) on the
CPU, at ``tests/test_encoders.py``'s tiny widths.

Weights cross with ``params_from_jax`` (each layer leaf's leading
``num_layers`` axis unstacked); outputs agree at the reference's kernel
tolerance, rtol 1e-4 and atol 2e-4.  The proxy encoder starts from the
reference's initial parameters through ``fit(..., params0=)``; the SGE
draws of ``preprocess_with_encoder`` come in through ``sge_noise=``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.milo import preprocess_with_encoder as jpreprocess_with_encoder
from repro.data.datasets import GaussianMixtureDataset
from repro.encoders.proxy import ProxyEncoder as JProxy
from repro.encoders.text import TextEncoderConfig as JTextCfg, init_text_encoder as jinit_text
from repro.encoders.text import text_encode as jtext_encode
from repro.encoders.vit import ViTConfig as JViTCfg, init_vit as jinit_vit, vit_encode as jvit_encode
from repro.models.layers import init_dense as jinit_dense, layer_norm as jlayer_norm
from repro_torch.core import preprocess_with_encoder
from repro_torch.core.partition import ByClass, proportional_budgets
from repro_torch.encoders import (
    ProxyEncoder,
    TextEncoderConfig,
    ViTConfig,
    init_text_encoder,
    init_vit,
    params_from_jax,
    text_encode,
    vit_encode,
)
from repro_torch.models.layers import layer_norm

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=2e-4)
VIT = dict(image_size=32, patch_size=8, d_model=64, num_layers=2, num_heads=4, d_ff=128)
TEXT = dict(vocab_size=100, max_len=16, d_model=32, num_layers=2, num_heads=4, d_ff=64)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("shape", [(5, 16), (2, 7, 64)])
def test_layer_norm_matches_reference(shape):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    s = rng.normal(size=shape[-1:]).astype(np.float32)
    b = rng.normal(size=shape[-1:]).astype(np.float32)
    ref = np.asarray(jlayer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    out = layer_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)
    half = layer_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(s), torch.from_numpy(b))
    assert half.dtype == torch.bfloat16


@pytest.mark.parametrize("cfg", [VIT, dict(VIT, image_size=48, patch_size=16, num_layers=3)])
def test_vit_encode_matches_reference(cfg):
    jcfg, tcfg = JViTCfg(**cfg), ViTConfig(**cfg)
    jparams = jinit_vit(jax.random.PRNGKey(0), jcfg)
    imgs = np.array(jax.random.normal(jax.random.PRNGKey(1), (3, cfg["image_size"],
                                                                cfg["image_size"], 3)))
    ref = np.asarray(jvit_encode(jparams, jnp.asarray(imgs), jcfg))
    params = params_from_jax(_np_tree(jparams), tcfg, device="cpu")
    assert len(params["layers"]) == cfg["num_layers"]
    z = vit_encode(params, torch.from_numpy(imgs), tcfg)
    assert z.shape == (3, cfg["d_model"]) and torch.isfinite(z).all()
    np.testing.assert_allclose(z.numpy(), ref, **TOL)
    assert torch.equal(vit_encode(params, torch.from_numpy(imgs), tcfg), z)


def test_text_encode_matches_reference():
    jcfg, tcfg = JTextCfg(**TEXT), TextEncoderConfig(**TEXT)
    jparams = jinit_text(jax.random.PRNGKey(0), jcfg)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 10), 0, 100))
    mask = np.asarray([[1] * 10, [1] * 4 + [0] * 6], np.float32)
    params = params_from_jax(_np_tree(jparams), tcfg, device="cpu")
    for m in (mask, None):
        ref = np.asarray(jtext_encode(jparams, jnp.asarray(toks), jcfg,
                                      None if m is None else jnp.asarray(m)))
        z = text_encode(params, torch.from_numpy(toks), tcfg,
                        None if m is None else torch.from_numpy(m))
        assert z.shape == (2, TEXT["d_model"])
        np.testing.assert_allclose(z.numpy(), ref, **TOL)


def test_text_encoder_mean_pooling_respects_mask():
    """``tests/test_encoders.py``'s property on the port's own weights: a
    masked-out tail does not move the embedding."""
    cfg = TextEncoderConfig(**TEXT)
    params = init_text_encoder(cfg, seed=0, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(0, 100, (2, 10)))
    mask = torch.tensor([[1] * 10, [1] * 4 + [0] * 6], dtype=torch.float32)
    z = text_encode(params, toks, cfg, mask)
    toks2 = toks.clone()
    toks2[1, 4:] = 0
    z2 = text_encode(params, toks2, cfg, mask)
    np.testing.assert_allclose(z[1].numpy(), z2[1].numpy(), atol=1e-5)
    toks2[1, 2] = (toks[1, 2] + 1) % 100   # an unmasked token does move it
    assert not torch.allclose(text_encode(params, toks2, cfg, mask)[1], z[1])


def test_port_inits_have_the_reference_layouts():
    """The port's own draws have the reference's leaves and shapes, layer by
    layer, and are deterministic in the seed."""
    for jinit, tinit, jcfg, tcfg in (
            (jinit_vit, init_vit, JViTCfg(**VIT), ViTConfig(**VIT)),
            (jinit_text, init_text_encoder, JTextCfg(**TEXT), TextEncoderConfig(**TEXT))):
        ref = params_from_jax(_np_tree(jinit(jax.random.PRNGKey(0), jcfg)), tcfg, device="cpu")
        mine = tinit(tcfg, seed=0, device="cpu")
        again = tinit(tcfg, seed=0, device="cpu")
        assert {k: v.shape for k, v in mine.items() if k != "layers"} == \
               {k: v.shape for k, v in ref.items() if k != "layers"}
        assert [{k: v.shape for k, v in lp.items()} for lp in mine["layers"]] == \
               [{k: v.shape for k, v in lp.items()} for lp in ref["layers"]]
        assert all(torch.equal(a, b) for a, b in zip(mine["layers"][1].values(),
                                                      again["layers"][1].values()))


def _reference_params0(enc: JProxy) -> dict:
    """The reference's initial draw (``ProxyEncoder.fit``'s first lines)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(enc.seed))
    return {"w1": np.asarray(jinit_dense(k1, enc.d_in, enc.d_hidden, jnp.float32)),
            "b1": np.zeros((enc.d_hidden,), np.float32),
            "w2": np.asarray(jinit_dense(k2, enc.d_hidden, enc.n_classes, jnp.float32)),
            "b2": np.zeros((enc.n_classes,), np.float32)}


@pytest.fixture(scope="module")
def gmm():
    ds = GaussianMixtureDataset(n=400, n_classes=4, dim=12, seed=0)
    return ds.x, ds.y


@pytest.mark.parametrize("d_hidden,epochs", [(32, 60), (16, 80)])
def test_proxy_encoder_from_reference_init_matches(gmm, d_hidden, epochs):
    x, y = gmm
    kw = dict(d_in=12, n_classes=4, d_hidden=d_hidden, epochs=epochs)
    jenc = JProxy(**kw).fit(x, y)
    tenc = ProxyEncoder(**kw, device="cpu").fit(x, y, params0=_reference_params0(jenc))
    assert dataclasses.asdict(tenc) == dataclasses.asdict(jenc)
    feats = tenc.encode(x)
    assert isinstance(feats, np.ndarray) and feats.shape == (400, d_hidden)
    np.testing.assert_allclose(feats, jenc.encode(x), **TOL)
    assert tenc.linear_probe_accuracy(x, y) == jenc.linear_probe_accuracy(x, y)


def test_proxy_encoder_learns_and_features_separate_classes(gmm):
    """``tests/test_encoders.py``'s property on the port's own draw."""
    x, y = gmm
    enc = ProxyEncoder(d_in=12, n_classes=4, d_hidden=32, epochs=80, device="cpu").fit(x, y)
    assert enc.linear_probe_accuracy(x, y) > 0.8
    f = enc.encode(x)
    f = f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-6)
    sims = f @ f.T
    same = y[:, None] == y[None, :]
    np.fill_diagonal(same, False)
    assert sims[same].mean() > sims[~same].mean() + 0.1


def _next_pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


def _reference_sge_noise(labels, subset_fraction, n_subsets, seed):
    """The reference's per-class SGE draws (as ``tests/test_torch_slice.py``
    derives them) in the bucketed geometry each class runs at."""
    parts = ByClass().partition(labels, len(labels))
    budgets = proportional_budgets(parts, max(1, round(subset_fraction * len(labels))))
    key = jax.random.PRNGKey(seed)
    noise = []
    for part, k_c in zip(parts, budgets):
        key, k_sge = jax.random.split(key)
        n_run = _next_pow2(len(part.indices))
        k_run = min(n_run, _next_pow2(k_c))

        def run(kk, k_run=k_run, n_run=n_run):
            return jax.vmap(lambda kt: jax.random.gumbel(kt, (n_run,)))(
                jax.random.split(kk, k_run))

        noise.append(np.asarray(jax.vmap(run)(jax.random.split(k_sge, n_subsets))))
    return noise


@pytest.mark.parametrize("batch_size,returns", [(256, "array"), (96, "tensor")])
def test_preprocess_with_encoder_matches_reference(gmm, batch_size, returns):
    """The same artifact as the reference's (config, hash, bank, WRE
    distribution) from one frozen encoder, whether ``encode_fn`` returns an
    array or a tensor and however the inputs are batched."""
    x, y = gmm
    w = np.random.default_rng(5).normal(size=(12, 24)).astype(np.float32)

    def encode_np(batch):
        return np.tanh(np.asarray(batch, np.float32) @ w)

    def encode_t(batch):
        return torch.from_numpy(encode_np(batch))

    pre = dict(subset_fraction=0.1, n_sge_subsets=4, gram_block=128)
    md_j = jpreprocess_with_encoder(encode_np, x, y, jax.random.PRNGKey(3), batch_size=batch_size,
                                    encoder_id="proxy", **pre)
    md_t = preprocess_with_encoder(encode_np if returns == "array" else encode_t, x, y, 3,
                                   batch_size=batch_size, encoder_id="proxy", device="cpu",
                                   sge_noise=_reference_sge_noise(y, 0.1, 4, 3), **pre)
    assert md_t.config == md_j.config and md_t.config["encoder_id"] == "proxy"
    assert md_t.config_hash() == md_j.config_hash()
    np.testing.assert_array_equal(md_t.sge_subsets, md_j.sge_subsets)
    np.testing.assert_allclose(md_t.wre_probs, md_j.wre_probs, rtol=1e-5, atol=1e-9)
