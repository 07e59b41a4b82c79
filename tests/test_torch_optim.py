"""Port parity: ``repro_torch.optim`` (schedules, Nesterov SGD, Adam/AdamW,
``clip_by_global_norm``) against ``repro.optim`` on JAX-CPU.

The same numpy gradients, made from a seed, drive both packages for 5 steps
on a small tree mixing bf16 and f32 leaves.  Tolerances: f32 ``rtol=1e-6,
atol=1e-7`` on the moments and the f32 parameters (elementwise f32 in both;
measured ≤ 6e-8 absolute); bf16 parameters equal up to one bf16 ulp of the
f32 update's rounding (measured: equal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as jopt
from repro.optim import schedules as jsch
from repro_torch import tree as T
from repro_torch.optim import optimizers as topt
from repro_torch.optim import schedules as tsch

torch.set_num_threads(1)
F32 = dict(rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("name,args", [
    ("cosine", (1e-3, 100)), ("cosine", (0.05, 40, 10, 1e-4)), ("cyclic", (1e-3, 1e-2, 7)),
    ("linear_decay", (0.1, 0.3, 5)), ("constant", (0.02,)),
])
def test_schedules_match(name, args):
    jf, tf = jsch.GET[name](*args), tsch.GET[name](*args)
    steps = np.arange(0, 120, dtype=np.int32)
    want = np.asarray([jf(jnp.int32(s)) for s in steps])
    got = np.asarray([tf(torch.tensor(s, dtype=torch.int32)).item() for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    assert tf(torch.tensor(3)).dtype == torch.float32 and tf(torch.tensor(3)).dim() == 0


def _tree(rng):
    """A small params tree: bf16 matrices, f32 vectors, nested dicts."""
    return {
        "embed": rng.normal(size=(11, 6)).astype(np.float32),
        "final_norm": rng.uniform(0.5, 1.5, size=6).astype(np.float32),
        "groups": {"b0": {"w": rng.normal(size=(2, 6, 5)).astype(np.float32),
                          "norm": rng.uniform(0.5, 1.5, size=(2, 6)).astype(np.float32)}},
    }


BF16 = {"embed", "w"}


def _jax(tree):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(a, jnp.bfloat16 if p[-1].key in BF16 else jnp.float32), tree)


def _torch(tree, key=None):
    if isinstance(tree, dict):
        return {k: _torch(v, k) for k, v in tree.items()}
    return torch.as_tensor(tree).to(torch.bfloat16 if key in BF16 else torch.float32)


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("opt", ["sgd", "adam", "adamw"])
@pytest.mark.parametrize("clip", [None, 0.5])
def test_optimizer_updates_match(opt, clip):
    rng = np.random.default_rng(0)
    base = _tree(rng)
    jp, tp = _jax(base), _torch(base)
    jo, to = jopt.GET[opt](), topt.GET[opt]()
    js, ts = jo.init(jp), to.init(tp)
    sched_j, sched_t = jsch.cosine(0.05, 5, 1), tsch.cosine(0.05, 5, 1)
    for step in range(5):
        g = _tree(rng)
        jg, tg = _jax(g), _torch(g)
        if clip:
            jg, jn = jopt.clip_by_global_norm(jg, clip)
            tg, tn = topt.clip_by_global_norm(tg, clip)
            np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
            for a, b in zip(jax.tree.leaves(jg), T.leaves(tg)):
                assert str(a.dtype) == str(b.dtype).removeprefix("torch."), (a.dtype, b.dtype)
                np.testing.assert_allclose(_np(b), _np(a), rtol=1e-2 if b.dtype == torch.bfloat16
                                           else 1e-6, atol=1e-7)
        lr_j, lr_t = sched_j(jnp.int32(step)), sched_t(torch.tensor(step, dtype=torch.int32))
        jp, js = jo.update(jg, js, jp, lr_j)
        tp, ts = to.update(tg, ts, tp, lr_t)
    for a, b in zip(jax.tree.leaves(js), T.leaves(ts)):
        np.testing.assert_allclose(_np(b), _np(a), **F32)
    for a, b in zip(jax.tree.leaves(jp), T.leaves(tp)):
        assert b.dtype == (torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
        if b.dtype == torch.bfloat16:
            np.testing.assert_allclose(_np(b), _np(a), rtol=2 ** -7, atol=1e-7)
        else:
            np.testing.assert_allclose(_np(b), _np(a), **F32)
    if opt != "sgd":
        assert ts["t"].dtype == torch.int32 and int(ts["t"]) == 5


def test_update_leaves_its_inputs_and_norm_order():
    """``update`` returns new tensors; the global norm sums the leaves in
    the reference's order (sorted dict keys)."""
    rng = np.random.default_rng(1)
    tp, tg = _torch(_tree(rng)), _torch(_tree(rng))
    before = [t.clone() for t in T.leaves(tp)]
    opt = topt.adamw()
    state = opt.init(tp)
    new, _ = opt.update(tg, state, tp, torch.tensor(0.1))
    assert all(torch.equal(a, b) for a, b in zip(before, T.leaves(tp)))
    assert not any(torch.equal(a, b) for a, b in zip(T.leaves(new), T.leaves(tp)))
    names = [k for k in ("embed", "final_norm", "groups")]
    assert [t.shape for t in T.leaves(tg)] == [tg[names[0]].shape, tg[names[1]].shape,
                                              tg["groups"]["b0"]["norm"].shape,
                                              tg["groups"]["b0"]["w"].shape]
    _, norm = topt.clip_by_global_norm(tg, 1.0)
    want = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in T.leaves(tg)))
    assert torch.equal(norm, want)
