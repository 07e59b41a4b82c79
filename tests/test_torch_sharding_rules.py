"""Port parity: the LM sharding rules of ``repro_torch.distributed.sharding``
on DTensor against the reference's ``repro.distributed.sharding``.

* The rules, every leaf of every arch at full width, on the meshes (16, 16),
  (2, 16, 16), (32, 8), (2, 32, 8) and (4, 2).  The reference's rule
  functions read only ``mesh.shape`` and ``mesh.axis_names``, the port's only
  ``mesh.mesh_dim_names`` and ``mesh.shape``, so stand-in objects drive both
  at any size with no devices.  The port's placements must be the
  reference's ``PartitionSpec`` minus the leading stack axis of a
  group-stacked leaf (the port holds those leaves as ``tree.Stacked`` lists
  of per-group tensors).  The same for ``data_spec``, ``cache_spec`` and
  ``ssm_state_spec`` over a grid of batch, sequence and heads.
* One process (a gloo world of one rank): on a (1, 1) mesh every output is
  bit-equal to the plain-tensor run; ``constrain`` without a mesh returns
  its input object; a mesh entered in one thread is not ambient in another;
  B5's and B6's local-shard routes, on their plain versions, equal the full
  computation sliced to each rank's heads, for every rank of a model axis of
  2 and of 8.
* Four gloo processes as a (2, 2) ``data x model`` mesh (one launch, its own
  timeout): yi-6b's smoke config and the same with one key/value head (the
  query heads split, the key/value head replicated) take one
  loss-and-grads step under the ambient mesh and match the unsharded port
  (rtol 1e-5) and the reference's forward (rtol 1e-4, atol 2e-4, f32);
  ``restore(mesh=, placements=)`` lays a (2, 2) checkpoint out on (4, 1) and
  (1, 4) exactly, and one the reference wrote on its forced (4, 2) mesh.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import registry as jreg
from repro.distributed import sharding as jshd
from repro.models import lm as jlm
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm as tlm
from repro_torch.testing.faults import launch_hosts
from repro_torch.tree import Stacked

torch.set_num_threads(1)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_ENV = {"PYTHONPATH": os.path.join(REPO_ROOT, "src"), "OMP_NUM_THREADS": "1"}

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "32x8": ((32, 8), ("data", "model")),
    "2x32x8": ((2, 32, 8), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
}


class PortMesh:
    """What the port's rules read of a ``DeviceMesh``."""

    def __init__(self, shape, axes):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(axes)


class RefMesh:
    """What the reference's rules read of a ``jax.sharding.Mesh``."""

    def __init__(self, shape, axes):
        self.shape, self.axis_names = dict(zip(axes, shape)), tuple(axes)


def _meshes(name):
    shape, axes = MESHES[name]
    return PortMesh(shape, axes), RefMesh(shape, axes)


def _expected(axes, spec) -> tuple:
    """A reference ``PartitionSpec`` as DTensor placements: mesh axis i
    shards the tensor dim whose entry names it."""
    out = []
    for name in axes:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        assert len(dims) <= 1, spec
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _ref_leaves(arch):
    """The reference's full-width parameter leaves: path -> shape."""
    a = jax.eval_shape(lambda k: jlm.init_lm(k, jreg.get(arch)), jax.random.PRNGKey(0))
    paths = jax.tree.leaves(jshd._tree_paths(a))
    return dict(zip(paths, (tuple(x.shape) for x in jax.tree.leaves(a))))


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    """The port's full-width parameter tree, as fake tensors."""
    with FakeTensorMode():
        return tlm.init_lm(treg.get(arch), device="cpu")


def _port_leaves(tree, shardings, path=""):
    """(path, tensor shape, stacked, placements of each tensor)."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _port_leaves(tree[k], shardings[k], f"{path}/{k}" if path else k)
    elif isinstance(tree, Stacked):
        assert len({tuple(t.shape) for t in tree}) == 1
        yield path, tuple(tree[0].shape), True, list(shardings)
    else:
        yield path, tuple(tree.shape), False, [shardings]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(jreg.ARCHS))
def test_param_shardings_match_the_reference_at_full_width(arch, mesh_name):
    pm, rm = _meshes(mesh_name)
    axes = MESHES[mesh_name][1]
    ref = _ref_leaves(arch)
    params = _port_params(arch)
    got = list(_port_leaves(params, shd.param_shardings(pm, params)))
    assert sorted(p for p, *_ in got) == sorted(ref)
    n_split = 0
    for path, shape, stacked, pls in got:
        spec = jshd._leaf_spec(rm, path, ref[path])
        if stacked:  # the reference's leading n_groups (or encoder layers) axis
            assert ref[path] == (len(pls),) + shape, path
            assert spec[0] is None, (path, spec)
            spec = P(*spec[1:])
        else:
            assert ref[path] == shape, path
        want = _expected(axes, spec)
        assert all(p == want for p in pls), (path, spec, pls[0])
        n_split += any(isinstance(p, Shard) for p in want)
    assert n_split > 0


def _grid():
    for batch in (1, 2, 4, 8, 16, 32, 64, 96, 128, 256, 512):
        for seq in (1, 2, 64, 4096, 32768, 524288):
            for heads in (1, 2, 4, 8, 12, 16, 32, 64, 256):
                yield batch, seq, heads


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("rule", ["data_spec", "cache_spec", "ssm_state_spec"])
def test_input_and_cache_specs_match_the_reference(rule, mesh_name):
    pm, rm = _meshes(mesh_name)
    axes = MESHES[mesh_name][1]
    assert shd.batch_axes(pm) == jshd.batch_axes(rm)
    for batch, seq, heads in _grid():
        if rule == "data_spec":
            for extra in (1, 2):
                want = _expected(axes, jshd.data_spec(rm, batch, extra))
                assert shd.data_spec(pm, batch, extra) == want, (batch, extra)
        elif rule == "cache_spec":
            want = _expected(axes, jshd.cache_spec(rm, batch, seq, heads))
            assert shd.cache_spec(pm, batch, seq, heads) == want, (batch, seq, heads)
        else:
            want = _expected(axes, jshd.ssm_state_spec(rm, batch, heads))
            assert shd.ssm_state_spec(pm, batch, heads) == want, (batch, heads)
        assert shd.maybe(pm, heads, "model") == jshd.maybe(rm, heads, "model")
        assert shd.maybe(pm, batch, ("pod", "data")) == jshd.maybe(rm, batch, ("pod", "data"))


def test_placements_refuse_an_axis_twice_or_out_of_order():
    pm, _ = _meshes("2x32x8")
    assert shd.placements(pm, (("pod", "data"), "model")) == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError):
        shd.placements(pm, ("model", "model"))
    with pytest.raises(ValueError):
        shd.placements(pm, (("data", "pod"),))


# ---------------------------------------------------------------------------
# one process: a gloo world of one rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh11():
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _on_mesh(mesh, params):
    return shd.distribute(mesh, params, shd.param_shardings(mesh, params))


def _local(x):
    return x.full_tensor() if isinstance(x, DTensor) else x


def _flat(tree):
    from repro_torch import tree as T

    return [_local(t) for t in T.leaves(tree)]


def test_constrain_without_a_mesh_returns_its_input():
    x = torch.randn(4, 3, 8)
    assert shd.ambient_mesh() is None
    assert shd.constrain(x, "batch", None, "model") is x


def test_constrain_on_a_plain_tensor_under_a_mesh_returns_it(mesh11):
    x = torch.randn(4, 3, 8)
    with shd.use_mesh(mesh11):
        assert shd.constrain(x, "batch", None, None) is x
        d = DTensor.from_local(x, mesh11, [Replicate(), Replicate()])
        y = shd.constrain(d, "batch", None, "model")
        assert isinstance(y, DTensor) and torch.equal(y.full_tensor(), x)
    assert shd.ambient_mesh() is None


def test_the_ambient_mesh_is_per_thread(mesh11):
    seen = {}
    entered, release = threading.Event(), threading.Event()

    def other():
        entered.wait(10)
        seen["mesh"] = shd.ambient_mesh()
        d = DTensor.from_local(torch.ones(2, 2), mesh11, [Replicate(), Replicate()])
        seen["same"] = shd.constrain(d, "batch", None) is d
        release.set()

    t = threading.Thread(target=other)
    t.start()
    with shd.use_mesh(mesh11):
        assert shd.ambient_mesh() is mesh11
        entered.set()
        assert release.wait(10)
    t.join(10)
    assert not t.is_alive()
    assert seen == {"mesh": None, "same": True}


@pytest.mark.parametrize("arch", ["yi-6b", "jamba-1.5-large-398b"])
def test_one_rank_mesh_is_bit_equal_to_plain_tensors(mesh11, arch):
    """Training (loss and gradients) and serving (prefill, decode) on a
    (1, 1) mesh under ``use_mesh`` give the plain run's bits; serving runs
    the kernels' local-shard routes (B5, B6: their plain versions here)."""
    from repro_torch.launch import specs
    from repro_torch.train import train_state as ts

    cfg = dataclasses.replace(treg.smoke(arch), attention_impl="chunked")
    params = tlm.init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int64))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    loss0, g0 = ts._loss_and_grads(params, cfg, batch)
    dp = _on_mesh(mesh11, params)
    with shd.use_mesh(mesh11):
        loss1, g1 = ts._loss_and_grads(dp, cfg, batch)
    assert torch.equal(_local(loss1), loss0)
    assert all(torch.equal(a, b) for a, b in zip(_flat(g1), _flat(g0)))

    scfg = dataclasses.replace(cfg, attention_impl="pallas", ssm_impl="pallas")

    def serve(p, caches):
        logits, _ = tlm.prefill(p, scfg, tokens[:, :16], caches)
        outs = [_local(logits)]
        tok = tokens[:, 16:17]
        for i in range(3):
            lg, _ = tlm.decode_step(p, scfg, tok, caches, 16 + i)
            outs.append(_local(lg))
            tok = torch.argmax(_local(lg)[:, -1], -1, keepdim=True)
        return outs

    plain = serve(params, tlm.init_caches(scfg, 2, 32, device="cpu"))
    caches = tlm.init_caches(scfg, 2, 32, device="cpu")
    dcaches = specs.lay_out_caches(caches, specs.cache_placements(mesh11, caches),
                                   lambda t, p: DTensor.from_local(t, mesh11, list(p)))
    with shd.use_mesh(mesh11):
        sharded = serve(dp, dcaches)
    assert all(torch.equal(a, b) for a, b in zip(sharded, plain))


@pytest.mark.parametrize("model", [2, 8])
@pytest.mark.parametrize("kv_heads", [4, 8])
def test_b5_local_shards_pair_query_heads_with_their_kv_heads(model, kv_heads):
    """yi-6b's 32 query heads over a model axis of 2 or 8, with its 4
    key/value heads (replicated at 8: 4 % 8 != 0) or 8: each rank's query
    heads with the key/value heads ``local_kv_heads`` gives them equal the
    full attention's rows for those heads."""
    rng = np.random.default_rng(1)
    hq, d, s = 32, 128, 40
    q, k, v = (torch.from_numpy(rng.standard_normal((2, h, s, d)).astype(np.float32))
               for h in (hq, kv_heads, kv_heads))
    full = fa_ops.flash_attention(q, k, v, causal=True)
    hl = hq // model
    split_kv = kv_heads % model == 0
    for r in range(model):
        kl, vl, off = k, v, 0
        if split_kv:
            n = kv_heads // model
            kl, vl, off = k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n], r * n
        kr, vr = fa_ops.local_kv_heads(kl, vl, hq=hq, hkv=kv_heads, q_offset=r * hl,
                                       hq_local=hl, kv_offset=off)
        out = fa_ops.flash_attention(q[:, r * hl:(r + 1) * hl], kr, vr, causal=True)
        torch.testing.assert_close(out, full[:, r * hl:(r + 1) * hl], rtol=0, atol=0)


@pytest.mark.parametrize("model", [2, 8])
def test_b6_local_shards_equal_the_full_scan(model):
    """Jamba's SSD scan split over its heads: each rank's heads (x, a
    split; b, c whole) give the full scan's rows and states."""
    rng = np.random.default_rng(2)
    b, s, h, p, n = 2, 40, 16, 8, 16
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (b, s, h)).astype(np.float32))
    bb, cc = (torch.from_numpy(rng.standard_normal((b, s, n)).astype(np.float32))
              for _ in range(2))
    y, st = ssd_ops.ssd_scan(x, a, bb, cc, chunk=16)
    hl = h // model
    for r in range(model):
        sl = slice(r * hl, (r + 1) * hl)
        yr, sr = ssd_ops.ssd_scan(x[:, :, sl], a[:, :, sl], bb, cc, chunk=16)
        torch.testing.assert_close(yr, y[:, :, sl], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(sr, st[:, sl], rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# four gloo processes: a (2, 2) data x model mesh
# ---------------------------------------------------------------------------

SHARDED_STEP = r"""
import dataclasses, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor
from repro_torch import tree as T
from repro_torch.checkpoint.checkpointer import CheckpointManager
from repro_torch.configs import registry
from repro_torch.distributed import multihost, sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import lm
from repro_torch.train import train_state as ts

torch.set_num_threads(1)
multihost.initialize(timeout=120.0)
rank = dist.get_rank()
tmp = sys.argv[1]
ref = np.load(tmp + "/ref.npz")
tokens = torch.from_numpy(ref["tokens"])
batch = {"tokens": tokens, "labels": torch.from_numpy(ref["labels"])}
mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
full = lambda x: x.full_tensor() if isinstance(x, DTensor) else x


def pl_leaves(t):  # the placement tuples of a param_shardings tree, in leaf order
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in pl_leaves(t[k])]
    return list(t) if isinstance(t, list) else [t]


report = {}
for kv in (2, 1):
    cfg = dataclasses.replace(registry.smoke("yi-6b"), dtype="float32", num_kv_heads=kv,
                              attention_impl="chunked")
    params = lm.init_lm(cfg, seed=0, device="cpu")
    loss0, g0 = ts._loss_and_grads(params, cfg, batch)
    dp = shd.distribute(mesh, params, shd.param_shardings(mesh, params))
    dbatch = {k: distribute_tensor(v, mesh, list(shd.data_spec(mesh, v.shape[0], 1)),
                                   src_data_rank=None) for k, v in batch.items()}
    with shd.use_mesh(mesh):
        loss1, g1 = ts._loss_and_grads(dp, cfg, dbatch)
        logits1, _ = lm.forward(dp, cfg, dbatch["tokens"])
    torch.testing.assert_close(full(loss1), loss0, rtol=1e-5, atol=0)
    gmax = 0.0
    for a, b in zip(T.leaves(g1), T.leaves(g0)):
        torch.testing.assert_close(full(a), b, rtol=1e-5, atol=1e-7)
        gmax = max(gmax, float((full(a) - b).abs().max()))
    np.testing.assert_allclose(full(logits1).numpy(), ref[f"logits_kv{kv}"], rtol=1e-4, atol=2e-4)
    report[kv] = (float(loss0), gmax, float(np.abs(full(logits1).numpy() - ref[f"logits_kv{kv}"]).max()))
    if kv == 2:
        saved = T.map(full, dp)
        if rank == 0:
            CheckpointManager(tmp + "/ck", process_index=0, process_count=1).save(1, saved)
        dist.barrier()
        mgr = CheckpointManager(tmp + "/ck", process_index=rank, process_count=1)
        for shape in ((4, 1), (1, 4)):
            m = make_mesh(shape, ("data", "model"), device_type="cpu")
            pls = shd.param_shardings(m, params)
            back = mgr.restore(1, params, mesh=m, placements=pls)
            for t, want, p in zip(T.leaves(back), T.leaves(params), pl_leaves(pls)):
                assert isinstance(t, DTensor) and t.device_mesh is m
                assert tuple(t.placements) == tuple(p)
                assert torch.equal(t.full_tensor(), want)
# the reference's checkpoint from its forced (4, 2) mesh
jcfg = dataclasses.replace(registry.smoke("yi-6b"), dtype="float32")
target = lm.init_lm(jcfg, seed=1, device="cpu")
jm = CheckpointManager(tmp + "/jck", process_index=rank, process_count=1)
plain = jm.restore(0, target)
back = jm.restore(0, target, mesh=mesh, placements=shd.param_shardings(mesh, target))
for t, want in zip(T.leaves(back), T.leaves(plain)):
    assert isinstance(t, DTensor) and torch.equal(t.full_tensor(), want)
print("SHARDED_OK", rank, report, flush=True)
multihost.shutdown()
"""

REF_CKPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, jax
from repro.checkpoint.checkpointer import CheckpointManager
from repro.configs import registry
from repro.distributed import sharding as shd
from repro.launch.mesh import make_mesh
from repro.models import lm
mesh = make_mesh((4, 2), ("data", "model"))
cfg = dataclasses.replace(registry.smoke("yi-6b"), dtype="float32")
params = lm.init_lm(jax.random.PRNGKey(3), cfg)
params = jax.tree.map(jax.device_put, params, shd.param_shardings(mesh, params))
CheckpointManager(sys.argv[1]).save(0, params)
print("REF_CKPT_OK")
"""


def test_sharded_step_and_elastic_restore_on_four_gloo_processes(tmp_path):
    t0 = time.perf_counter()
    ref = subprocess.Popen([sys.executable, "-c", REF_CKPT, str(tmp_path / "jck")],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           env=dict(os.environ, **CHILD_ENV), cwd=REPO_ROOT)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (4, 24)).astype(np.int64)
    out = {"tokens": tokens, "labels": np.roll(tokens, -1, 1)}
    for kv in (2, 1):
        jcfg = dataclasses.replace(jreg.smoke("yi-6b"), dtype="float32", num_kv_heads=kv,
                                   attention_impl="chunked")
        params = tlm.init_lm(ModelConfig(**dataclasses.asdict(jcfg)), seed=0, device="cpu")
        logits, _ = jlm.forward(jax.tree.map(np.asarray, tlm.params_to_jax(params)), jcfg,
                                tokens.astype(np.int32))
        out[f"logits_kv{kv}"] = np.asarray(logits, np.float32)
    np.savez(tmp_path / "ref.npz", **out)
    stdout, stderr = ref.communicate(timeout=120)
    assert "REF_CKPT_OK" in stdout, stderr[-2000:]
    results = launch_hosts(SHARDED_STEP, [str(tmp_path)], num_processes=4, env=CHILD_ENV,
                           timeout=180, cwd=REPO_ROOT)
    for r in results:
        assert r.returncode == 0 and "SHARDED_OK" in r.stdout, r.stderr[-3000:]
    print("four-process launch with the reference's checkpoint:",
          f"{time.perf_counter() - t0:.1f} s", results[0].stdout.strip())
