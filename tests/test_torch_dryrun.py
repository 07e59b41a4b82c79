"""The port's dry run (``repro_torch.launch``): per-device cost analysis on a
fake process group, the H100 roofline, the dry run of a cell and its
report, held against the reference's ``repro.launch`` where they meet.

* Cost analysis (``CostMode``): a product with both operands sharded over a
  2x2 mesh counts the global FLOPs / 4 a device, a replicated one the
  global FLOPs (DTensor's sharding propagation runs each op once more at
  global shapes, which is not counted); a loop of n identical layers counts
  n times one layer (the analogue of the reference's trip-count test); a
  gather of a row-split product and a sum of a column-split one show their
  collectives' bytes, computed by hand, on the right mesh axis; B5's and
  B6's meta forms count by their formulas.
* The roofline's terms and bound with the H100 constants (the analogue of
  the reference's v5e check).
* The dry run of the reference's smoke cell (yi-6b's smoke config, remat,
  chunked attention, block 32) on a fake (4, 2) mesh, train and decode:
  ``ok``, FLOPs and bytes > 0, argument bytes equal to the local shards'
  bytes computed from the placements.  The decode cell against the
  reference's ``hlo_analysis`` on the same cell (8 forced devices, one
  subprocess): identical ``model_flops``, per-device FLOPs within 0.85-1.15x.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.launch import roofline as jroof
from repro_torch import tree as T
from repro_torch.configs import registry as treg
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_chunk import ops as ssd_ops
from repro_torch.launch import cost_analysis, dryrun, report, roofline
from repro_torch.launch.mesh import make_mesh, production_layout
from repro_torch.models import lm as tlm

torch.set_num_threads(1)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fake_mesh(request):
    """A mesh of ``request.param`` ((shape), (axes)) over a fake process
    group of that many ranks, torn down after the test."""
    shape, axes = request.param
    assert not dist.is_initialized()
    dryrun.fake_world(math.prod(shape))
    try:
        yield make_mesh(shape, axes, device_type="cpu")
    finally:
        dist.destroy_process_group()


MESH22 = ((2, 2), ("data", "model"))
MESH42 = ((4, 2), ("data", "model"))


def _dt(mesh, local_shape, pls, dtype=torch.float32):
    return DTensor.from_local(torch.empty(local_shape, dtype=dtype), mesh, pls, run_check=False)


def _count(mesh, fn):
    with FakeTensorMode(), shd.use_mesh(mesh):
        args = fn()
        with cost_analysis.CostMode(cost_analysis.axes_by_group(mesh)) as cm:
            out = args[0](*args[1:])
    return cm.totals(), out


@pytest.mark.parametrize("fake_mesh", [MESH22], indirect=True)
def test_cost_counts_local_flops_of_sharded_and_replicated_products(fake_mesh):
    m, k, n = 8, 64, 32
    flops = 2 * m * k * n
    sharded, _ = _count(fake_mesh, lambda: (torch.matmul,
                                            _dt(fake_mesh, (m // 2, k), [Shard(0), Replicate()]),
                                            _dt(fake_mesh, (k, n // 2), [Replicate(), Shard(1)])))
    replicated, _ = _count(fake_mesh, lambda: (torch.matmul,
                                               _dt(fake_mesh, (m, k), [Replicate()] * 2),
                                               _dt(fake_mesh, (k, n), [Replicate()] * 2)))
    assert sharded["flops"] == flops / 4
    assert replicated["flops"] == flops
    assert sharded["collective_total_bytes"] == replicated["collective_total_bytes"] == 0


@pytest.mark.parametrize("fake_mesh", [MESH22], indirect=True)
@pytest.mark.parametrize("n", [1, 4, 16])
def test_cost_counts_a_loop_of_layers_once_each(fake_mesh, n):
    def layers():
        x = _dt(fake_mesh, (64, 128), [Shard(0), Replicate()])
        ws = [_dt(fake_mesh, (128, 64), [Replicate(), Shard(1)]) for _ in range(n)]

        def run(x):
            for w in ws:
                x = shd.constrain(torch.tanh(x @ w), "batch", None)
            return x
        return run, x

    t, _ = _count(fake_mesh, layers)
    assert t["flops"] == pytest.approx(2 * 64 * 128 * 64 * n, rel=1e-9)
    assert t["collective_counts"]["all_gather"] == n      # the model-split columns, gathered


@pytest.mark.parametrize("fake_mesh", [MESH22], indirect=True)
def test_cost_shows_collectives_on_their_axes(fake_mesh):
    m, k, n = 16, 64, 32
    # rows split over data, gathered whole: each rank sends its (m/2, n) f32 rows
    t, _ = _count(fake_mesh, lambda: (
        lambda x, w: shd.constrain(x @ w, None, None),
        _dt(fake_mesh, (m // 2, k), [Shard(0), Replicate()]),
        _dt(fake_mesh, (k, n), [Replicate()] * 2)))
    assert t["collective_bytes_by_axis"] == {"data": (m // 2) * n * 4}
    assert t["collective_counts"] == {"all_gather": 1}
    # the contraction split over model: a pending sum of the (m, n) product
    t, _ = _count(fake_mesh, lambda: (
        lambda x, w: shd.constrain(x @ w, None, None),
        _dt(fake_mesh, (m, k // 2), [Replicate(), Shard(1)]),
        _dt(fake_mesh, (k // 2, n), [Replicate(), Shard(0)])))
    assert t["collective_bytes_by_axis"] == {"model": m * n * 4}
    assert t["collective_counts"] == {"all_reduce": 1}
    assert t["flops"] == 2 * m * (k // 2) * n


@pytest.mark.parametrize("causal", [True, False])
def test_kernel_meta_forms_count_by_their_formulas(causal):
    b, hq, hkv, sq, sk, d = 2, 8, 2, 48, 80, 64
    with FakeTensorMode():
        q, k, v = (torch.empty(b, h, s, d, dtype=torch.bfloat16)
                   for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
        with cost_analysis.CostMode() as cm:
            out = fa_ops.flash_attention(q, k, v, causal=causal)
    pairs = sum(min(sk, i + sk - sq + 1) for i in range(sq)) if causal else sq * sk
    assert out.shape == q.shape and out.dtype == q.dtype
    assert cm.totals()["flops_by_op"] == {"repro_torch.flash_attention": 4 * b * hq * d * pairs}

    bsz, s, h, p, n, chunk = 2, 40, 4, 8, 16, 16
    with FakeTensorMode():
        x = torch.empty(bsz, s, h, p)
        a = torch.empty(bsz, s, h)
        bb, cc = torch.empty(bsz, s, n), torch.empty(bsz, s, n)
        with cost_analysis.CostMode() as cm:
            y, st = ssd_ops.ssd_scan(x, a, bb, cc, chunk=chunk)
    want = sum(bsz * (2 * L * L * n + L * (L + 1) * h * p + 4 * L * n * h * p)
               for L in (16, 16, 8))
    assert y.shape == x.shape and st.shape == (bsz, h, n, p)
    assert cm.totals()["flops_by_op"] == {"repro_torch.ssd_chunk": want}


def test_roofline_terms_and_bound_with_h100_constants():
    class Cfg:
        @staticmethod
        def active_param_count():
            return 1_000_000

    class Shp:
        kind = "train"
        global_batch = 8
        seq_len = 128

    cost = {"flops": 1e12, "bytes": 1e12,
            "collective_bytes_by_axis": {"model": 4.5e9, "data": 1e9}}
    t = roofline.roofline_terms(Cfg, Shp, cost, chips=256)
    assert t["chips"] == 256
    assert t["compute_s"] == pytest.approx(1e12 / 989e12)
    assert t["memory_s"] == pytest.approx(1e12 / 3.35e12)
    assert t["collective_s"] == pytest.approx(4.5e9 / 450e9 + 1e9 / 50e9)
    assert t["bound"] == "memory"
    mf = 6.0 * 1e6 * 8 * 128
    assert t["model_flops"] == pytest.approx(mf) == jroof.model_flops(Cfg, Shp)
    assert t["useful_flops_ratio"] == pytest.approx(mf / (1e12 * 256))
    assert t["step_time_lower_bound_s"] == t["memory_s"]
    assert 0 < t["roofline_fraction"] < 1
    with pytest.raises(ValueError):
        roofline.roofline_terms(Cfg, Shp, {"collective_bytes_by_axis": {"sel": 1.0}}, chips=1)


def test_production_meshes_keep_the_chip_counts_on_nodes_of_eight():
    assert production_layout() == ((32, 8), ("data", "model"), "32x8")
    assert production_layout(multi_pod=True) == ((2, 32, 8), ("pod", "data", "model"), "2x32x8")


def _smoke_cfg(block):
    return dataclasses.replace(treg.smoke("yi-6b"), remat=True, attention_impl="chunked",
                               attn_block=block)


def _local_numel(shape, pls, mesh):
    n = math.prod(shape)
    for i, p in enumerate(pls):
        if isinstance(p, Shard):
            n //= mesh.size(i)
    return n


def _expected_argument_bytes(cfg, shape, mesh):
    """The step's inputs, one device's shards, from the rules alone."""
    with FakeTensorMode():
        full = tlm.init_lm(cfg, device="cpu")
    params = T.leaves(full)
    pls = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, list):
            pls.extend(node)
        else:
            pls.append(node)
    walk(shd.param_shardings(mesh, full))
    pbytes = sum(_local_numel(t.shape, p, mesh) * t.element_size() for t, p in zip(params, pls))
    b = shape.global_batch
    rows = _local_numel((b,), shd.data_spec(mesh, b, 0), mesh)
    if shape.kind == "train":   # params, AdamW m and v (f32), its t, the step; tokens, labels
        f32 = sum(_local_numel(t.shape, p, mesh) * 4 for t, p in zip(params, pls))
        return pbytes + 2 * f32 + 4 + 4 + 2 * rows * shape.seq_len * 4
    kv = shd.cache_spec(mesh, b, shape.seq_len, cfg.num_kv_heads)
    cache = _local_numel((b, shape.seq_len, cfg.num_kv_heads, cfg.head_dim), kv, mesh) * 2
    return pbytes + cfg.num_layers * (2 * cache + b * 4) + rows * 4 + 4


REF_DECODE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, jax
from repro.configs import registry
from repro.configs.base import ShapeConfig
from repro.launch import specs, hlo_analysis, roofline
from repro.launch.mesh import make_mesh
from repro.optim.optimizers import adamw
from repro.train import train_state as ts
mesh = make_mesh((4, 2), ("data", "model"))
cfg = dataclasses.replace(registry.smoke("yi-6b"), remat=True, attention_impl="chunked",
                          attn_block=32)
shape = ShapeConfig("d", 64, 8, "decode")
with mesh:
    params, caches, batch = specs.input_specs(cfg, mesh, shape, adamw())
    compiled = jax.jit(ts.make_serve_step(cfg)).lower(params, caches, batch).compile()
t = hlo_analysis.analyze(compiled.as_text())
print("REF", json.dumps({"flops": t["flops"], "model_flops": roofline.model_flops(cfg, shape)}))
"""


@pytest.mark.parametrize("fake_mesh", [MESH42], indirect=True)
def test_dry_run_smoke_cell_train_and_decode(fake_mesh):
    ref = subprocess.Popen([sys.executable, "-c", REF_DECODE], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, cwd=REPO_ROOT,
                           env=dict(os.environ, PYTHONPATH="src"))
    cfg = _smoke_cfg(32)
    got = {}
    for shape in (ShapeConfig("t", 64, 8, "train"), ShapeConfig("d", 64, 8, "decode")):
        rec = dryrun.analyze(cfg, shape, fake_mesh)
        c = rec["cost"]
        assert c["flops"] > 0 and c["bytes"] > 0, (shape.kind, c)
        assert rec["memory"]["argument_size_in_bytes"] == _expected_argument_bytes(
            cfg, shape, fake_mesh)
        assert rec["memory"]["peak_memory_in_bytes"] >= rec["memory"]["argument_size_in_bytes"]
        assert rec["roofline"]["chips"] == 8
        got[shape.kind] = rec
    assert not torch.cuda.is_initialized()
    # the reference pads its chunked attention's keys to its own 512-key
    # block whatever cfg.attn_block says (the port honours it), so the like
    # for like cell gives the port that block
    like = dryrun.analyze(_smoke_cfg(512), ShapeConfig("d", 64, 8, "decode"), fake_mesh)
    stdout, stderr = ref.communicate(timeout=300)
    line = [ln for ln in stdout.splitlines() if ln.startswith("REF ")]
    assert line, stderr[-2000:]
    want = json.loads(line[0][4:])
    port, port32 = like["cost"]["flops"], got["decode"]["cost"]["flops"]
    print(f"decode FLOPs a device: reference {want['flops']:.0f}, port {port:.0f} "
          f"(block 512), {port32:.0f} (block 32)")
    assert like["roofline"]["model_flops"] == want["model_flops"]
    assert got["decode"]["roofline"]["model_flops"] == want["model_flops"]
    assert 0.85 <= port / want["flops"] <= 1.15


def test_run_cell_records_a_skip_and_a_failure(tmp_path, monkeypatch):
    rec = dryrun.run_cell("yi-6b", "long_500k", multi_pod=False, out_dir=str(tmp_path))
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]
    assert json.loads((tmp_path / "yi-6b_long_500k_sp.json").read_text())["mesh"] == "32x8"

    def broken(*a, **k):
        raise RuntimeError("planted failure")

    monkeypatch.setattr(dryrun, "analyze", broken)
    try:
        code = dryrun.main(["--arch", "yi-6b", "--shape", "decode_32k", "--out", str(tmp_path)])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert code == 1
    rec = json.loads((tmp_path / "yi-6b_decode_32k_sp.json").read_text())
    assert rec["status"] == "error" and "planted failure" in rec["traceback"]
    assert rec["attention_impl"] == "pallas" and rec["ssm_impl"] == "pallas"


def test_report_tables_and_summary(tmp_path):
    base = {"params": 1, "active_params": 1}
    roof = {"compute_s": 0.1, "memory_s": 0.2, "collective_s": 0.05, "bound": "memory",
            "model_flops": 1e15, "useful_flops_ratio": 0.5, "roofline_fraction": 0.25}
    recs = [dict(base, arch="yi-6b", shape="train_4k", mesh="32x8", status="ok",
                 roofline=roof, memory={"argument_size_in_bytes": 2e9}),
            dict(base, arch="yi-6b", shape="long_500k", mesh="32x8", status="skipped",
                 reason="pure full attention"),
            dict(base, arch="yi-6b", shape="decode_32k", mesh="2x32x8", status="error")]
    for i, r in enumerate(recs):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    loaded = report.load_all(str(tmp_path))
    assert report.fmt_summary(loaded) == "1 ok, 1 skipped (documented), 1 errors of 3 cells"
    sp = report.fmt_table(loaded, "32x8")
    assert "| yi-6b | train_4k | ok | 0.1 | 0.2 | 0.05 | **memory** |" in sp
    assert "skipped — pure full attention" in sp and "ERROR" not in sp
    assert "| yi-6b | decode_32k | ERROR |" in report.fmt_table(loaded, "2x32x8")
