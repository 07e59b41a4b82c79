"""The port's span-and-counter registry (``repro_torch.obs``) inside the LM
train step, and the readers of the benchmark's per-layer metrics that read
it.

Off, the registry records nothing and adds no autograd node, and the step's
outputs are those of a step without it.  On (``obs.enable()`` or a recording
``torch.profiler``), a step of a 2-layer chunked LM gives the span tree the
step's layers make, remat recomputes included; gradients stay bit-equal;
the attention counters equal their closed forms; self times add up to their
parents; and the host stamps sit on the profiler's clock.  The tests marked
``cuda`` run a step on the card (``python -m pytest -q -m cuda
tests/test_torch_obs.py``); this file imports no JAX.
"""
import importlib.util
import sys
import time
from pathlib import Path

import pytest
import torch

from repro_torch import obs
from repro_torch import tree as T
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.models import attention as attn
from repro_torch.models import blocks, lm
from repro_torch.optim.optimizers import adamw
from repro_torch.optim.schedules import cosine
from repro_torch.train import train_state as ts

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
LAYERS, SEQ, BLOCK = 2, 32, 8
# the profiler stamps host events with an approximate clock (the CPU's time
# stamp counter scaled to Unix time): up to 0.29 ms off time.time_ns() in a
# process's first profiled stretch, ~2 µs after it; another clock would be
# ~1.8e18 ns away
SKEW_NS = 1_000_000
READERS = ["attn_ms.lm_train", "ffn_ms.lm_train", "head_loss_ms.lm_train",
           "optim_elapsed_ms.lm_train", "attn_pairs_kept.lm_train", "attn_passes.lm_train"]


def _cfg(dtype="float32", remat=True):
    return ModelConfig(name="tiny", family="dense", num_layers=LAYERS, d_model=32, num_heads=4,
                       num_kv_heads=2, d_ff=64, vocab_size=64, attention_impl="chunked",
                       attn_block=BLOCK, remat=remat, dtype=dtype)


def _batch(device="cpu"):
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, 64, (2, SEQ), generator=g)
    return {"tokens": tok.to(device), "labels": torch.roll(tok, -1, 1).to(device),
            "weights": torch.tensor([1.0, 0.5], device=device)}


def _step(cfg, device="cpu"):
    opt = adamw()
    state = ts.init_train_state(cfg, opt, seed=0, device=device)
    return state, ts.make_train_step(cfg, opt, cosine(1e-3, 10), grad_clip=1.0)


@pytest.fixture(autouse=True)
def clean_registry():
    obs.REGISTRY.enabled = False
    obs.reset()
    yield
    obs.REGISTRY.enabled = False
    obs.reset()


def _records(snap, i=0):
    recs = snap["steps"][i]["records"]
    return [(r["name"], None if r["parent"] is None else recs[r["parent"]]["name"],
             r["recompute"]) for r in recs]


def _marker_nodes(t):
    """Names of the registry's marker nodes in ``t``'s autograd graph."""
    seen, out, todo = set(), [], [t.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        if "OpenBackward" in type(node).__name__ or "CloseBackward" in type(node).__name__:
            out.append(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return out


def test_off_records_nothing_and_adds_no_marker_node():
    cfg = _cfg()
    state, step = _step(cfg)
    step(state, _batch())
    assert obs.snapshot()["steps"] == [] and not obs.recording()
    leaves = [p.detach().requires_grad_(True) for p in T.leaves(state.params)]
    loss, _ = lm.loss_fn(T.unflatten(state.params, leaves), cfg, _batch())
    assert _marker_nodes(loss) == []
    obs.enable()
    with obs.step("train.step", device="cpu"):
        loss, _ = lm.loss_fn(T.unflatten(state.params, leaves), cfg, _batch())
        # embed, 2 × (attention, ffn), head: an open and a close each
        assert len(_marker_nodes(loss)) == 2 * (1 + 2 * LAYERS + 1)


def test_step_outputs_bit_identical_on_and_off():
    cfg = _cfg("bfloat16")
    state, step = _step(cfg)
    off_state, off_metrics = step(state, _batch())
    obs.enable()
    on_state, on_metrics = step(state, _batch())
    assert len(obs.snapshot()["steps"]) == 1
    for a, b in zip(T.leaves((off_state, off_metrics)), T.leaves((on_state, on_metrics))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_span_tree_names_parents_and_counts():
    cfg = _cfg()
    state, step = _step(cfg)
    obs.enable()
    step(state, _batch())
    recs = _records(obs.snapshot())
    layer_fwd = [("lm.attention", "train.forward", False), ("lm.ffn", "train.forward", False)]
    # remat: each layer's group is recomputed when its FFN's backward first
    # needs a saved activation, so both recomputes run inside lm.ffn.bwd
    layer_bwd = [("lm.ffn.bwd", "train.backward", False),
                 ("lm.attention", "lm.ffn.bwd", True), ("lm.ffn", "lm.ffn.bwd", True),
                 ("lm.attention.bwd", "train.backward", False)]
    assert recs == ([("train.step", None, False), ("train.forward", "train.step", False),
                     ("lm.embed", "train.forward", False)] + layer_fwd * LAYERS
                    + [("lm.head", "train.forward", False),
                       ("train.backward", "train.step", False),
                       ("lm.head.bwd", "train.backward", False)] + layer_bwd * LAYERS
                    + [("lm.embed.bwd", "train.backward", False),
                       ("train.clip", "train.step", False),
                       ("optim.update", "train.step", False)])
    spans = obs.snapshot()["spans"]
    assert spans["lm.attention"]["count"] == 2 * LAYERS
    assert spans["lm.attention"]["recompute"]["count"] == LAYERS
    assert spans["lm.attention.bwd"]["recompute"]["count"] == 0


def test_span_tree_without_remat_has_no_recompute():
    cfg = _cfg(remat=False)
    state, step = _step(cfg)
    obs.enable()
    step(state, _batch())
    recs = _records(obs.snapshot())
    assert not any(r for _, _, r in recs)
    assert [n for n, p, _ in recs if p == "train.backward"] == (
        ["lm.head.bwd"] + ["lm.ffn.bwd", "lm.attention.bwd"] * LAYERS + ["lm.embed.bwd"])
    c = obs.snapshot()["counters"]
    assert c["attn.block_steps"] == 2 * LAYERS * SEQ // BLOCK   # forward + block recompute


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gradients_bit_equal_with_markers(dtype, remat):
    cfg = _cfg(dtype, remat)
    state, _ = _step(cfg)
    loss_off, g_off = ts._loss_and_grads(state.params, cfg, _batch())
    obs.enable()
    with obs.step("train.step", device="cpu"):
        loss_on, g_on = ts._loss_and_grads(state.params, cfg, _batch())
    assert torch.equal(loss_off, loss_on)
    for a, b in zip(T.leaves(g_off), T.leaves(g_on)):
        assert torch.equal(a, b)
    assert obs.snapshot()["spans"]["lm.embed.bwd"]["count"] == 1


def _brute_counts(b, sq, sk, h, block, causal, k_len):
    """(block steps, pairs computed, pairs kept) by materialising each
    block's mask."""
    steps = computed = kept = 0
    n_blocks = -(-sk // block)
    lens = torch.full((b,), sk) if k_len is None else torch.as_tensor(k_len).expand(b)
    for j in range(n_blocks):
        cols = torch.arange(j * block, (j + 1) * block)
        rows = torch.arange(sq)[:, None] + (sk - sq)
        keep = (cols[None, None, :] < lens[:, None, None]).expand(b, sq, block)
        if causal:
            keep = keep & (cols[None, :] <= rows)[None]
        steps += 1
        computed += b * h * sq * block
        kept += h * int(keep.sum())
    return steps, computed, kept


@pytest.mark.parametrize("sq, sk, block, causal, k_len", [
    (32, 32, 8, True, None),
    (32, 32, 8, False, None),
    (20, 20, 8, True, None),          # keys padded to a whole block
    (4, 24, 8, True, None),           # queries at the end of a longer key range
    (24, 24, 16, False, None),
    (6, 24, 8, True, [13, 24]),       # per-slot valid lengths, counted on the device
    (6, 24, 8, False, 17),
])
def test_attention_counters_equal_their_closed_forms(sq, sk, block, causal, k_len):
    b, h, hkv, d = 2, 4, 2, 8
    g = torch.Generator().manual_seed(1)
    q = torch.randn(b, sq, h, d, generator=g)
    k = torch.randn(b, sk, hkv, d, generator=g)
    v = torch.randn(b, sk, hkv, d, generator=g)
    obs.enable()
    with obs.step("probe", device="cpu"):
        attn._chunked_attn(q, k, v, causal=causal, block=block,
                           k_len=None if k_len is None else torch.tensor(k_len))
    c = obs.snapshot()["counters"]
    want = _brute_counts(b, sq, sk, h, block, causal, k_len)
    assert (c["attn.block_steps"], c["attn.pairs_computed"], c["attn.pairs_kept"]) == want


def _route_inputs(case):
    """q, k and v of one route case: bf16 self-attention unless the case
    changes it."""
    g = torch.Generator().manual_seed(2)
    s, d = 16, 136 if case == "d136" else 16
    sk = 24 if case == "cross" else s
    qdt = torch.float32 if case == "f32" else torch.bfloat16
    kvdt = torch.float32 if case in ("f32", "f32_context") else torch.bfloat16
    q = torch.randn(1, s, 4, d, generator=g).to(qdt)
    k, v = (torch.randn(1, sk, 2, d, generator=g).to(kvdt) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("case", ["bf16", "f32", "f32_context", "k_len", "cross", "d136"])
def test_chunked_route_takes_the_fused_pair_only_where_the_inputs_qualify(case, monkeypatch):
    """With the inputs standing in for card tensors, only bf16 self-attention
    without key lengths and a head dim TMA takes (<= 128, a multiple of 8)
    reaches the fused kernels; f32 inputs, an f32 context, decode's key
    lengths, cross-attention (Sq != Sk) and D 136 run the loop, which counts
    its block steps and no fused call."""
    calls = []
    monkeypatch.setattr(attn, "_on_card", lambda t: True)
    monkeypatch.setattr(attn, "_fused_attn",
                        lambda q, k, v, *, causal: calls.append(causal) or torch.zeros_like(q))
    q, k, v = _route_inputs(case)
    k_len = torch.tensor([10]) if case == "k_len" else None
    obs.enable()
    with obs.step("probe", device="cpu"):
        attn._chunked_attn(q, k, v, causal=case != "cross", block=8, k_len=k_len)
    c = obs.snapshot()["counters"]
    if case == "bf16":
        assert calls == [True] and "attn.block_steps" not in c
    else:
        assert calls == [] and c["attn.block_steps"] > 0 and "attn.fused_calls" not in c


def test_chunked_route_keeps_the_loop_off_the_card_and_on_fake_tensors():
    """CPU tensors run the loop (no fused call counted); fake CUDA tensors
    (the dry run's stand-ins, no data) never qualify, so ``launch/``'s counts
    stay the loop's."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    q, k, v = _route_inputs("bf16")
    obs.enable()
    with obs.step("probe", device="cpu"):
        attn._chunked_attn(q, k, v, causal=True, block=8)
    c = obs.snapshot()["counters"]
    assert c["attn.block_steps"] == 2 and "attn.fused_calls" not in c
    mode = FakeTensorMode()
    fake = [FakeTensor(mode, t.to("meta"), torch.device("cuda")) for t in (q, k, v)]
    assert all(t.device.type == "cuda" for t in fake)
    assert not attn._fused_route(*fake, k_len=None, op_dtype=torch.bfloat16)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 128, 200, 1000, 4096])
@pytest.mark.parametrize("causal", [True, False])
def test_fused_scored_pairs_follow_the_kernels_skip_conditions(s, causal):
    """``scored_pairs`` against an enumeration of the train kernels' skip
    conditions (csrc/flash_attention.cu): the forward's and the dQ kernel's
    warpgroup of 64 rows at row0 < S scores each 128-key tile that starts
    before its end (min(row0 + 64, S), or S non-causal); the dK/dV kernel's
    warpgroup of 64 keys at kw0 < S scores each 64-row step from its tile's
    first (k0 // 64, causal) whose last row reaches kw0."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    by_rows = sum(64 * 128 for row0 in range(0, s, 64) for k0 in range(0, s, 128)
                  if k0 < (min(row0 + 64, s) if causal else s))
    by_keys = sum(64 * 64 for k0 in range(0, s, 128) for kw0 in (k0, k0 + 64) if kw0 < s
                  for q0 in range((k0 // 64 if causal else 0) * 64, s, 64)
                  if not causal or kw0 <= q0 + 63)
    assert (fa.scored_pairs(s, causal, False), fa.scored_pairs(s, causal, True)) == (by_rows,
                                                                                     by_keys)
    kept = s * (s + 1) // 2 if causal else s * s
    assert kept <= min(by_rows, by_keys)


@pytest.mark.parametrize("grad", [True, False])
def test_fused_route_writes_lse_only_where_a_backward_can_follow(grad, monkeypatch):
    """With the inputs standing in for card tensors and a stand-in kernel,
    the fused route asks for the lse and the output's remainder only where a
    gradient can reach q, k or v: under ``no_grad`` (serving's prefill) the
    forward runs alone and no autograd node is made.  Either way it counts
    one fused call and the forward's pass."""
    from repro_torch.kernels.flash_attention import flash_attention as fa

    asked = []

    def kernel(q, k, v, *, causal, for_backward):
        asked.append(for_backward)
        out = torch.zeros_like(q)
        return (out, torch.zeros_like(q), torch.zeros(q.shape[:3])) if for_backward else (
            out, None, None)

    monkeypatch.setattr(attn, "_on_card", lambda t: True)
    monkeypatch.setattr(fa, "flash_attention_train_cuda", kernel)
    q, k, v = (t.requires_grad_() for t in _route_inputs("bf16"))
    obs.enable()
    with obs.step("probe", device="cpu"), torch.set_grad_enabled(grad):
        out = attn._chunked_attn(q, k, v, causal=True, block=8)
    c = obs.snapshot()["counters"]
    assert asked == [grad] and out.requires_grad == grad and out.shape == q.shape
    assert c["attn.fused_calls"] == 1 and c["attn.block_steps"] == 4 * 1


def test_self_times_sum_to_their_parents(monkeypatch):
    """Host self times of the records always; device self times, per
    record and in the per-name totals, through stand-in events that read the
    host clock (the arithmetic of the card's path)."""

    class Event:
        def __init__(self):
            self.t = time.perf_counter_ns()

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return (end.t - self.t) * 1e-6

    monkeypatch.setattr(obs, "device_event", lambda device=None: Event())
    cfg = _cfg()
    state, step = _step(cfg)
    obs.enable()
    step(state, _batch())
    with obs.step("train.step", device="cuda"):   # events from the stand-in
        ts._loss_and_grads(state.params, cfg, _batch())
    snap = obs.snapshot()
    assert snap["steps"][0]["device_ms"] is None and snap["steps"][1]["device_ms"] > 0
    for st in snap["steps"]:
        recs = st["records"]
        for key in ("host", "device"):
            if key == "device" and st["device_ms"] is None:
                continue
            span = [((r["end_ns"] - r["start_ns"]) * 1e-6 if key == "host" else r["device_ms"])
                    for r in recs]
            own = list(span)
            for r, s in zip(recs, span):
                if r["parent"] is not None:
                    own[r["parent"]] -= s
            assert min(own) >= -1e-9
            assert sum(own) == pytest.approx(span[0], rel=1e-9)
    tot = snap["spans"]
    assert sum(v["self_device_ms"] or 0.0 for v in tot.values()) == pytest.approx(
        snap["steps"][1]["device_ms"], rel=1e-9)


def test_host_stamps_share_the_profilers_clock(monkeypatch):
    """Under a CPU ``torch.profiler`` the registry is on, and each MLP call
    the profiler stamps (a probe range around ``blocks.mlp``) lies inside
    the ``time.time_ns()`` interval of its own ``lm.ffn`` span, with every
    aten op inside the probe, within the profiler clock's ``SKEW_NS``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inner = blocks.mlp

    def probed(params, x):
        with torch.profiler.record_function("probe.mlp"):
            return inner(params, x)

    monkeypatch.setattr(blocks, "mlp", probed)
    cfg = _cfg()
    state, step = _step(cfg)
    step(state, _batch())                       # warm, unrecorded
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, _batch())
    step(state, _batch())                       # the profiler is off again
    snap = obs.snapshot()
    assert len(snap["steps"]) == 1
    ffn = [(r["start_ns"], r["end_ns"]) for r in snap["steps"][0]["records"]
           if r["name"] == "lm.ffn"]
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU]
    probes = sorted((e.start_ns(), e.end_ns()) for e in events if e.name() == "probe.mlp")
    assert len(probes) == len(ffn) == 2 * LAYERS
    for (p0, p1), (s0, s1) in zip(probes, sorted(ffn)):
        assert s0 - SKEW_NS <= p0 <= p1 <= s1 + SKEW_NS
        ops = [e for e in events if e.name().startswith("aten::") and p0 <= e.start_ns() <= p1]
        assert ops and all(s0 - SKEW_NS <= e.start_ns() and e.end_ns() <= s1 + SKEW_NS
                           for e in ops)


def test_registry_keeps_the_last_steps_only():
    reg = obs.Registry()
    reg.enable()
    n = obs.MAX_STEPS + 2
    for i in range(n):
        with reg.step("train.step", device="cpu"):
            with reg.span("inner"):
                reg.count("n", i)
    snap = reg.snapshot()
    assert len(snap["steps"]) == obs.MAX_STEPS
    assert snap["spans"]["inner"]["counters"] == {"n": sum(range(2, n))}
    reg.reset()
    assert reg.snapshot() == {"spans": {}, "counters": {}, "steps": []}


def test_a_failing_step_closes_its_spans():
    obs.enable()
    with pytest.raises(RuntimeError):
        with obs.step("train.step", device="cpu"):
            with obs.span("lm.head"):
                raise RuntimeError("boom")
    assert not obs.recording()
    recs = obs.snapshot()["steps"][0]["records"]
    assert [r["name"] for r in recs] == ["train.step", "lm.head"]
    assert all(r["end_ns"] >= r["start_ns"] for r in recs)



def test_a_step_under_capture_is_not_recorded(monkeypatch):
    """A step traced into a CUDA graph (the fused trainer's capture) opens
    no root: its replays run no Python, and its events would only be
    captured.  Outside the capture the same step records."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    capturing = [True]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    obs.enable()
    with obs.step("train.step", device="cuda") as sp:
        assert sp is obs._NULL and not obs.recording()
        assert obs.span("lm.head") is obs._NULL
    capturing[0] = False
    monkeypatch.setattr(obs, "device_event", lambda device=None: None)
    with obs.step("train.step", device="cuda"):
        assert obs.recording()
    assert len(obs.snapshot()["steps"]) == 1


def test_every_other_mixer_is_one_span():
    """A block whose mixer is not attention records its mixer as
    ``lm.mixer``, with its backward as ``lm.mixer.bwd``."""
    cfg = ModelConfig(name="tiny-hybrid", family="hybrid", num_layers=2, d_model=32,
                      num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
                      attention_impl="chunked", attn_block=BLOCK, remat=False,
                      pattern=(("mamba", "dense"), ("attn", "dense")))
    state, step = _step(cfg)
    obs.enable()
    step(state, _batch())
    spans = obs.snapshot()["spans"]
    assert spans["lm.mixer"]["count"] == spans["lm.mixer.bwd"]["count"] == 1
    assert spans["lm.attention"]["count"] == 1 and spans["lm.ffn"]["count"] == 2

def _reader(name):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _synthetic(n_steps):
    def span(count, device_ms, self_ms, counters=None, rc=0, rc_counters=None):
        return {"count": count, "device_ms": device_ms, "self_device_ms": self_ms,
                "counters": counters or {},
                "recompute": {"count": rc, "counters": rc_counters or {}}}

    return {
        "spans": {
            "lm.attention": span(48, 900.0, 900.0, {"attn.block_steps": 384}, 24,
                                 {"attn.block_steps": 192}),
            "lm.attention.bwd": span(24, 2100.0, 1500.0, {"attn.block_steps": 192}),
            "lm.ffn": span(48, 300.0, 300.0, rc=24),
            "lm.ffn.bwd": span(24, 1200.0, 300.0),
            "lm.head": span(1, 60.0, 60.0),
            "lm.head.bwd": span(1, 90.0, 90.0),
            "optim.update": span(1, 345.0, 345.0),
        },
        "counters": {"attn.block_steps": 576, "attn.pairs_computed": 4096 * 4096,
                     "attn.pairs_kept": 4096 * 4097 // 2},
        "steps": [{"name": "train.step"}] * n_steps,
    }


WANT = {"attn_ms.lm_train": (900 + 1500) / 3, "ffn_ms.lm_train": (300 + 300) / 3,
        "head_loss_ms.lm_train": (60 + 90) / 3, "optim_elapsed_ms.lm_train": 345 / 3,
        "attn_pairs_kept.lm_train": 100 * 4097 / 8192, "attn_passes.lm_train": 3.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_gives_nothing_without_the_profiled_steps(name, monkeypatch):
    read = _reader(name).read
    assert read({"steps_profiled": 3}) is None               # an empty registry
    monkeypatch.setattr(obs, "snapshot", lambda: _synthetic(4))
    assert read({"steps_profiled": 3}) is None               # another step count
    assert read({}) is None
    # a program without the registry
    monkeypatch.delattr(sys.modules["repro_torch"], "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert read({"steps_profiled": 4}) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_value_per_step_on_a_synthetic_snapshot(name, monkeypatch):
    monkeypatch.setattr(obs, "snapshot", lambda: _synthetic(3))
    assert _reader(name).read({"steps_profiled": 3}) == pytest.approx(WANT[name], rel=1e-12)


def test_device_time_readers_give_nothing_off_the_card():
    cfg = _cfg()
    state, step = _step(cfg)
    obs.enable()
    step(state, _batch())
    for name in READERS:
        value = _reader(name).read({"steps_profiled": 1})
        if name in ("attn_pairs_kept.lm_train", "attn_passes.lm_train"):
            assert value == pytest.approx({"attn_pairs_kept.lm_train": 100 * 33 / 64,
                                           "attn_passes.lm_train": 3.0}[name])
        else:
            assert value is None


def test_straggler_monitor_host_path():
    mon = StragglerMonitor(warmup_steps=2, device="cpu")
    for i in range(3):
        mon.start()
        time.sleep(0.002)
        mon.stop(i)
    mon.drain()
    assert mon._n == 3 and 0.002 <= mon.mean_step_time < 1.0
    assert StragglerMonitor().device is None


# -- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (device timing events)")
    return torch.device("cuda")


def _fused_trainer(device, superstep):
    """A ``Trainer(fused=True)`` over the tiny LM's step and a column store of
    token rows (8 batches of 2 an epoch)."""
    import numpy as np

    from repro_torch.data.pipeline import Pipeline
    from repro_torch.selection.registry import build_selector
    from repro_torch.train.trainer import Trainer, TrainerConfig

    rng = np.random.default_rng(0)
    tok = rng.integers(0, 64, size=(16, SEQ)).astype(np.int64)
    sel = build_selector("adaptive_random", n=16, k=16, R=1, seed=3)
    pipe = Pipeline(None, sel, 2, seed=1, arrays={"tokens": tok, "labels": np.roll(tok, -1, 1)},
                    device=device)
    cfg = _cfg("bfloat16")
    state, step = _step(cfg, device)
    return Trainer(step, pipe, TrainerConfig(epochs=1), fused=True, superstep=superstep), state


@pytest.mark.cuda
def test_profiled_step_on_the_card_has_device_times_and_no_profiler_ranges(card, monkeypatch):
    """A profiled step on the card: every record has its device time, the
    self times add up to the step's, no program span reaches the profiler's
    device timeline, and each MLP call the profiler stamps (a probe range
    around ``blocks.mlp``) lies inside its ``lm.ffn`` span's
    ``time.time_ns()`` stamps with every aten op inside it: the shared
    clock, checked on the card's own torch with the CUDA activity on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    inner = blocks.mlp

    def probed(params, x):
        with torch.profiler.record_function("probe.mlp"):
            return inner(params, x)

    monkeypatch.setattr(blocks, "mlp", probed)
    cfg = _cfg("bfloat16")
    state, step = _step(cfg, card)
    state, _ = step(state, _batch(card))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, _batch(card))
    torch.cuda.synchronize()
    snap = obs.snapshot()
    assert len(snap["steps"]) == 1
    st = snap["steps"][0]
    assert st["device_ms"] > 0
    assert all(r["device_ms"] is not None and r["device_ms"] >= 0 for r in st["records"])
    own = sum(v["self_device_ms"] for v in snap["spans"].values())
    assert own == pytest.approx(st["device_ms"], rel=0.02)
    names = set(snap["spans"])
    events = list(prof.profiler.kineto_results.events())
    dev = [e.name() for e in events if e.device_type() == DeviceType.CUDA]
    assert dev and not names & set(dev)
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    ffn = sorted((r["start_ns"], r["end_ns"]) for r in st["records"] if r["name"] == "lm.ffn")
    probes = sorted((e.start_ns(), e.end_ns()) for e in host if e.name() == "probe.mlp")
    assert len(probes) == len(ffn) == 2 * LAYERS
    for (p0, p1), (s0, s1) in zip(probes, ffn):
        assert s0 - SKEW_NS <= p0 <= p1 <= s1 + SKEW_NS
        ops = [e for e in host if e.name().startswith("aten::") and p0 <= e.start_ns() <= p1]
        assert ops and all(s0 - SKEW_NS <= e.start_ns() and e.end_ns() <= s1 + SKEW_NS
                           for e in ops)


@pytest.mark.cuda
def test_fused_trainer_records_no_captured_step(card):
    """``Trainer(fused=True)`` with the registry on: the engine's warm-up of
    each graph runs the step eagerly and is recorded; the capture is not,
    and the replays run no Python.  ``snapshot()`` then reads only events
    that were really recorded on a stream."""
    from repro_torch.train import engine as engine_mod

    superstep = 4
    trainer, state = _fused_trainer(card, superstep)
    assert trainer.fused_active()
    obs.enable()
    captures, replays = engine_mod.captures, engine_mod.replays
    state = trainer.fit(state)
    torch.cuda.synchronize()
    assert int(state.step) == 8
    assert (engine_mod.captures - captures, engine_mod.replays - replays) == (1, 2)
    snap = obs.snapshot()
    assert len(snap["steps"]) == superstep          # the warm-up's steps alone
    assert all(st["device_ms"] is not None and st["device_ms"] > 0 for st in snap["steps"])


@pytest.mark.cuda
def test_straggler_monitor_times_the_step_on_the_card(card):
    mon = StragglerMonitor(warmup_steps=2, device=card)
    a = torch.randn(2048, 2048, device=card)
    for i in range(4):
        mon.start()
        for _ in range(20):
            a = torch.tanh(a @ a * 1e-3)
        mon.stop(i)
    mon.drain()
    assert mon._n == 4 and not mon._pending and mon.mean_step_time > 0
