"""Driver of the ``lm_train_hybrid`` traffic: the ``lm_train`` cell's job
(MILO preprocess of the token corpus in set-up, the ``milo`` selector, the
``Pipeline``, ``make_train_step`` with AdamW, the cosine learning rate and
the global clip, one closed-loop step a unit) on LFM2-8B-A1B at one
expert-parallel rank's share: the program's ``HybridConfig`` (gated
short-conv and QK-norm attention layers, the dropless sigmoid-routed MoE
holding the file's ``num_experts`` of the router's ``router_experts``).

The weights are drawn on the card from the seed (``bench/reference/lfm2.py``),
with the configuration's fixed ``expert_bias``.  During the judged steps the
driver wraps the program's router (``moe._sigmoid_router``) and keeps the
experts it chose in each MoE layer's forward; after the window the
program's state is freed and the reference trains the same first steps
along those choices (``bench/reference/lfm2.py``), and judges the choices
(``route_err``), the selection and the batches as the ``lm_train`` cell
does.  With ``trace``: the ``lm_train`` driver's trace, with the FLOPs of
this model (``bench/counts/lfm2.py``) and of one held expert row.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench import data, trace as tr
from bench.counts import lfm2 as counts
from bench.drivers.lm_train import _batch_stream, reference_batches
from bench.reference import lfm2 as ref, lm as ref_lm, selection as ref_sel

_MIXER = ("in_proj", "conv", "out_proj", "wq", "wk", "wv", "wo", "q_norm", "k_norm")
_FFN = ("router", "w_gate", "w_up", "w_down")
FAULTS = ("half_batch", "state_unchanged", "bias_ignored")


def model_config(config: dict):
    """The program's ``HybridConfig`` for the configuration file's model."""
    from repro_torch.configs.hybrid import HybridConfig

    m, run = config, config["run"]
    return HybridConfig(
        name=config["name"], family="hybrid", num_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], num_heads=m["num_attention_heads"],
        num_kv_heads=m["num_key_value_heads"], d_ff=m["intermediate_size"],
        vocab_size=m["vocab_size"], pattern=tuple(ref.layer_kinds(m)),
        num_experts=m["router_experts"], experts_per_token=m["num_experts_per_tok"],
        moe_d_ff=m["moe_intermediate_size"], qk_norm=True, conv_kernel=m["conv_L_cache"],
        router="sigmoid_bias", routed_scaling_factor=float(m["routed_scaling_factor"]),
        experts_held=m["num_experts"], expert_offset=m["expert_offset"],
        rope_theta=float(m["rope_theta"]), norm_eps=float(m["norm_eps"]),
        tie_embeddings=bool(m["tie_word_embeddings"]), dtype=m["torch_dtype"],
        attention_impl=run["attention_impl"], attn_block=run["attn_block"], remat=run["remat"])


def param_tree(weights: dict, model: dict) -> dict:
    """The program's weight tree (a pattern as long as the stack, so each
    leaf is its one layer's tensor) holding the benchmark's tensors, and
    each MoE layer's ``expert_bias`` buffer."""
    from repro_torch.tree import Buffer, Stacked

    biases = ref.bias(model)
    groups = {}
    for i, (mixer, ffn) in enumerate(ref.layer_kinds(model)):
        p = f"layers.{i}."
        groups[f"b{i}"] = block = {"norm1": Stacked([weights[p + "norm1"]]),
                                   "norm2": Stacked([weights[p + "norm2"]]),
                                   "mixer": {}, "ffn": {}}
        for part in _MIXER + _FFN:
            if p + part in weights:
                block["mixer" if part in _MIXER else "ffn"][part] = Stacked([weights[p + part]])
        if ffn == "moe":
            block["ffn"]["expert_bias"] = Stacked([Buffer(biases[i].to(weights["embed"].device))])
    return {"embed": weights["embed"], "groups": groups, "final_norm": weights["final_norm"]}


def leaf(tree: dict, name: str) -> torch.Tensor:
    """The program tree's tensor of a weight named as ``ref.leaf_specs``."""
    if name in ("embed", "final_norm"):
        return tree[name]
    _, i, part = name.split(".")
    block = tree["groups"][f"b{i}"]
    if part in _MIXER:
        return block["mixer"][part][0]
    if part in _FFN:
        return block["ffn"][part][0]
    return block[part][0]


def _norms(tree: dict, names: list[str], scale: float = 1.0) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(leaf(tree, n).double()) * scale
                        for n in names])


class _RouteRecorder:
    """The program's router wrapped: the experts each MoE layer's forward
    chose in a step (the first ``n_layers`` calls; a remat recompute
    repeats them), kept on the host.  ``bias_ignored`` plants the fault of
    a router that routes by the scores alone."""

    def __init__(self, n_layers: int, fault: str | None):
        self.n_layers, self.fault = n_layers, fault
        self.calls: list[torch.Tensor] = []
        self.steps: list[list[np.ndarray]] = []

    def install(self):
        from repro_torch.models import moe
        from repro_torch.tree import Buffer

        self.inner = inner = moe._sigmoid_router

        def recording(params, x, top_k, scale=1.0):
            if self.fault == "bias_ignored":
                params = dict(params, expert_bias=Buffer(torch.zeros_like(
                    params["expert_bias"].value)))
            w, ids = inner(params, x, top_k, scale)
            if len(self.calls) < self.n_layers:
                self.calls.append(ids.to(torch.uint8))
            return w, ids

        moe._sigmoid_router = recording

    def end_step(self) -> None:
        self.steps.append([c.cpu().numpy() for c in self.calls])
        self.calls = []

    def remove(self) -> None:
        from repro_torch.models import moe

        moe._sigmoid_router = self.inner


def setup(config: dict, traffic: dict, seed: int, device, *, trace: bool = False,
          fault: str | None = None) -> dict:
    """Everything up to the window: the program's objects, its readings of
    the judged steps (and the experts they chose), and what the reference
    needs."""
    from repro_torch.core.milo import MiloPreprocessor
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.device import grow_segments
    from repro_torch.optim.optimizers import Optimizer, adamw
    from repro_torch.optim.schedules import cosine
    from repro_torch.selection import build_selector
    from repro_torch.train.train_state import TrainState, make_train_step

    from bench.drivers.select import Recorder

    t = traffic
    cfg = model_config(config)
    # the head's f32 logits and their gradients come and go as 8 GiB blocks
    # each step: the port's training launcher lets the allocator grow its
    # segments, and so does this run
    grow_segments(device)
    corpus = data.TokenCorpus(t["n_docs"], t["seq_len"], config["vocab_size"], seed)
    feats = corpus.features()
    rec = Recorder()
    rec.install()
    rec.begin_unit()
    try:
        md = MiloPreprocessor(device=device, **t["preprocess"]).preprocess(feats, None, seed=seed)
    finally:
        rec.end_unit()
        rec.remove()
    selector = build_selector("milo", metadata=md, total_epochs=t["epochs"], seed=seed,
                              device=device)
    pipeline = Pipeline(corpus.batch, selector, t["batch_size"], seed=seed, device=device)
    opt = adamw()
    if trace:
        upd = opt.update

        def update(*a, **kw):
            with torch.profiler.record_function(tr.SPAN_PREFIX + "optim"):
                return upd(*a, **kw)

        opt = Optimizer(opt.init, update)
    total_steps = max(1, pipeline.steps_per_epoch() * t["epochs"])
    step_fn = make_train_step(cfg, opt, cosine(t["lr"], total_steps), grad_clip=t["clip"])
    weights = ref.weights(config, seed, device)
    params = param_tree(weights, config)
    del weights
    state = TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32, device=device))
    del params
    names = [s[0] for s in ref.leaf_specs(config)]

    def feed(batch: dict) -> dict:
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        if fault == "half_batch":   # half of the batch left out, the mean over the rest
            b = {k: v[: max(1, v.shape[0] // 2)] for k, v in b.items()}
        return b

    routes = _RouteRecorder(len(ref.moe_layers(config)), fault)
    batches = _batch_stream(pipeline)
    seen, losses = [], []
    grad1 = None
    routes.install()
    try:
        for step in range(t["judged_steps"]):
            batch = next(batches)
            seen.append({k: np.array(v) for k, v in batch.items()})
            new_state, metrics = step_fn(state, feed(batch))
            routes.end_step()
            if fault != "state_unchanged":
                state = new_state
            del new_state
            losses.append(metrics["loss"])
            if step == 0:
                # the first gradient as the optimizer took it: m1 = (1 - b1)·g
                grad1 = _norms(state.opt_state["m"], names, 1.0 / (1.0 - 0.9))
    finally:
        routes.remove()
    w0 = ref.weights(config, seed, device)
    change = torch.stack([torch.linalg.vector_norm((leaf(state.params, n).double()
                                                    - w0[n].double())) for n in names])
    del w0
    prog = {"losses": [float(x) for x in losses],
            "grad1": dict(zip(names, grad1.tolist())),
            "change": dict(zip(names, change.tolist()))}
    tr.fence(device)
    return {"state": state, "step_fn": step_fn, "feed": feed, "batches": batches,
            "prog": prog, "routes": routes.steps, "seen": seen, "metadata": md, "feats": feats,
            "record": rec.host_record(0), "corpus": corpus, "total_steps": total_steps,
            "tokens_per_step": t["batch_size"] * t["seq_len"]}


def _spec(traffic: dict) -> dict:
    return {"subset_fraction": traffic["preprocess"]["subset_fraction"],
            "n_sge_subsets": traffic["preprocess"]["n_sge_subsets"], "eps": 0.01,
            "graph_cut_lambda": 0.4, "easy_fn": "graph_cut", "hard_fn": "disparity_min"}


def judge(ctx: dict, config: dict, traffic: dict, seed: int, device) -> dict:
    """Every number of the cell: the selection's, the batches' (exact), and
    the training's (the ``lm_train`` cell's three gaps and ``route_err``),
    the reference replaying the program's choices."""
    md = ctx["metadata"]
    t = traffic
    labels = np.zeros((len(ctx["feats"]),), np.int64)
    sel = ref_sel.judge(ctx["feats"], labels,
                        {"artifact": {"sge_subsets": md.sge_subsets,
                                      "wre_importance": md.wre_importance,
                                      "wre_probs": md.wre_probs},
                         "classes": ctx["record"]}, _spec(t), seed, device)
    batches = reference_batches(md.sge_subsets, ctx["corpus"], t, seed, t["judged_steps"])
    batch_faults = sum(int(not np.array_equal(ctx["seen"][i][k], batches[i][k]))
                       for i in range(len(batches)) for k in ("tokens", "labels", "weights"))
    run = ref.train(config, seed, batches, lr=t["lr"], total_steps=ctx["total_steps"],
                    device=device, clip=t["clip"], replay=ctx["routes"])
    numbers = ref_lm.judge(ctx["prog"], run)
    numbers["route_err"] = run["route_err"]
    numbers.update({"sel_" + k: v for k, v in sel.items()})
    numbers["batch_faults"] = float(batch_faults)
    return numbers


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(config: dict, traffic: dict, *, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    ctx = setup(config, traffic, seed, device, trace=trace)
    setup_s = time.perf_counter() - t_start
    state, step_fn, feed, batches = ctx["state"], ctx["step_fn"], ctx["feed"], ctx["batches"]
    del ctx["state"]
    prof = tr.Profile(device) if trace else None
    prof_after = int(traffic.get("profile_after", 2))
    prof_steps = int(traffic.get("profile_steps", 3))
    waits, marks = [], []
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if trace and n == prof_after:
            prof.start()
        w = time.perf_counter()
        batch = next(batches)
        waits.append(time.perf_counter() - w)
        state, _ = step_fn(state, feed(batch))
        marks.append(time.perf_counter() - t0)
        n += 1
        if trace and prof.active and n == prof_after + prof_steps:
            prof.stop()
    tr.fence(device)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    out = {
        "attempted": n,
        "failed": 0,
        "end_to_end": {"train_tokens_per_s": n * ctx["tokens_per_step"] / window_s,
                       "setup_s": setup_s},
        "memory_peak_bytes": peak,
        "unit_s": [b - a for a, b in zip([0.0] + marks, marks)],
    }
    if trace:
        if prof.active:
            prof.stop()
        red = tr.reduce_events(*prof.events(), window_s=prof.window_s)
        out["trace"] = {
            "steps_profiled": min(prof_steps, max(0, n - prof_after)),
            "steps": n,
            "window_total_s": window_s,
            "profiler_held_s": prof.held_s,
            "flops_per_step": counts.train_flops_per_step(config, traffic["batch_size"],
                                                          traffic["seq_len"]),
            "moe_flops_per_row": counts.expert_flops_per_row(config),
            "optim_s": red["device_s_by_span"].get("optim", 0.0),
            "batch_wait_ms": [1e3 * w for w in waits],
            "peak_bytes": peak,
            **{k: red[k] for k in ("busy_s", "window_s", "device_ops", "breakdown")},
        }
    del state, step_fn, batches
    _free(device)
    out["numbers"] = judge(ctx, config, traffic, seed, device)
    return out


def program_unit(config: dict, traffic: dict, *, seed: int, device,
                 fault: str | None = None) -> dict:
    """The program's judged steps at the cell's size, judged (the readings
    the limits are set from), with one of ``FAULTS`` planted if asked."""
    if fault not in (None, *FAULTS):
        raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
    ctx = setup(config, traffic, seed, device, fault=fault)
    del ctx["state"], ctx["step_fn"], ctx["batches"]
    _free(device)
    return judge(ctx, config, traffic, seed, device)


def control(config: dict, traffic: dict, *, seed: int, device) -> dict:
    """The control: the reference in fp8 in the program's place for the
    training, routing by itself (judged by the float32 reference along its
    choices), and the TF32 selection for the document subsets."""
    t = traffic
    corpus = data.TokenCorpus(t["n_docs"], t["seq_len"], config["vocab_size"], seed)
    feats = corpus.features()
    labels = np.zeros((len(feats),), np.int64)
    run_ = ref_sel.plain_preprocess(feats, labels, _spec(t), seed, device)
    sel = ref_sel.judge(feats, labels, run_, _spec(t), seed, device)
    batches = reference_batches(run_["artifact"]["sge_subsets"], corpus, t, seed,
                                t["judged_steps"])
    k = run_["artifact"]["sge_subsets"].shape[1]
    kw = dict(lr=t["lr"], total_steps=max(1, (k // t["batch_size"]) * t["epochs"]),
              device=device, clip=t["clip"])
    low = ref.train(config, seed, batches, mm=ref_lm.fp8_mm, **kw)
    _free(device)
    full = ref.train(config, seed, batches, replay=low["routes"], **kw)
    numbers = ref_lm.judge(low, full)
    numbers["route_err"] = full["route_err"]
    numbers.update({"sel_" + k: v for k, v in sel.items()})
    return numbers
