"""Driver of the ``lm_train`` traffic: LM training on MILO-selected
documents, assembled from the program's pieces as its launcher
(``repro_torch.launch.train.build``) assembles them.

Set-up makes the token corpus from the seed, runs MILO's preprocess over the
documents' features (``MiloPreprocessor``), builds the ``milo`` selector,
the ``Pipeline`` and the train step (AdamW, cosine learning rate, global
clip), draws the weights on the card from the seed, and drives the step
through its first ``judged_steps`` steps on the pipeline's batches: the
warm-up, and the steps the reference follows.  The window then goes on with
the same state and the same batch stream, one closed-loop step a unit,
until ``seconds`` have passed and the last step has finished on the card.
After the window the program's state is freed and the reference trains the
same first steps (``bench/reference/lm.py``).

With ``trace``: each step's wait for its batch on the host, a span around
the optimizer's update, and the profiler over ``profile_steps`` steps after
the window's first ``profile_after``.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from bench import data, trace as tr
from bench.counts import model as model_counts
from bench.reference import lm as ref_lm, selection as ref_sel

_PATH = {"norm1": ("norm1",), "wq": ("mixer", "wq"), "wk": ("mixer", "wk"),
         "wv": ("mixer", "wv"), "wo": ("mixer", "wo"), "norm2": ("norm2",),
         "w_gate": ("ffn", "w_gate"), "w_up": ("ffn", "w_up"), "w_down": ("ffn", "w_down")}


def model_config(config: dict):
    """The program's ``ModelConfig`` for the configuration file's model, as
    the file states it."""
    from repro_torch.configs.base import ModelConfig

    m = config["model"]
    run = config["run"]
    return ModelConfig(
        name=config["name"], family="dense", num_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], num_heads=m["num_attention_heads"],
        num_kv_heads=m["num_key_value_heads"], d_ff=m["intermediate_size"],
        vocab_size=m["vocab_size"], rope_theta=float(m["rope_theta"]),
        norm_eps=float(m["rms_norm_eps"]), tie_embeddings=bool(m["tie_word_embeddings"]),
        dtype=m["torch_dtype"], attention_impl=run["attention_impl"],
        attn_block=run["attn_block"], remat=run["remat"])


def param_tree(weights: dict, n_layers: int) -> dict:
    """The program's weight tree (one group pattern of one block, its
    leaves stacked over the layers) holding the benchmark's tensors."""
    from repro_torch.tree import Stacked

    block: dict = {}
    for part, path in _PATH.items():
        node = block
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = Stacked([weights[f"layers.{i}.{part}"] for i in range(n_layers)])
    return {"embed": weights["embed"], "groups": {"b0": block},
            "final_norm": weights["final_norm"]}


def leaf(tree: dict, name: str) -> torch.Tensor:
    """The program tree's tensor of a weight named as ``data.lm_leaf_specs``."""
    if name in ("embed", "final_norm"):
        return tree[name]
    _, i, part = name.split(".")
    node = tree["groups"]["b0"]
    for key in _PATH[part]:
        node = node[key]
    return node[int(i)]


def _norms(tree: dict, names: list[str], scale: float = 1.0) -> torch.Tensor:
    return torch.stack([torch.linalg.vector_norm(leaf(tree, n).double()) * scale
                        for n in names])


def setup(config: dict, traffic: dict, seed: int, device, *, trace: bool = False,
          fault: str | None = None) -> dict:
    """Everything up to the window: the program's objects, its readings of
    the judged steps, and what the reference needs."""
    from repro_torch.core.milo import MiloPreprocessor
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.optim.optimizers import Optimizer, adamw
    from repro_torch.optim.schedules import cosine
    from repro_torch.selection import build_selector
    from repro_torch.train.train_state import TrainState, make_train_step

    from bench.drivers.select import Recorder

    model = config["model"]
    t = traffic
    cfg = model_config(config)
    corpus = data.TokenCorpus(t["n_docs"], t["seq_len"], model["vocab_size"], seed)
    feats = corpus.features()
    rec = Recorder()
    rec.install()
    rec.begin_unit()
    try:
        pre = MiloPreprocessor(device=device, **t["preprocess"])
        md = pre.preprocess(feats, None, seed=seed)
    finally:
        rec.end_unit()
        rec.remove()
    selector = build_selector("milo", metadata=md, total_epochs=t["epochs"], seed=seed,
                              device=device)
    pipeline = Pipeline(corpus.batch, selector, t["batch_size"], seed=seed, device=device)
    opt = adamw()
    if trace:
        # the optimizer object handed to the step, its update under a span
        upd = opt.update

        def update(*a, **kw):
            with torch.profiler.record_function(tr.SPAN_PREFIX + "optim"):
                return upd(*a, **kw)

        opt = Optimizer(opt.init, update)
    total_steps = max(1, pipeline.steps_per_epoch() * t["epochs"])
    step_fn = make_train_step(cfg, opt, cosine(t["lr"], total_steps), grad_clip=t["clip"])
    weights = data.lm_weights(model, seed, device)
    params = param_tree(weights, model["num_hidden_layers"])
    del weights
    state = TrainState(params, opt.init(params), torch.zeros((), dtype=torch.int32, device=device))
    del params
    names = [s[0] for s in data.lm_leaf_specs(model)]

    def feed(batch: dict) -> dict:
        b = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        if fault == "half_batch":   # half of the batch left out, the mean over the rest
            b = {k: v[: max(1, v.shape[0] // 2)] for k, v in b.items()}
        return b

    batches = _batch_stream(pipeline)
    seen, losses = [], []
    grad1 = None
    for step in range(t["judged_steps"]):
        batch = next(batches)
        seen.append({k: np.array(v) for k, v in batch.items()})
        new_state, metrics = step_fn(state, feed(batch))
        if fault != "state_unchanged":
            state = new_state
        del new_state
        losses.append(metrics["loss"])
        if step == 0:
            # the first gradient as the optimizer took it: m1 = (1 - b1)·g
            grad1 = _norms(state.opt_state["m"], names, 1.0 / (1.0 - 0.9))
    w0 = data.lm_weights(model, seed, device)
    change = torch.stack([torch.linalg.vector_norm((leaf(state.params, n).double()
                                                    - w0[n].double())) for n in names])
    del w0
    prog = {"losses": [float(x) for x in losses],
            "grad1": dict(zip(names, grad1.tolist())),
            "change": dict(zip(names, change.tolist()))}
    tr.fence(device)
    return {"state": state, "step_fn": step_fn, "feed": feed, "batches": batches,
            "prog": prog, "seen": seen, "metadata": md, "feats": feats,
            "record": rec.host_record(0), "corpus": corpus, "total_steps": total_steps,
            "tokens_per_step": t["batch_size"] * t["seq_len"]}


def _batch_stream(pipeline):
    epoch = 0
    while True:
        yield from pipeline.epoch(epoch)
        epoch += 1


def reference_batches(md_sge: np.ndarray, corpus, traffic: dict, seed: int, n: int) -> list[dict]:
    """The batches of the first ``n`` steps as the reference works them
    out: epoch 0 trains on the SGE bank's first subset (the curriculum's
    easy phase), visited in the numpy permutation seeded ``seed·1,000,003``,
    ``batch_size`` documents a step, unit weights."""
    docs = np.asarray(md_sge[0])
    docs = docs[np.random.default_rng(seed * 1_000_003).permutation(len(docs))]
    bs = traffic["batch_size"]
    out = []
    for i in range(n):
        b = corpus.batch(docs[i * bs:(i + 1) * bs])
        b["weights"] = np.ones((bs,), np.float32)
        out.append(b)
    return out


def judge(ctx: dict, config: dict, traffic: dict, seed: int, device, *,
          mm=ref_lm.plain_mm, program: dict | None = None) -> dict:
    """All numbers of the cell: the selection's (the document subsets MILO
    handed the pipeline), the batches' (exact), the training's."""
    md = ctx["metadata"]
    t = traffic
    labels = np.zeros((len(ctx["feats"]),), np.int64)
    spec = {"subset_fraction": t["preprocess"]["subset_fraction"],
            "n_sge_subsets": t["preprocess"]["n_sge_subsets"], "eps": 0.01,
            "graph_cut_lambda": 0.4, "easy_fn": "graph_cut", "hard_fn": "disparity_min"}
    sel = ref_sel.judge(ctx["feats"], labels,
                        {"artifact": {"sge_subsets": md.sge_subsets,
                                      "wre_importance": md.wre_importance,
                                      "wre_probs": md.wre_probs},
                         "classes": ctx["record"]}, spec, seed, device)
    batches = reference_batches(md.sge_subsets, ctx["corpus"], t, seed, t["judged_steps"])
    batch_faults = sum(int(not np.array_equal(ctx["seen"][i][k], batches[i][k]))
                       for i in range(len(batches)) for k in ("tokens", "labels", "weights"))
    ref = ref_lm.train(config["model"], seed, batches, lr=t["lr"],
                       total_steps=ctx["total_steps"], device=device, clip=t["clip"], mm=mm)
    numbers = ref_lm.judge(program if program is not None else ctx["prog"], ref)
    numbers.update({"sel_" + k: v for k, v in sel.items()})
    numbers["batch_faults"] = float(batch_faults)
    return numbers


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
        # host time between the steps' returns (the card runs behind)
        "unit_s": [b - a for a, b in zip([0.0] + marks, marks)],
    }
    if trace:
        if prof.active:
            prof.stop()
        red = tr.reduce_events(*prof.events(), window_s=prof.window_s)
        profiled = min(prof_steps, max(0, n - prof_after))
        out["trace"] = {
            "steps_profiled": profiled,
            "steps": n,
            "window_total_s": window_s,
            "profiler_held_s": prof.held_s,
            "flops_per_step": model_counts.train_flops_per_step(
                config["model"], traffic["batch_size"], traffic["seq_len"]),
            "optim_s": red["device_s_by_span"].get("optim", 0.0),
            "batch_wait_ms": [1e3 * w for w in waits],
            "peak_bytes": peak,
            **{k: red[k] for k in ("busy_s", "window_s", "device_ops", "breakdown")},
        }
    # free the program's state before the reference runs
    del state, step_fn, batches
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["numbers"] = judge(ctx, config, traffic, seed, device)
    return out


def program_steps(config: dict, traffic: dict, *, seed: int, device,
                  fault: str | None = None) -> dict:
    """The program's judged steps at the cell's size, judged (the readings
    the limits are set from), with an optional planted fault."""
    ctx = setup(config, traffic, seed, device, fault=fault)
    del ctx["state"], ctx["step_fn"], ctx["batches"]
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return judge(ctx, config, traffic, seed, device)


def control(config: dict, traffic: dict, *, seed: int, device) -> dict:
    """The control: the reference in fp8 in the program's place for the
    training (judged by the float32 reference), and the TF32 selection in
    the program's place for the document subsets."""
    t = traffic
    corpus = data.TokenCorpus(t["n_docs"], t["seq_len"], config["model"]["vocab_size"], seed)
    feats = corpus.features()
    labels = np.zeros((len(feats),), np.int64)
    spec = {"subset_fraction": t["preprocess"]["subset_fraction"],
            "n_sge_subsets": t["preprocess"]["n_sge_subsets"], "eps": 0.01,
            "graph_cut_lambda": 0.4, "easy_fn": "graph_cut", "hard_fn": "disparity_min"}
    run_ = ref_sel.plain_preprocess(feats, labels, spec, seed, device)
    sel = ref_sel.judge(feats, labels, run_, spec, seed, device)
    batches = reference_batches(run_["artifact"]["sge_subsets"], corpus, t, seed,
                                t["judged_steps"])
    k = run_["artifact"]["sge_subsets"].shape[1]
    total = max(1, (k // t["batch_size"]) * t["epochs"])
    kw = dict(lr=t["lr"], total_steps=total, device=device, clip=t["clip"])
    low = ref_lm.train(config["model"], seed, batches, mm=ref_lm.fp8_mm, **kw)
    ref = ref_lm.train(config["model"], seed, batches, **kw)
    numbers = ref_lm.judge(low, ref)
    numbers.update({"sel_" + k: v for k, v in sel.items()})
    return numbers
