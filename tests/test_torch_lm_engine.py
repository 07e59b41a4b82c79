"""Port parity: the port's ``ServeEngine`` against the reference's, on the
smoke configurations of yi-6b and Jamba with the ``pallas`` impls, the same
weights (``params_from_jax``), prompts and slot pool.

Two prompt lengths only: the reference's engine compiles its prefill anew
for each length.  The pool is smaller than the queue, so slots are freed
and taken again; one request runs into ``max_len - 1``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.models import lm as jlm
from repro.serve.lm_engine import Request as JRequest
from repro.serve.lm_engine import ServeEngine as JEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm as tlm
from repro_torch.serve import lm_engine as tengine

torch.set_num_threads(1)
MAX_LEN = 24
# (prompt length, new tokens): the last request is cut at MAX_LEN - 1
REQUESTS = [(5, 4), (9, 7), (5, 3), (9, 30)]


def _run(arch, dtype):
    jcfg = dataclasses.replace(jreg.smoke(arch), attention_impl="pallas", ssm_impl="pallas",
                               dtype=dtype)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    params = jlm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = tlm.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, p).astype(np.int32) for p, _ in REQUESTS]

    jeng = JEngine(params, jcfg, max_batch=2, max_len=MAX_LEN)
    teng = tengine.ServeEngine(model, tcfg, max_batch=2, max_len=MAX_LEN)
    logits = []  # the port's decode logits, step by step (B, V)
    decode = tlm.decode_step

    def recording(*args, **kwargs):
        out = decode(*args, **kwargs)
        logits.append(out[0][:, -1].float().numpy())
        return out

    for i, (prompt, (_, n)) in enumerate(zip(prompts, REQUESTS)):
        jeng.submit(JRequest(i, prompt, max_new_tokens=n))
        teng.submit(tengine.Request(i, prompt, max_new_tokens=n))
    jdone = {r.rid: r.generated for r in jeng.run()}
    tengine.lm.decode_step = recording
    try:
        tdone = {r.rid: r.generated for r in teng.run()}
    finally:
        tengine.lm.decode_step = decode
    return jdone, tdone, teng, logits, (params, jcfg, prompts)


def _own_bf16_gap(params, jcfg, prompts):
    """The reference's own bf16 error on these prompts: the largest gap
    between its bf16 logits and its f32 logits of the same weights."""
    p32 = jax.tree.map(lambda a: a.astype(np.float32), params)
    c32 = dataclasses.replace(jcfg, dtype="float32")
    gap = 0.0
    for prompt in prompts[:2]:  # the two prompt lengths
        lb, _ = jlm.forward(params, jcfg, prompt[None])
        l32, _ = jlm.forward(p32, c32, prompt[None])
        gap = max(gap, float(np.abs(np.asarray(lb, np.float32) - np.asarray(l32)).max()))
    return gap


@pytest.mark.parametrize("arch", ["yi-6b", "jamba-1.5-large-398b"])
def test_engine_generates_the_references_tokens_in_f32(arch):
    jdone, tdone, teng, _, _ = _run(arch, "float32")
    assert sorted(tdone) == list(range(len(REQUESTS)))
    for rid, (p, n) in enumerate(REQUESTS):
        assert len(tdone[rid]) == min(n, MAX_LEN - p), (rid, tdone[rid])
        assert tdone[rid] == jdone[rid], (rid, tdone[rid], jdone[rid])
    assert all(r is None for r in teng.slot_req) and not teng.queue


@pytest.mark.parametrize("arch", ["yi-6b", "jamba-1.5-large-398b"])
def test_engine_in_bf16_follows_the_reference_up_to_a_near_tie(arch):
    """bf16 rounds at other points in the two frameworks (the reference's own
    bf16 and f32 runs part within a few steps), so each request's tokens must
    agree up to the first parting, and there the two candidates must be a
    near-tie in the port's logits: no farther apart than the reference's own
    bf16 error (its bf16 against its f32 logits on the same prompts)."""
    jdone, tdone, _, logits, setup = _run(arch, "bfloat16")
    tol = _own_bf16_gap(*setup)
    for rid in range(len(REQUESTS)):
        ours, theirs = tdone[rid], jdone[rid]
        assert len(ours) == len(theirs)
        parted = [t for t, (a, b) in enumerate(zip(ours, theirs)) if a != b]
        if not parted:
            continue
        t = parted[0]
        assert t > 0, "the first token comes from the prefill; it must agree"
        # find the decode step and slot that produced token t of request rid
        step, slot = _locate(rid, t)
        row = logits[step][slot]
        gap = abs(float(row[ours[t]] - row[theirs[t]]))
        assert gap <= tol, (rid, t, gap, tol)


def _locate(rid, t):
    """(decode step, slot) of request ``rid``'s ``t``-th generated token
    (t >= 1) under the engine's schedule: admission in queue order into the
    lowest free slot, one token per active slot per step."""
    budgets = [min(n, MAX_LEN - p) for p, n in REQUESTS]
    queue, slots, made, step = list(range(len(REQUESTS))), [None, None], {}, 0
    while True:
        for s in range(2):
            if slots[s] is None and queue:
                slots[s] = queue.pop(0)
                made[slots[s]] = 1
        for s in range(2):
            r = slots[s]
            if r is None:
                continue
            if r == rid and made[r] == t:
                return step, s
            made[r] += 1
            if made[r] >= budgets[r]:
                slots[s] = None
        step += 1
