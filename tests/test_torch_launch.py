"""The port's LM dataset, the pipeline's prefetch thread and the training
CLI (``python -m repro_torch.launch.train``) against the reference's."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.data.datasets import TokenLMDataset as JTokenLMDataset
from repro_torch.data.datasets import TokenLMDataset
from repro_torch.data.pipeline import Pipeline
from repro_torch.selection import build_selector

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed,vocab", [(0, 256), (3, 92544)])
def test_token_dataset_matches_reference(seed, vocab):
    a = TokenLMDataset(n_docs=48, seq_len=32, vocab=vocab, seed=seed)
    b = JTokenLMDataset(n_docs=48, seq_len=32, vocab=vocab, seed=seed)
    assert np.array_equal(a.tokens, b.tokens) and a.tokens.dtype == b.tokens.dtype
    assert np.array_equal(a.features(), b.features())
    idx = np.array([3, 0, 7])
    for k in ("tokens", "labels"):
        assert np.array_equal(a.batch(idx)[k], b.batch(idx)[k])


def _pipe(prefetch: bool, make_batch=None, n=64, k=40, batch=8):
    sel = build_selector("random", n=n, k=k, seed=1)
    feats = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    mb = make_batch or (lambda i: {"x": feats[i]})
    return Pipeline(mb, sel, batch, seed=2, prefetch=prefetch, drop_remainder=False,
                    device="cpu")


@pytest.mark.parametrize("start", [0, 2])
def test_prefetch_yields_the_same_batches(start):
    on, off = _pipe(True), _pipe(False)
    assert on.prefetch and not off.prefetch
    a, b = list(on.epoch(1, start_step=start)), list(off.epoch(1, start_step=start))
    assert len(a) == len(b) == 5 - start
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)


def test_prefetch_worker_exception_crosses_the_queue():
    calls = []

    def bad(idx):
        calls.append(len(idx))
        if len(calls) == 3:
            raise ValueError("corrupt shard")
        return {"x": idx}

    it = _pipe(True, make_batch=bad).epoch(0)
    got = [next(it), next(it)]
    with pytest.raises(ValueError, match="corrupt shard"):
        next(it)
    assert len(got) == 2


def test_abandoned_prefetch_worker_exits():
    before = {t.ident for t in threading.enumerate()}
    it = _pipe(True, n=512, k=400, batch=4).epoch(0)
    next(it)
    workers = [t for t in threading.enumerate()
               if t.name == "pipeline-prefetch" and t.ident not in before]
    assert len(workers) == 1 and workers[0].daemon
    it.close()          # the consumer goes away with the queue full
    workers[0].join(timeout=2.0)
    assert not workers[0].is_alive()


def test_fused_path_never_starts_the_thread():
    sel = build_selector("random", n=32, k=16, seed=1)
    pipe = Pipeline(None, sel, 4, arrays={"x": np.zeros((32, 2), np.float32)}, device="cpu")
    before = threading.active_count()
    pipe.device_epoch(0)
    assert threading.active_count() == before


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    return env


ARGS = ["--smoke", "--epochs", "2", "--n-docs", "64", "--batch-size", "8"]


def test_cli_prints_the_reference_summary(tmp_path):
    """``--smoke --device cpu``: the reference's summary keys and step
    count; a second run with the same ``--ckpt`` resumes at the end."""
    def run(module, extra):
        out = subprocess.run([sys.executable, "-m", module, *ARGS, *extra], capture_output=True,
                             text=True, env=_env(), cwd=ROOT, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        return json.loads(out.stdout[out.stdout.index("{"):])

    ckpt = str(tmp_path / "ckpt")
    port = run("repro_torch.launch.train", ["--device", "cpu", "--ckpt", ckpt])
    ref = run("repro.launch.train", [])
    assert sorted(port) == sorted(ref)
    assert port["steps"] == ref["steps"] == 4 and port["subset_k"] == ref["subset_k"] == 16
    assert port["arch"] == ref["arch"] == "internlm2-1.8b"
    again = run("repro_torch.launch.train", ["--device", "cpu", "--ckpt", ckpt])
    assert again["steps"] == 4 and sorted(os.listdir(ckpt)) == ["step_4"]


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch import train as launch

    with pytest.raises(RuntimeError, match="cuda"):
        launch.main(ARGS)


def test_launcher_hands_its_state_to_the_trainer():
    """``launch.train`` (the path ``main`` runs) keeps no reference to the
    initial state while it trains — the run it returns holds none — and
    runs the step through ``wrap_step``."""
    import gc
    import weakref

    from repro_torch.launch import train as launch

    calls = []
    first = {}

    def wrap(step):
        def hooked(state, batch):
            if not calls:
                first["params"] = weakref.ref(state.params["embed"])
            calls.append(1)
            return step(state, batch)
        return hooked

    args = launch.parse_args([*ARGS, "--device", "cpu"])
    run, state = launch.train(args, wrap_step=wrap)
    gc.collect()
    assert "state" not in run and run["fit_s"] > 0
    assert len(calls) == int(state.step) == 4
    assert first["params"]() is None, "the initial parameters outlived the run"


@pytest.mark.parametrize("device,conf,expected", [
    ("cuda", "", ["expandable_segments:True"]),
    ("cuda", "max_split_size_mb:512", ["expandable_segments:True"]),
    ("cuda", "expandable_segments:False", []),
    ("cpu", "", []),
])
def test_training_on_the_card_grows_allocator_segments(monkeypatch, device, conf, expected):
    """``grow_segments`` (which the launcher calls on its device) sets the
    CUDA allocator's ``expandable_segments`` for a card, unless the
    process's ``PYTORCH_CUDA_ALLOC_CONF`` names the setting itself, and
    leaves the CPU alone."""
    from repro_torch.device import grow_segments

    calls = []
    monkeypatch.setattr(torch.cuda.memory, "_set_allocator_settings", calls.append)
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", conf)
    grow_segments(torch.device(device))
    assert calls == expected
