"""A run with the timed path broken underneath judges itself not correct:
one case for each fault the cell can have (a state left unchanged, half of
the batch left out, an answer altered where it is produced).  The runs go
through ``run_cell``, the whole run without the look for a card."""
from __future__ import annotations

import dataclasses

import pytest

from conftest import run_tiny

DENSE = "select.cifar10_vitb16.dense"
LAZY = "select.cifar10_vitb16.gramfree_lazy"
LM = "lm_train.internlm2_1_8b.seq4096"


def test_sound_runs_are_correct(run_module, manifest):
    for cell in (DENSE, LAZY, LM):
        out = run_tiny(run_module, manifest, cell)
        assert out["correct"], (cell, out["checks"])


def _frozen(fn):
    """The set function with an update that returns its state unchanged."""
    return dataclasses.replace(fn, update=lambda state, K, j: state)


def test_select_state_unchanged(run_module, manifest, monkeypatch):
    from repro_torch.core import submodular

    monkeypatch.setitem(submodular.REGISTRY, "disparity_min",
                        _frozen(submodular.REGISTRY["disparity_min"]))
    assert not run_tiny(run_module, manifest, DENSE)["correct"]


def test_lazy_state_unchanged(run_module, manifest, monkeypatch):
    from repro_torch.core import gram_free

    make = gram_free.make_gram_free_facility_location
    monkeypatch.setattr(gram_free, "make_gram_free_facility_location",
                        lambda **kw: _frozen(make(**kw)))
    assert not run_tiny(run_module, manifest, LAZY)["correct"]


@pytest.mark.parametrize("cell", [DENSE, LAZY])
def test_select_answer_altered(run_module, manifest, monkeypatch, cell):
    """Two rows' importances swapped where the WRE pass produces them."""
    from repro_torch.core import milo

    inner = milo.greedy_importance

    def altered(*a, **kw):
        g = inner(*a, **kw).clone()
        hi, lo = int(g.argmax()), int(g.argmin())
        g[hi], g[lo] = g[lo].clone(), g[hi].clone()
        return g

    monkeypatch.setattr(milo, "greedy_importance", altered)
    assert not run_tiny(run_module, manifest, cell)["correct"]


def test_select_pick_altered(run_module, manifest, monkeypatch):
    """One SGE pick changed where the bank produces it."""
    from repro_torch.core import greedy

    inner = greedy._stochastic_bank

    def altered(*a, **kw):
        res = inner(*a, **kw)
        idx = res.indices.clone()
        idx[0, 1] = idx[0, 0]
        return greedy.GreedyResult(idx, res.gains)

    monkeypatch.setattr(greedy, "_stochastic_bank", altered)
    assert not run_tiny(run_module, manifest, DENSE)["correct"]


def _broken_step(kind):
    from repro_torch.train import train_state

    make = train_state.make_train_step

    def factory(*a, **kw):
        step = make(*a, **kw)

        def broken(state, batch):
            if kind == "half_batch":
                batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
                return step(state, batch)
            _, metrics = step(state, batch)
            return state, metrics

        return broken

    return factory


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch"])
def test_lm_faults(run_module, manifest, monkeypatch, kind):
    from repro_torch.train import train_state

    monkeypatch.setattr(train_state, "make_train_step", _broken_step(kind))
    assert not run_tiny(run_module, manifest, LM)["correct"]


def test_lm_token_altered(run_module, manifest, monkeypatch):
    """A token of the batch altered where the pipeline produces it."""
    from repro_torch.data import pipeline

    inner = pipeline.Pipeline.epoch

    def altered(self, *a, **kw):
        for b in inner(self, *a, **kw):
            b = dict(b, tokens=b["tokens"].copy())
            b["tokens"][0, 0] = (b["tokens"][0, 0] + 1) % 256
            yield b

    monkeypatch.setattr(pipeline.Pipeline, "epoch", altered)
    assert not run_tiny(run_module, manifest, LM)["correct"]
