"""Hyper-parameter tuning: Random / TPE search + Hyperband scheduling, with
MILO (or baseline) subsets powering the configuration evaluations — the
AUTOMATA-style pipeline of paper §4 / Fig. 8.

Port of ``repro.tuning.tuner``.  The module is numpy only, so it is copied,
not imported: the same draws, the same trial streams and the same format-1
JSON rung checkpoint, so a checkpoint written by either package resumes in
the other.

Components (paper's three):
  a) search algorithms  — RandomSearch, TPESearch (kernel-density TPE),
  b) config evaluation  — ``objective(config, budget_epochs)``; use
     ``subset_objective`` to wire a ``repro_torch.selection`` registry selector
     into every evaluation,
  c) scheduler          — Hyperband successive halving.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Callable

import numpy as np

Space = dict[str, Any]  # name -> ("uniform", lo, hi) | ("log", lo, hi) | ("choice", [..])


def sample_config(space: Space, rng: np.random.Generator) -> dict:
    cfg = {}
    for name, spec in space.items():
        kind = spec[0]
        if kind == "uniform":
            cfg[name] = float(rng.uniform(spec[1], spec[2]))
        elif kind == "log":
            cfg[name] = float(np.exp(rng.uniform(np.log(spec[1]), np.log(spec[2]))))
        elif kind == "choice":
            cfg[name] = spec[1][int(rng.integers(len(spec[1])))]
        else:
            raise ValueError(kind)
    return cfg


class _RngStateMixin:
    """Serializable draw state for search algorithms.

    The searches are deterministic functions of (seed, suggestion history),
    so snapshotting the generator's bit state at a rung boundary and
    restoring it on resume replays the exact same future suggestions — the
    property hyperband's checkpointing relies on for identical trial
    streams across a kill/restart.
    """

    def get_state(self) -> dict:
        return {"rng": self._rng.bit_generator.state}

    def set_state(self, state: dict) -> None:
        self._rng.bit_generator.state = state["rng"]


@dataclasses.dataclass
class RandomSearch(_RngStateMixin):
    space: Space
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def suggest(self, history: list[tuple[dict, float]]) -> dict:
        return sample_config(self.space, self._rng)


@dataclasses.dataclass
class TPESearch(_RngStateMixin):
    """Tree-structured Parzen Estimator (continuous dims via KDE, choices via
    re-weighted categorical)."""

    space: Space
    seed: int = 0
    gamma: float = 0.25
    n_candidates: int = 24
    min_history: int = 8

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def suggest(self, history: list[tuple[dict, float]]) -> dict:
        if len(history) < self.min_history:
            return sample_config(self.space, self._rng)
        scores = np.asarray([s for _, s in history])
        cut = np.quantile(scores, 1 - self.gamma)     # maximize score
        good = [c for c, s in history if s >= cut]
        bad = [c for c, s in history if s < cut]
        cands = [sample_config(self.space, self._rng) for _ in range(self.n_candidates)]

        def logpdf(cfg: dict, group: list[dict]) -> float:
            if not group:
                return 0.0
            lp = 0.0
            for name, spec in self.space.items():
                kind = spec[0]
                v = cfg[name]
                if kind == "choice":
                    counts = sum(1 for g in group if g[name] == v) + 1.0
                    lp += math.log(counts / (len(group) + len(spec[1])))
                else:
                    xs = np.asarray([g[name] for g in group], float)
                    if kind == "log":
                        xs, vv = np.log(xs), math.log(v)
                        bw = max((math.log(spec[2]) - math.log(spec[1])) / 8, 1e-3)
                    else:
                        vv = v
                        bw = max((spec[2] - spec[1]) / 8, 1e-6)
                    lp += math.log(
                        np.mean(np.exp(-0.5 * ((vv - xs) / bw) ** 2)) / bw + 1e-12
                    )
            return lp

        ratios = [logpdf(c, good) - logpdf(c, bad) for c in cands]
        return cands[int(np.argmax(ratios))]


@dataclasses.dataclass
class HyperbandResult:
    best_config: dict
    best_score: float
    trials: list[dict]
    total_epochs: int
    wall_time: float
    # True when a ``should_stop`` hook ended the run early (server-driven
    # cancellation / deadline): best_config/trials cover the rungs that
    # actually ran.  A completed run always records False.
    stopped: bool = False
    # Evaluations quarantined by the trial guard: the objective raised or
    # returned a non-finite score, the trial was recorded failed-with--inf
    # and the sweep continued (see hyperband docstring).
    failed_trials: int = 0


def subset_objective(
    train_fn: Callable[[dict, int, Any], float],
    selector_factory: Callable[[int], Any],
) -> Callable[[dict, int], float]:
    """Adapt a (config, budget, selector) -> score trainer to hyperband's
    two-argument objective protocol, building a fresh subset selector (e.g.
    from ``repro_torch.selection.build_selector``) for each evaluation so trials
    never share per-epoch draw state."""

    def objective(cfg: dict, budget: int) -> float:
        return train_fn(cfg, budget, selector_factory(budget))

    return objective


def stack_configs(configs: list[dict]) -> dict[str, np.ndarray]:
    """Stack per-config hyperparameter values into one array per name.

    The adapter between hyperband's list-of-dicts rung and a batched
    objective: ``stack_configs([{"lr": a}, {"lr": b}])["lr"]`` is the
    ``(2,)`` array a batched trial function maps over.  All configs
    must share the same keys (hyperband rungs always do — one search space).
    """
    if not configs:
        raise ValueError("no configs to stack")
    keys = set(configs[0])
    for c in configs[1:]:
        if set(c) != keys:
            raise ValueError(
                f"configs disagree on keys: {sorted(keys)} vs {sorted(c)}"
            )
    return {k: np.asarray([c[k] for c in configs]) for k in sorted(keys)}


def shape_bucketed_objective(
    batched_fn: Callable[[list[dict], int], Any],
    shape_keys: tuple[str, ...] = ("hidden",),
) -> Callable[[list[dict], int], list[float]]:
    """Make a ``batched_objective`` safe for shape-changing hyperparameters.

    A batched trial function can only batch configs whose tensor shapes
    agree — a rung mixing ``hidden=8`` and ``hidden=16`` networks cannot be
    stacked into one batch.  This wrapper groups the rung's configs by
    the values of ``shape_keys`` (first-appearance order, so the inner
    function sees deterministic bucket order), calls ``batched_fn`` once
    per bucket, and scatters the scores back into the original config
    order.  The trial stream and ``best_config`` are identical to feeding
    the rung through ``batched_fn`` directly when all shapes agree: one
    bucket → one pass-through call.
    """

    def objective(configs: list[dict], budget: int) -> list[float]:
        buckets: dict[tuple, list[int]] = {}
        for i, cfg in enumerate(configs):
            sig = tuple((key, cfg[key]) for key in shape_keys if key in cfg)
            buckets.setdefault(sig, []).append(i)
        scores: list[float | None] = [None] * len(configs)
        for sig, idxs in buckets.items():
            vals = [float(v) for v in
                    batched_fn([configs[i] for i in idxs], budget)]
            if len(vals) != len(idxs):
                raise ValueError(
                    f"batched_fn returned {len(vals)} scores for "
                    f"{len(idxs)} configs (shape bucket {sig})")
            for i, v in zip(idxs, vals):
                scores[i] = v
        return [float(s) for s in scores]

    return objective


#: hyperband checkpoint file format version
HB_CHECKPOINT_FORMAT = 1


def _hb_identity(search, max_budget: int, eta: int) -> dict:
    """What a resumable sweep must agree on: the schedule geometry and the
    search algorithm + space (canonical JSON — tuples/lists unified)."""
    return {
        "max_budget": int(max_budget),
        "eta": int(eta),
        "search": type(search).__name__,
        "space": json.dumps(getattr(search, "space", None), sort_keys=True,
                            default=str),
    }


def _hb_write_checkpoint(path: str, state: dict) -> None:
    """Atomic write-then-rename, fsync'd — a kill mid-write leaves the
    previous rung's state intact, never a torn file."""
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


#: Keys every complete rung checkpoint carries (see ``write_state``): a
#: file missing any of them is torn/partial even when it parses as JSON.
_HB_REQUIRED_KEYS = (
    "bracket", "rung", "configs", "bracket_n", "trials", "history",
    "best_config", "best_score", "total_epochs", "search_state", "wall_time",
)


def _hb_load_checkpoint(path: str, identity: dict) -> dict | None:
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            state = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError(
            f"{path}: corrupt hyperband checkpoint ({e}); delete it to "
            "restart the sweep from scratch"
        )
    if not isinstance(state, dict):
        raise ValueError(
            f"{path}: corrupt hyperband checkpoint (top-level JSON is "
            f"{type(state).__name__}, expected object); delete it to "
            "restart the sweep from scratch"
        )
    if state.get("format") != HB_CHECKPOINT_FORMAT:
        raise ValueError(
            f"{path}: hyperband checkpoint format "
            f"{state.get('format')} != {HB_CHECKPOINT_FORMAT}"
        )
    if state.get("identity") != identity:
        raise ValueError(
            f"{path}: checkpoint belongs to a different sweep "
            f"(stored {state.get('identity')}, this run {identity}); "
            "point `checkpoint` elsewhere or delete the file"
        )
    # a truncated file whose prefix still parses (or a write interrupted
    # between schema versions) must surface as the same clean identity
    # error, not as a KeyError deep inside the resume bookkeeping
    missing = [k for k in _HB_REQUIRED_KEYS if k not in state]
    if missing:
        raise ValueError(
            f"{path}: corrupt hyperband checkpoint (missing keys "
            f"{missing}); delete it to restart the sweep from scratch"
        )
    return state


def hyperband(
    objective: Callable[[dict, int], float] | None,
    search,
    *,
    max_budget: int = 27,
    eta: int = 3,
    seed: int = 0,
    batched_objective: Callable[[list[dict], int], Any] | None = None,
    should_stop: Callable[[], bool] | None = None,
    checkpoint: str | None = None,
) -> HyperbandResult:
    """Hyperband [Li'17]: brackets of successive halving.

    ``objective(config, budget_epochs) -> score`` (higher better); evaluations
    with larger budget may warm-start (caller's choice).

    ``batched_objective(configs, budget_epochs) -> scores`` evaluates ALL
    surviving configs of a rung in one call — the opt-in that lets a batched
    trial function (stack the hyperparameter leaves with ``stack_configs``,
    batch the training over them) collapse a rung's Python trial
    serialization into one dispatch.  Bookkeeping (history order, trials,
    best tracking, halving) is identical to the sequential path, so two runs
    whose objectives return the same scores produce the identical
    ``best_config`` and trial set.  When provided, ``objective`` may be None.

    **Trial quarantine:** a sequential ``objective`` that raises, or an
    evaluation (either path) that returns a non-finite score, marks that
    trial failed-with--inf — recorded on the trial dict as
    ``failed``/``error`` — and the sweep continues; one poisoned config can
    no longer kill a whole sweep.  Failed evaluations lose every halving
    comparison, so they never advance a rung, and ``best_config`` over the
    surviving trials is identical to a sweep where the failing configs
    scored arbitrarily badly.  Only when EVERY evaluation failed does the
    sweep raise (``RuntimeError`` carrying the first error) — an
    all-failing objective is a harness bug, not bad luck.  Exceptions from
    ``batched_objective`` still propagate: one call covers the whole rung,
    so there is no per-trial failure to isolate.

    ``should_stop()`` is polled before every rung evaluation — the
    server-driven hook (a selection server's) that lets a tuning
    request honor a deadline or cancellation between rungs.  A True poll
    ends the run immediately; the result carries ``stopped=True`` and the
    best config among the rungs that completed (None if none did).

    ``checkpoint`` names a JSON state file making the sweep crash-safe at
    rung granularity: after every completed rung the full scheduler state
    (bracket, rung, surviving configs, trials, best, total epochs, search
    RNG bit state) is written atomically.  A killed sweep relaunched with
    the same arguments resumes at the rung it died in and produces the
    IDENTICAL trial stream and ``best_config`` as an uninterrupted run —
    the search RNG is restored bit-exactly, so every future suggestion
    matches.  A checkpoint from a different sweep (schedule, search class,
    or space disagree) raises instead of silently mixing runs; a finished
    sweep short-circuits and returns its recorded result.
    """
    if objective is None and batched_objective is None:
        raise ValueError("provide objective or batched_objective")
    t0 = time.time()
    s_max = int(math.log(max_budget, eta))
    trials: list[dict] = []
    history: list[tuple[dict, float]] = []
    best_config, best_score = None, -np.inf
    total_epochs = 0
    stopped = False
    failed = 0
    first_error: str | None = None

    identity = _hb_identity(search, max_budget, eta)
    resume = _hb_load_checkpoint(checkpoint, identity) if checkpoint else None
    if resume is not None:
        try:
            trials = resume["trials"]
            history = [(c, float(v)) for c, v in resume["history"]]
            best_config = resume["best_config"]
            best_score = float(resume["best_score"])
            total_epochs = int(resume["total_epochs"])
            search.set_state(resume["search_state"])
        except (KeyError, TypeError, ValueError) as e:
            # belt-and-braces behind _hb_load_checkpoint's key check:
            # malformed VALUES surface as the same clean identity error
            raise ValueError(
                f"{checkpoint}: corrupt hyperband checkpoint ({e!r}); "
                "delete it to restart the sweep from scratch") from e
        failed = sum(1 for t in trials if t.get("failed"))
        if resume.get("done"):
            return HyperbandResult(best_config, best_score, trials,
                                   total_epochs, float(resume["wall_time"]),
                                   stopped=False, failed_trials=failed)

    def write_state(bracket: int, rung: int, configs, n: int | None,
                    done: bool) -> None:
        if checkpoint is None:
            return
        _hb_write_checkpoint(checkpoint, {
            "format": HB_CHECKPOINT_FORMAT,
            "identity": identity,
            "bracket": bracket,
            "rung": rung,
            "configs": configs,
            "bracket_n": n,
            "trials": trials,
            "history": [[c, v] for c, v in history],
            "best_config": best_config,
            "best_score": (float(best_score) if best_config is not None
                           else -1e308),
            "total_epochs": total_epochs,
            "search_state": search.get_state(),
            "wall_time": time.time() - t0,
            "done": done,
        })

    for s in range(s_max, -1, -1):
        if stopped:
            break
        if resume is not None and s > resume["bracket"]:
            continue  # bracket completed before the crash; results restored
        if resume is not None and s == resume["bracket"] and resume["configs"] is not None:
            # resume mid-bracket: survivors + rung index from the checkpoint,
            # suggestions already drawn (the restored RNG state follows them)
            n = int(resume["bracket_n"])
            configs = resume["configs"]
            first_rung = int(resume["rung"])
        else:
            n = int(math.ceil((s_max + 1) / (s + 1) * eta ** s))
            configs = [search.suggest(history) for _ in range(n)]
            first_rung = 0
        resume = None
        r = max_budget * eta ** (-s)
        for i in range(first_rung, s + 1):
            if should_stop is not None and should_stop():
                stopped = True
                break
            n_i = int(n * eta ** (-i))
            r_i = max(1, int(round(r * eta ** i)))
            # (score, error): error is None for a healthy evaluation; a
            # raised/non-finite evaluation is quarantined at -inf so it
            # loses every halving comparison but cannot kill the sweep
            outcomes: list[tuple[float, str | None]] = []
            if batched_objective is not None:
                scores = [float(v) for v in batched_objective(list(configs), r_i)]
                if len(scores) != len(configs):
                    raise ValueError(
                        f"batched_objective returned {len(scores)} scores "
                        f"for {len(configs)} configs"
                    )
                outcomes = [
                    (v, None) if math.isfinite(v)
                    else (-np.inf, f"non-finite score {v!r}")
                    for v in scores
                ]
            else:
                for cfg in configs:
                    try:
                        v = float(objective(cfg, r_i))
                    except Exception as e:  # noqa: BLE001 — trial isolation
                        outcomes.append((-np.inf, repr(e)))
                    else:
                        outcomes.append(
                            (v, None) if math.isfinite(v)
                            else (-np.inf, f"non-finite score {v!r}"))
            results = [v for v, _ in outcomes]
            for cfg, (score, err) in zip(configs, outcomes):
                total_epochs += r_i
                history.append((cfg, score))
                trial = {"config": cfg, "budget": r_i, "score": score,
                         "bracket": s}
                if err is not None:
                    trial["failed"] = True
                    trial["error"] = err
                    failed += 1
                    if first_error is None:
                        first_error = err
                trials.append(trial)
                if score > best_score:
                    best_config, best_score = cfg, score
            order = np.argsort(results)[::-1]
            keep = max(1, int(n_i / eta))
            configs = [configs[j] for j in order[:keep]]
            # rung boundary: persist the full scheduler state (crash-safe
            # resume point).  The final rung of bracket 0 marks the sweep
            # done; the final rung of any other bracket arms the next one.
            if i == s:
                write_state(s - 1, 0, None, None, done=(s == 0))
            else:
                write_state(s, i + 1, configs, n, done=False)
            if len(configs) <= 1 and i < s:
                # nothing left to halve; finish bracket with the survivor
                continue
    if trials and failed == len(trials):
        raise RuntimeError(
            f"hyperband: all {len(trials)} trial evaluations failed "
            f"(first error: {first_error}) — quarantine keeps a sweep "
            "alive through bad configs, not through a broken objective")
    return HyperbandResult(best_config, float(best_score), trials, total_epochs,
                           time.time() - t0, stopped=stopped,
                           failed_trials=failed)


def kendall_tau(a: np.ndarray, b: np.ndarray) -> float:
    """Kendall rank correlation between two score vectors (paper Tab. 9).

    Vectorized sign-outer-product form: over the strict upper triangle of
    pairwise score differences, a pair is concordant when the signs agree
    (product +1), discordant when they disagree (-1), and dropped from both
    numerator and denominator when either vector ties on it — the exact
    semantics of the former O(n²) Python pair loop it replaces.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    iu = np.triu_indices(len(a), k=1)
    sa = np.sign(a[:, None] - a[None, :])[iu]
    sb = np.sign(b[:, None] - b[None, :])[iu]
    prod = sa * sb                       # +1 concordant, -1 discordant, 0 tie
    den = int(np.count_nonzero(prod))
    return float(prod.sum() / den) if den else 0.0
