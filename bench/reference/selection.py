"""Plain reference of MILO's preprocess (paper Alg. 1-3), the judge that
decides a selection cell's ``correct``, and the control.

Nothing here imports the program.  The judge reads what the program
produced only to judge it:

- the artifact (``sge_subsets``, ``wre_importance``, ``wre_probs``);
- the record of each class's greedy runs as the engines returned them: the
  SGE bank's picks and their gains, and the WRE pass's order of picks.  The
  artifact keeps the WRE gains but not their order, and the order is what
  decides each gain, so the judge follows the program's own trajectory.

Along that trajectory the reference recomputes, in float64 from the
features, every step's gains: the SGE step's candidate set is replayed from
the documented Gumbel stream (one ``exponential_`` draw of (runs, n_run) per
step from a generator seeded with the preprocess seed, classes in order),
the WRE step's candidates are all unselected rows.  Per step it reads

- gap: how far the program's pick lies below the best candidate;
- value: how far the program's gain (the SGE record's, the artifact's WRE
  importance) lies from the reference's gain of that pick;

and per row the artifact's probability against the reference's (Taylor
softmax within the class, weighted by class mass).  Graph-cut and
facility-location gains are divided by the class size (they are sums over
its rows); disparity-min gains lie in [-2, 0] and are taken as they are.

``plain_preprocess`` is the same computation in float32 with the products'
operands rounded to TF32: the control put in the program's place.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from bench.reference.lowp import round_tf32

CAP = 2.0            # disparity-min's stand-in for +inf (the paper's program uses 2)
NEG = -1e30


def partition(labels: np.ndarray) -> list[np.ndarray]:
    """Row indices of each class, classes ascending, rows ascending."""
    labels = np.asarray(labels)
    return [np.nonzero(labels == c)[0] for c in np.unique(labels)]


def budgets(sizes: list[int], k: int) -> list[int]:
    """Largest-remainder split of k over the classes (at most each size)."""
    sizes_a = np.asarray(sizes, np.float64)
    m = sizes_a.sum()
    k = min(k, int(m))
    quotas = sizes_a * (k / m)
    out = np.minimum(np.floor(quotas).astype(np.int64), sizes_a.astype(np.int64))
    rem = k - int(out.sum())
    for i in np.argsort(-(quotas - np.floor(quotas))):
        if rem <= 0:
            break
        if out[i] < sizes_a[i]:
            out[i] += 1
            rem -= 1
    for i in range(len(out)):
        while rem > 0 and out[i] < sizes_a[i]:
            out[i] += 1
            rem -= 1
    return [int(b) for b in out]


def next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def candidate_count(n: int, k: int, eps: float) -> int:
    return max(1, min(n, math.ceil((n / max(k, 1)) * math.log(1.0 / eps))))


def geometry(n_c: int, k_c: int, bucket: bool) -> tuple[int, int]:
    """(n_run, k_run): the class's problem padded to powers of two when the
    preprocess buckets its classes."""
    if not bucket:
        return n_c, k_c
    n_run = next_pow2(n_c)
    return n_run, min(n_run, next_pow2(k_c))


def gram64(z: torch.Tensor) -> torch.Tensor:
    """Rescaled cosine similarity 0.5 + 0.5·cos in float64."""
    z = z.double()
    zn = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(1e-8)
    return 0.5 + 0.5 * (zn @ zn.T)


def gram_tf32(z: torch.Tensor) -> torch.Tensor:
    """The same in float32 with the product's operands rounded to TF32."""
    z = z.float()
    zn = round_tf32(z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(1e-8))
    return 0.5 + 0.5 * (zn @ zn.T)


class GumbelStream:
    """The SGE draws: ``-log(E)``, ``E ~ Exp(1)`` in float32, from one
    generator on the device seeded with the preprocess seed."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def draw(self, shape: tuple[int, ...]) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.float32, device=self.device).exponential_(
            generator=self.gen).log_().neg_()


def taylor_probs(g: torch.Tensor) -> torch.Tensor:
    w = 1.0 + g + 0.5 * g * g
    return w / w.sum()


# ---------------------------------------------------------------------------
# the judge
# ---------------------------------------------------------------------------

def _sge_steps(K: torch.Tensor, picks: torch.Tensor, gains: torch.Tensor | None,
               stream: GumbelStream, *, n_run: int, k_run: int, s: int, lam: float,
               n_subsets: int) -> tuple[float, float]:
    """Graph-cut stochastic greedy, every run of the bank at once, along the
    program's picks ``picks`` (B, k_c) (local indices).  Returns the widest
    (gap, value) over the steps, divided by the class size."""
    dev = K.device
    n_c, k_c = K.shape[0], picks.shape[1]
    colsum, diag = K.sum(0), K.diagonal()
    cur = torch.zeros((n_subsets, n_c), dtype=K.dtype, device=dev)
    selected = torch.zeros((n_subsets, n_run), dtype=torch.bool, device=dev)
    selected[:, n_c:] = True
    gaps = torch.zeros((k_c,), dtype=torch.float64, device=dev)
    vals = torch.zeros((k_c,), dtype=torch.float64, device=dev)
    rows = torch.arange(n_subsets, device=dev)
    for t in range(k_run):
        noise = stream.draw((n_subsets, n_run))
        if t >= k_c:
            continue  # the rest of the class's draws, past the kept picks
        cand = noise.masked_fill(selected, NEG).topk(s, dim=1).indices        # (B, s)
        live = (cand < n_c) & ~selected.gather(1, cand)
        cc = cand.clamp_max(n_c - 1)
        g = colsum[cc] - lam * (2.0 * cur.gather(1, cc) + diag[cc])
        best = g.masked_fill(~live, -math.inf).max(dim=1).values
        j = picks[:, t]
        g_pick = colsum[j] - lam * (2.0 * cur[rows, j] + diag[j])
        in_cand = ((cand == j[:, None]) & live).any(dim=1)
        gap = torch.where(in_cand, best - g_pick, torch.full_like(best, math.inf))
        gaps[t] = gap.max()
        if gains is not None:
            vals[t] = (gains[:, t].double() - g_pick).abs().max()
        cur += K[:, j].T
        selected[rows, j] = True
    scale = float(n_c)
    val = float(vals.max()) / scale if gains is not None else math.nan
    return float(gaps.max()) / scale, val


def _disparity_min_steps(K: torch.Tensor, order: torch.Tensor,
                         block: int = 512) -> tuple[torch.Tensor, torch.Tensor]:
    """Disparity-min greedy along ``order`` (n_c,): each step's gap and the
    reference's gain of each pick, in step order.  Vectorised over blocks of
    steps: the running minimum distance is a cumulative minimum over the
    picked rows of 1 - K."""
    n = K.shape[0]
    dev = K.device
    pos = torch.empty((n,), dtype=torch.int64, device=dev)
    pos[order] = torch.arange(n, device=dev)
    carry = torch.full((n,), CAP, dtype=K.dtype, device=dev)   # D before the block
    cur = torch.full((), CAP, dtype=K.dtype, device=dev)       # f(S) before the block
    gaps, g_picks = [], []
    for t0 in range(0, n, block):
        o = order[t0:t0 + block]
        T = o.shape[0]
        after = torch.minimum(torch.cummin(1.0 - K[o], dim=0).values, carry[None])
        before = torch.cat([carry[None], after[:-1]], dim=0)          # D at each step
        d_pick = before[torch.arange(T, device=dev), o]                # dmin of the pick
        steps = torch.arange(t0, t0 + T, device=dev)
        # f(S) grows by min with the pick's dmin from the second pick on
        d_upd = torch.where(steps >= 1, d_pick, torch.full_like(d_pick, CAP))
        run_min = torch.minimum(torch.cummin(d_upd, dim=0).values, cur)
        cur_t = torch.cat([cur[None], run_min[:-1]])                   # f(S) before step t
        G = torch.minimum(before, cur_t[:, None]) - cur_t[:, None]
        unsel = pos[None, :] >= steps[:, None]
        best = G.masked_fill(~unsel, -math.inf).max(dim=1).values
        g_pick = G[torch.arange(T, device=dev), o]
        gaps.append(best - g_pick)
        g_picks.append(g_pick)
        carry, cur = after[-1], run_min[-1]
    return torch.cat(gaps), torch.cat(g_picks)


def _facility_location_steps(K: torch.Tensor, order: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Facility-location greedy along ``order``: each step's gap and the
    reference's gain of each pick.  The gain vector is kept in float64 and
    corrected over the rows whose cover moved (recomputed whole when more
    than an eighth of the rows moved)."""
    n = K.shape[0]
    dev = K.device
    c = torch.zeros((n,), dtype=K.dtype, device=dev)
    G = K.sum(0)
    selected = torch.zeros((n,), dtype=torch.bool, device=dev)
    gaps = torch.zeros((n,), dtype=K.dtype, device=dev)
    g_picks = torch.zeros((n,), dtype=K.dtype, device=dev)
    for t in range(n):
        j = order[t]
        gaps[t] = G.masked_fill(selected, -math.inf).max() - G[j]
        g_picks[t] = G[j]
        col = K[:, j]
        touched = (col > c).nonzero()[:, 0]
        if touched.numel() > n // 8:
            c = torch.maximum(c, col)
            G = torch.clamp_min(K - c[:, None], 0.0).sum(0)
        elif touched.numel():
            rows = K[touched]
            c_old = c[touched]
            c_new = col[touched]
            G += (torch.clamp_min(rows - c_new[:, None], 0.0)
                  - torch.clamp_min(rows - c_old[:, None], 0.0)).sum(0)
            c[touched] = c_new
        selected[j] = True
    return gaps, g_picks


def judge(features: np.ndarray, labels: np.ndarray, run: dict, spec: dict, seed: int,
          device) -> dict[str, float]:
    """The numbers that decide a selection cell's ``correct`` for one
    preprocess: ``faults`` (an exact count of malformed outputs: shapes,
    indices outside their class or repeated, an order that is not a
    permutation, a missing record, probabilities that do not sum to 1) and
    the widest ``sge_gap``, ``sge_value``, ``wre_gap``, ``wre_value`` and
    ``probs_err`` (relative to the largest probability).  ``sge_err`` and
    ``wre_err`` are the wider of each stage's gap and value."""
    dev = torch.device(device)
    art = run["artifact"]
    records = run["classes"]
    m = len(labels)
    parts = partition(labels)
    k = max(1, int(round(spec["subset_fraction"] * m)))
    bud = budgets([len(p) for p in parts], k)
    bucket = len(parts) > 1
    B = spec["n_sge_subsets"]
    faults = 0
    sge_subsets = np.asarray(art["sge_subsets"])
    imp = np.asarray(art["wre_importance"], np.float64)
    probs = np.asarray(art["wre_probs"], np.float64)
    if sge_subsets.shape != (B, sum(bud)) or imp.shape != (m,) or probs.shape != (m,):
        return {"faults": 1.0 + faults, "sge_gap": math.inf, "sge_value": math.inf,
                "wre_gap": math.inf, "wre_value": math.inf, "probs_err": math.inf,
                "sge_err": math.inf, "wre_err": math.inf}
    if not (np.isfinite(imp).all() and np.isfinite(probs).all()):
        faults += 1
    if abs(probs.sum() - 1.0) > 1e-4:
        faults += 1
    if len(records) != len(parts):
        faults += 1
    stream = GumbelStream(seed, dev)
    feats = torch.as_tensor(features, device=dev)
    sge_gap = sge_val = wre_gap = wre_val = 0.0
    p_ref = torch.zeros((m,), dtype=torch.float64, device=dev)
    off = 0
    for i, (idx, k_c) in enumerate(zip(parts, bud)):
        n_c = len(idx)
        n_run, k_run = geometry(n_c, k_c, bucket)
        rec = records[i] if i < len(records) else {}
        local = np.full((m,), -1, np.int64)
        local[idx] = np.arange(n_c)
        picks = local[sge_subsets[:, off:off + k_c]]
        off += k_c
        K = gram64(feats[torch.as_tensor(idx, device=dev)])
        if (picks < 0).any() or any(len(set(r.tolist())) != k_c for r in picks):
            faults += 1
            picks = np.clip(picks, 0, n_c - 1)
        gains = rec.get("sge_gain")
        if gains is not None:
            gains = torch.as_tensor(gains, device=dev)[:, :k_c]
        s = candidate_count(n_run, k_run, spec["eps"])
        g, v = _sge_steps(K, torch.as_tensor(picks, device=dev), gains, stream, n_run=n_run,
                          k_run=k_run, s=s, lam=spec["graph_cut_lambda"], n_subsets=B)
        sge_gap, sge_val = max(sge_gap, g), max(sge_val, v) if gains is not None else math.inf
        order = rec.get("wre_idx")
        if order is None:
            faults += 1
            wre_gap = wre_val = math.inf
            continue
        order = np.asarray(order)[:n_c]
        if order.shape != (n_c,) or not np.array_equal(np.sort(order), np.arange(n_c)):
            faults += 1
            wre_gap = wre_val = math.inf
            continue
        o = torch.as_tensor(order, device=dev)
        if spec["hard_fn"] == "disparity_min":
            gaps, g_pick = _disparity_min_steps(K, o)
            scale = 1.0
        elif spec["hard_fn"] == "facility_location":
            gaps, g_pick = _facility_location_steps(K, o)
            scale = float(n_c)
        else:
            raise ValueError(f"no reference for hard_fn {spec['hard_fn']!r}")
        imp_c = torch.as_tensor(imp[idx], device=dev)[o]
        wre_gap = max(wre_gap, float(gaps.max()) / scale)
        wre_val = max(wre_val, float((imp_c - g_pick).abs().max()) / scale)
        g_ref = torch.empty((n_c,), dtype=torch.float64, device=dev)
        g_ref[o] = g_pick
        p_ref[torch.as_tensor(idx, device=dev)] = taylor_probs(g_ref) * (n_c / m)
    p_ref = torch.clamp_min(p_ref, 0.0)
    p_ref = p_ref / p_ref.sum()
    p_err = float((torch.as_tensor(probs, device=dev) - p_ref).abs().max() / p_ref.max())
    return {"faults": float(faults), "sge_gap": sge_gap, "sge_value": sge_val,
            "wre_gap": wre_gap, "wre_value": wre_val, "probs_err": p_err,
            "sge_err": max(sge_gap, sge_val), "wre_err": max(wre_gap, wre_val)}


# ---------------------------------------------------------------------------
# the control: the same preprocess in float32 on TF32-rounded products
# ---------------------------------------------------------------------------

def plain_preprocess(features: np.ndarray, labels: np.ndarray, spec: dict, seed: int,
                     device, *, gram=gram_tf32) -> dict[str, Any]:
    """MILO's preprocess written plainly, on the Gram ``gram`` gives: the SGE
    bank (graph cut, stochastic greedy on the replayed Gumbel stream, the
    first best candidate), the WRE pass (exact greedy, the lowest index on
    ties), importance as each row's gain at its inclusion, Taylor-softmax
    probabilities.  Returns the artifact and the record ``judge`` reads."""
    dev = torch.device(device)
    m = len(labels)
    parts = partition(labels)
    k = max(1, int(round(spec["subset_fraction"] * m)))
    bud = budgets([len(p) for p in parts], k)
    bucket = len(parts) > 1
    B, lam = spec["n_sge_subsets"], spec["graph_cut_lambda"]
    stream = GumbelStream(seed, dev)
    feats = torch.as_tensor(features, device=dev)
    subsets, records = [], []
    imp = np.zeros((m,), np.float32)
    probs = np.zeros((m,), np.float64)
    rows = torch.arange(B, device=dev)
    for idx, k_c in zip(parts, bud):
        n_c = len(idx)
        n_run, k_run = geometry(n_c, k_c, bucket)
        K = gram(feats[torch.as_tensor(idx, device=dev)])
        s = candidate_count(n_run, k_run, spec["eps"])
        colsum, diag = K.sum(0), K.diagonal()
        cur = torch.zeros((B, n_c), dtype=K.dtype, device=dev)
        selected = torch.zeros((B, n_run), dtype=torch.bool, device=dev)
        selected[:, n_c:] = True
        picks = torch.zeros((B, k_run), dtype=torch.int64, device=dev)
        gains = torch.zeros((B, k_run), dtype=torch.float32, device=dev)
        for t in range(k_run):
            cand = stream.draw((B, n_run)).masked_fill(selected, NEG).topk(s, dim=1).indices
            live = (cand < n_c) & ~selected.gather(1, cand)
            cc = cand.clamp_max(n_c - 1)
            g = (colsum[cc] - lam * (2.0 * cur.gather(1, cc) + diag[cc])).masked_fill(~live, NEG)
            best, arg = g.max(dim=1)
            j = cc.gather(1, arg[:, None])[:, 0]
            picks[:, t], gains[:, t] = j, best
            cur += K[:, j].T
            selected[rows, j] = True
        subsets.append(idx[picks[:, :k_c].cpu().numpy()])
        order, g_incl = _plain_greedy(K, spec["hard_fn"])
        imp_c = np.zeros((n_c,), np.float32)
        imp_c[order.cpu().numpy()] = g_incl.cpu().numpy()
        imp[idx] = imp_c
        probs[idx] = taylor_probs(torch.as_tensor(imp_c, dtype=torch.float64)).numpy() * (n_c / m)
        records.append({"sge_idx": picks.cpu().numpy(), "sge_gain": gains.cpu().numpy(),
                        "wre_idx": order.cpu().numpy()})
    probs = np.maximum(probs, 0.0)
    art = {"sge_subsets": np.concatenate(subsets, axis=1),
           "wre_importance": imp, "wre_probs": (probs / probs.sum()).astype(np.float32)}
    return {"artifact": art, "classes": records}


def _plain_greedy(K: torch.Tensor, hard_fn: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact greedy over every row: (order, gain at inclusion)."""
    n = K.shape[0]
    dev = K.device
    selected = torch.zeros((n,), dtype=torch.bool, device=dev)
    order = torch.zeros((n,), dtype=torch.int64, device=dev)
    g_incl = torch.zeros((n,), dtype=K.dtype, device=dev)
    if hard_fn == "disparity_min":
        dmin = torch.full((n,), CAP, dtype=K.dtype, device=dev)
        cur = torch.full((), CAP, dtype=K.dtype, device=dev)
        for t in range(n):
            g = (torch.minimum(cur, dmin) - cur).masked_fill(selected, NEG)
            j = g.argmax()
            order[t], g_incl[t] = j, g[j]
            if t >= 1:
                cur = torch.minimum(cur, dmin[j])
            dmin = torch.minimum(dmin, 1.0 - K[:, j])
            selected[j] = True
    elif hard_fn == "facility_location":
        c = torch.zeros((n,), dtype=K.dtype, device=dev)
        for t in range(n):
            g = torch.clamp_min(K - c[:, None], 0.0).sum(0).masked_fill(selected, NEG)
            j = g.argmax()
            order[t], g_incl[t] = j, g[j]
            c = torch.maximum(c, K[:, j])
            selected[j] = True
    else:
        raise ValueError(f"no reference for hard_fn {hard_fn!r}")
    return order, g_incl
