"""The paper's first-order bandwidth model (eqs 1-7) over `ConvWorkload`.

  constraint (eq 1):  K^2 * m * n <= P
  input BW   (eq 2):  B_i = Wi*Hi*M * (N/n)          (re-read per output block)
  output BW  (eq 3):  B_o = Wo*Ho*N * (2*M/m - 1)    (write + read-before-update)
  optimum    (eq 7):  m* = sqrt(2*Wo*Ho*P / (Wi*Hi*K^2)), snapped to a factor of M

with the active-memory-controller variant of Section III (B_o = Wo*Ho*N * M/m)
and per-group handling of grouped/depthwise convolutions.
"""

from __future__ import annotations

import math

import numpy as np

from repro_torch.plan.schedule import Controller, Schedule, Strategy
from repro_torch.plan.workload import ConvWorkload


def _factors(x: int) -> list[int]:
    fs = [d for d in range(1, int(math.isqrt(x)) + 1) if x % d == 0]
    return sorted(set(fs + [x // d for d in fs]))


def _snap_to_factor(value: float, total: int, cap: int) -> int:
    """Snap a real-valued block size to the nearest integer factor of `total`
    that does not exceed `cap` (the paper's adaptation of eq 7)."""
    cands = [f for f in _factors(total) if f <= cap]
    return min(cands, key=lambda f: (abs(f - value), f)) if cands else 1


def conv_bandwidth(wl: ConvWorkload, m: int, n: int, controller: Controller,
                   exact_iters: bool = False) -> tuple[float, float]:
    """(B_i, B_o) in activations for one layer under an (m, n) partition.

    `exact_iters=True` uses ceil(M/m) iteration counts (valid for any integer
    m, n); False uses the paper's M/m with m a factor of M.
    """
    g = wl.groups
    mg, ng = wl.cin // g, wl.cout // g
    m = min(m, mg)
    n = min(n, ng)
    out_iters = math.ceil(ng / n) if exact_iters else ng / n
    in_iters = math.ceil(mg / m) if exact_iters else mg / m
    b_i = wl.wi * wl.hi * wl.cin * out_iters
    writes = wl.wo * wl.ho * wl.cout * in_iters
    if controller is Controller.ACTIVE:
        b_o = writes                      # controller adds locally; write-only traffic
    else:
        b_o = 2 * writes - wl.wo * wl.ho * wl.cout  # + read-before-update
    return float(b_i), float(b_o)


def optimal_m_realvalued(wl: ConvWorkload, p_macs: int,
                         controller: Controller = Controller.PASSIVE) -> float:
    """eq (7), and its active-controller refinement: with free read-back the
    objective loses the factor 2 -> m* = sqrt(Wo*Ho*P/(Wi*Hi*K^2))."""
    factor = 2.0 if controller is Controller.PASSIVE else 1.0
    return math.sqrt(factor * wl.wo * wl.ho * p_macs
                     / (wl.wi * wl.hi * wl.k * wl.k))


def _bandwidth_terms(mg, ng, in_pref, out_pref, m, n,
                     controller: Controller, exact_iters: bool):
    """eqs (2)/(3) over candidate arrays, the one vectorized implementation
    both `conv_bandwidth_grid` and `conv_exact_search_batch` evaluate.
    ``mg``/``ng``/``in_pref``/``out_pref`` are per-group channel counts and
    the Wi*Hi*M / Wo*Ho*N prefactors, scalars or per-candidate arrays."""
    m_eff = np.minimum(m, mg)
    n_eff = np.minimum(n, ng)
    if exact_iters:
        out_iters = -(-ng // n_eff)        # ceil on int64
        in_iters = -(-mg // m_eff)
    else:
        out_iters = ng / n_eff             # the paper's real-valued convention
        in_iters = mg / m_eff
    b_i = in_pref * out_iters
    writes = out_pref * in_iters
    if controller is Controller.ACTIVE:
        b_o = writes
    else:
        b_o = 2 * writes - out_pref
    return b_i, b_o


def conv_bandwidth_grid(wl: ConvWorkload, m, n, controller: Controller,
                        exact_iters: bool = False
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized `conv_bandwidth`: (B_i, B_o) float64 arrays over candidate
    arrays ``m``/``n``, element for element equal to the scalar evaluator
    (the same exact integers, or the same IEEE divisions)."""
    m = np.asarray(m, dtype=np.int64)
    n = np.asarray(n, dtype=np.int64)
    g = wl.groups
    b_i, b_o = _bandwidth_terms(
        wl.cin // g, wl.cout // g,
        wl.wi * wl.hi * wl.cin,            # exact Python ints, as in the
        wl.wo * wl.ho * wl.cout,           # scalar path
        m, n, controller, exact_iters)
    return (np.asarray(b_i, dtype=np.float64),
            np.asarray(b_o, dtype=np.float64))


def conv_exact_candidates(wl: ConvWorkload, p_macs: int
                          ) -> tuple[np.ndarray, np.ndarray]:
    """The exact search's candidate set, in its iteration order: every
    integer m in [1, min(M/g, P/K^2)] with the greedy bandwidth-optimal
    n = min(N/g, max(1, (P/K^2) / m)) of eq (5)."""
    g = wl.groups
    mg, ng = wl.cin // g, wl.cout // g
    budget = max(1, p_macs // (wl.k * wl.k))
    m = np.arange(1, min(mg, budget) + 1, dtype=np.int64)
    n = np.minimum(ng, np.maximum(1, budget // m))
    return m, n


def closed_form_mn(wl: ConvWorkload, p_macs: int, strategy: Strategy
                   ) -> tuple[int, int]:
    """The paper's four closed-form partition rules (Section II): (m, n) for
    one layer under ``max_input`` / ``max_output`` / ``equal`` / ``paper_opt``
    (eq 7 snapped to a factor of M)."""
    g = wl.groups
    mg, ng = wl.cin // g, wl.cout // g
    budget = max(1, p_macs // (wl.k * wl.k))
    if strategy is Strategy.MAX_INPUT:
        m = min(mg, budget)
        n = min(ng, max(1, budget // m))
    elif strategy is Strategy.MAX_OUTPUT:
        n = min(ng, budget)
        m = min(mg, max(1, budget // n))
    elif strategy is Strategy.EQUAL:
        side = max(1, int(math.isqrt(budget)))
        m = min(mg, side)
        n = min(ng, max(1, budget // m))
    elif strategy is Strategy.PAPER_OPT:
        # eq (7): m* = sqrt(2 * Wo*Ho * P / (Wi*Hi * K^2))
        m_star = math.sqrt(2.0 * wl.wo * wl.ho * p_macs
                           / (wl.wi * wl.hi * wl.k * wl.k))
        m = _snap_to_factor(m_star, mg, cap=min(mg, budget))
        n = min(ng, max(1, budget // m))  # eq (5): n = P / (K^2 m)
    else:
        raise ValueError(f"strategy {strategy} has no conv closed form")
    return m, n


def plan_conv_exact_scalar(wl: ConvWorkload, p_macs: int,
                           controller: Controller) -> tuple[int, int]:
    """The exact search as a per-candidate Python loop: the parity oracle of
    the vectorized searches. Do not optimise."""
    g = wl.groups
    mg, ng = wl.cin // g, wl.cout // g
    budget = max(1, p_macs // (wl.k * wl.k))
    best_mn, best_b = (1, 1), float("inf")
    for m in range(1, min(mg, budget) + 1):
        n = min(ng, max(1, budget // m))
        b = sum(conv_bandwidth(wl, m, n, controller, exact_iters=True))
        if b < best_b:
            best_mn, best_b = (m, n), b
    return best_mn


def conv_exact_search_batch(workloads, p_macs: int, controller: Controller
                            ) -> list[tuple[int, int]]:
    """Exact search over a whole network in one shot: concatenate every
    layer's candidate set, evaluate eqs (2)/(3) on the flat arrays, and take
    one segmented argmin (the first minimum wins within a layer)."""
    workloads = list(workloads)
    if not workloads:
        return []
    cand_m, cand_n, lengths = [], [], []
    for wl in workloads:
        m, n = conv_exact_candidates(wl, p_macs)
        cand_m.append(m)
        cand_n.append(n)
        lengths.append(len(m))
    m = np.concatenate(cand_m)
    n = np.concatenate(cand_n)
    seg = np.repeat(np.arange(len(workloads)), lengths)

    def per_wl(fn):
        return np.repeat(np.fromiter((fn(w) for w in workloads), np.int64,
                                     len(workloads)), lengths)

    b_i, b_o = _bandwidth_terms(
        mg=per_wl(lambda w: w.cin // w.groups),
        ng=per_wl(lambda w: w.cout // w.groups),
        in_pref=per_wl(lambda w: w.wi * w.hi * w.cin),
        out_pref=per_wl(lambda w: w.wo * w.ho * w.cout),
        m=m, n=n, controller=controller, exact_iters=True)
    cost = (b_i + b_o).astype(np.float64)

    # Segmented first-minimum argmin: stable sort by (segment, cost, position)
    # then pick each segment's first row.
    order = np.lexsort((np.arange(cost.size), cost, seg))
    starts = np.searchsorted(seg[order], np.arange(len(workloads)))
    best = order[starts]
    return [(int(m[i]), int(n[i])) for i in best]


def plan_conv(wl: ConvWorkload, p_macs: int, strategy: Strategy,
              controller: Controller) -> Schedule:
    """Choose (m, n) for a layer given P MACs under one of the paper's four
    strategies or the exact integer search (`EXACT_OPT`, whose objective
    honours the controller). Every strategy is a `repro_torch.plan.dse`
    preset of (space, constraints, objective)."""
    from repro_torch.plan import dse
    return dse.plan_with_strategy(wl, p_macs, strategy, controller)


def min_conv_bandwidth(workloads) -> float:
    """Table III: unlimited MACs, so each layer reads its input once and
    writes its output once (eq 4 with m=M, n=N)."""
    return float(sum(w.in_acts + w.out_acts for w in workloads))
