"""Objective-driven, vectorized design-space exploration.

The paper's core step, picking the (m, n) partition that minimizes
bandwidth under a MAC budget (eq 1), is a constrained search over a design
space. Its three ingredients are first-class here:

  `SearchSpace`  candidate grids            (`repro_torch.plan.space`)
  `Constraint`   feasibility masks          (MAC budget, on-chip bytes,
                                             alignment, group divisibility)
  `Objective`    vectorized cost functions  (`repro_torch.plan.objectives`)

``search()`` scores a whole candidate grid as arrays and takes one masked
argmin; every built-in `Strategy` is a preset of (space, constraints,
objective), and ``register_strategy`` adds presets that drive ``plan()``
and ``sweep()`` by name. On top:

  sweep(networks x budgets x strategies x controllers) -> tidy rows
  pareto(rows)                                         -> frontier subset
  certify_space(workload)                              -> SpaceCertificate
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.obs.trace import Stopwatch
from repro_torch.plan import conv_model, gemm_model
from repro_torch.plan.objectives import Objective, get_objective, register_objective
from repro_torch.plan.schedule import Controller, Schedule, Strategy
from repro_torch.plan.space import (AlignedBlockSpace, Candidates, ClosedFormSpace,
                                    ConvExactSpace, ConvGridSpace, SearchSpace)
from repro_torch.plan.workload import ConvWorkload, MatmulWorkload, Workload

__all__ = [
    "Constraint", "MacBudget", "VmemBudget", "LaneAligned", "GroupDivisible",
    "StrategySpec", "SearchResult", "search", "plan_with_strategy",
    "strategy_spec", "register_strategy", "unregister_strategy",
    "sweep", "pareto", "certify_space", "register_objective", "get_objective",
    "SearchSpace", "Candidates", "ConvExactSpace", "ConvGridSpace",
    "AlignedBlockSpace", "ClosedFormSpace", "Objective",
]


# ------------------------------------------------------------------ constraints
@runtime_checkable
class Constraint(Protocol):
    """A feasibility mask over a candidate grid."""

    def __call__(self, workload: Workload, cands: Candidates,
                 budget: int) -> np.ndarray: ...


@dataclasses.dataclass(frozen=True)
class MacBudget:
    """eq (1): K^2 * m * n <= P (conv). Matmul grids pass: their budget is
    on-chip bytes."""

    def __call__(self, wl: Workload, cands: Candidates,
                 budget: int) -> np.ndarray:
        if not isinstance(wl, ConvWorkload):
            return np.ones(len(cands), dtype=bool)
        return wl.k * wl.k * cands.bm * cands.bn <= budget


@dataclasses.dataclass(frozen=True)
class VmemBudget:
    """The block's working set (input blocks, double-buffered by default,
    plus the accumulator) fits the byte budget; element widths come from the
    workload's dtypes (`gemm_model.working_set_bytes`)."""

    double_buffer: bool = True

    def __call__(self, wl: MatmulWorkload, cands: Candidates,
                 budget: int) -> np.ndarray:
        return gemm_model.working_set_bytes(
            wl, cands.bm, cands.bn, cands.bk,
            double_buffer=self.double_buffer) <= budget


@dataclasses.dataclass(frozen=True)
class LaneAligned:
    """Aligned tiling: bm a multiple of ``sublane_tile``, bn and bk of
    ``lane``."""

    lane: int = gemm_model.LANE
    sublane_tile: int = gemm_model.SUBLANE * 16

    def __call__(self, wl: Workload, cands: Candidates,
                 budget: int) -> np.ndarray:
        return ((cands.bm % self.sublane_tile == 0)
                & (cands.bn % self.lane == 0)
                & (cands.bk % self.lane == 0))


@dataclasses.dataclass(frozen=True)
class GroupDivisible:
    """Grouped convs: a partition never spans groups (m <= M/g, n <= N/g)."""

    def __call__(self, wl: ConvWorkload, cands: Candidates,
                 budget: int) -> np.ndarray:
        g = wl.groups
        return (cands.bm <= wl.cin // g) & (cands.bn <= wl.cout // g)


# ----------------------------------------------------------------- the search
@dataclasses.dataclass(frozen=True)
class StrategySpec:
    """A strategy as data: where to look, what must hold, what to minimize."""

    space: SearchSpace
    constraints: tuple = ()
    objective: Objective = "interconnect_words"


@dataclasses.dataclass(frozen=True)
class SearchResult:
    schedule: Schedule
    cost: float
    n_candidates: int
    n_feasible: int


def search(workload: Workload, budget: int | None = None, *,
           space: SearchSpace, constraints: tuple = (),
           objective: Objective = "interconnect_words",
           controller: "Controller | str" = Controller.PASSIVE) -> SearchResult:
    """One masked argmin over the space's candidate grid. Ties go to the
    earliest candidate in the space's order (``np.argmin`` keeps the first
    minimum, as a scalar loop's strict ``<`` does). With no feasible
    candidate the space's ``fallback`` is taken, or ValueError raised."""
    controller = Controller.coerce(controller)
    if budget is None:
        from repro_torch.plan.api import default_budget
        budget = default_budget(workload)
    budget = int(budget)
    cands = space(workload, budget)
    obj_fn = get_objective(objective)
    mask = np.ones(len(cands), dtype=bool)
    for c in constraints:
        mask &= c(workload, cands, budget)
    n_feasible = int(mask.sum())
    if n_feasible == 0:
        fallback = getattr(space, "fallback", None)
        if fallback is None:
            raise ValueError(
                f"no feasible candidate for {workload!r} at budget {budget}")
        cands = fallback(workload, budget)
        cost = obj_fn(workload, cands, controller)
        return SearchResult(schedule=cands.schedule_at(0, controller),
                            cost=float(cost[0]),
                            n_candidates=len(cands), n_feasible=0)
    cost = np.asarray(obj_fn(workload, cands, controller), dtype=np.float64)
    best = int(np.argmin(np.where(mask, cost, np.inf)))
    return SearchResult(schedule=cands.schedule_at(best, controller),
                        cost=float(cost[best]),
                        n_candidates=len(cands), n_feasible=n_feasible)


# ------------------------------------------------------------ strategy presets
_CONV_ALIASES = {"first_order": "paper_opt", "exhaustive_vmem": "exact_opt"}
_CONV_CLOSED = ("max_input", "max_output", "equal", "paper_opt")
_GEMM_CLOSED = ("first_order", "paper_opt", "equal")
_GEMM_EXACT = ("exhaustive_vmem", "exact_opt")

# Custom presets registered via register_strategy, keyed by (kind, name).
_CUSTOM_SPECS: dict[tuple[str, str], StrategySpec] = {}


def _conv_closed_rule(name: str):
    strategy = Strategy(name)

    def rule(wl: ConvWorkload, budget: int):
        m, n = conv_model.closed_form_mn(wl, budget, strategy)
        return m, n, 0
    return rule


def _gemm_first_order_rule(max_block: int):
    def rule(wl: MatmulWorkload, budget: int):
        return gemm_model.first_order_block(wl, budget, max_block=max_block)
    return rule


def strategy_spec(strategy: "Strategy | str", kind: str,
                  max_block: int = 4096) -> StrategySpec:
    """The (space, constraints, objective) preset behind a strategy name for
    one workload kind. Custom `register_strategy` presets take precedence;
    unknown combinations raise the planner's 'not applicable' error."""
    name = strategy.value if isinstance(strategy, Strategy) else str(strategy)
    if name.startswith("sim_") and (kind, name) not in _CUSTOM_SPECS:
        import repro_torch.sim  # noqa: F401  (registers the sim_* presets)
    if (kind, name) in _CUSTOM_SPECS:
        return _CUSTOM_SPECS[(kind, name)]
    return _builtin_spec(name, kind, max_block)


@functools.lru_cache(maxsize=None)
def _builtin_spec(name: str, kind: str, max_block: int) -> StrategySpec:
    """Built-in presets, memoized: specs and their spaces are stateless."""
    strategy = name
    if kind == "conv":
        # GEMM-flavoured names degrade to their conv equivalents: the closed
        # form *is* the first-order model, the exact search is exhaustive.
        name = _CONV_ALIASES.get(name, name)
        if name in _CONV_CLOSED:
            return StrategySpec(
                space=ClosedFormSpace(kind="conv", rule=_conv_closed_rule(name)))
        if name == "exact_opt":
            return StrategySpec(space=ConvExactSpace(),
                                constraints=(MacBudget(), GroupDivisible()))
        raise ValueError(f"strategy {strategy} is not applicable to convs")
    if kind == "matmul":
        if name in _GEMM_EXACT:
            return StrategySpec(space=AlignedBlockSpace(max_block),
                                constraints=(VmemBudget(),))
        if name in _GEMM_CLOSED:
            return StrategySpec(space=ClosedFormSpace(
                kind="matmul", rule=_gemm_first_order_rule(max_block)))
        raise ValueError(f"strategy {strategy} is not applicable to matmuls")
    raise ValueError(f"unknown workload kind {kind!r}")


def _workload_kind(workload: Workload) -> str:
    if isinstance(workload, ConvWorkload):
        return "conv"
    if isinstance(workload, MatmulWorkload):
        return "matmul"
    raise TypeError(f"unknown workload type {type(workload).__name__}")


def plan_with_strategy(workload: Workload, budget: int,
                       strategy: "Strategy | str",
                       controller: "Controller | str",
                       max_block: int = 4096, *,
                       objective: "Objective | None" = None) -> Schedule:
    """Resolve a strategy to its preset and run the search: the one
    implementation every planner in `repro_torch.plan.planners` calls.
    ``objective`` overrides the preset's scoring function and keeps its
    space and constraints."""
    spec = strategy_spec(strategy, _workload_kind(workload), max_block)
    return search(workload, budget, space=spec.space,
                  constraints=spec.constraints,
                  objective=spec.objective if objective is None else objective,
                  controller=controller).schedule


def register_strategy(name: str, *, conv: StrategySpec | None = None,
                      matmul: StrategySpec | None = None) -> None:
    """Register a custom strategy preset (and its planner) under ``name``,
    making it a ``strategy=`` argument to ``plan()`` and ``sweep()``.
    Provide a spec per workload kind the strategy supports."""
    if conv is None and matmul is None:
        raise ValueError("register_strategy needs a conv and/or matmul spec")
    from repro_torch.plan import api, planners

    # Register the planner first: a duplicate name raises here, before any
    # spec is stored, so a failed registration cannot shadow a builtin.
    @planners.register_planner(name)
    def _planner(workload, budget, controller):
        return plan_with_strategy(workload, budget, name, controller)

    if conv is not None:
        _CUSTOM_SPECS[("conv", name)] = conv
    if matmul is not None:
        _CUSTOM_SPECS[("matmul", name)] = matmul
    # plans are cached on the strategy *name*: drop anything cached under a
    # previous registration of this name, per layer and per graph alike
    api.clear_plan_cache()
    from repro_torch.plan import netplan
    netplan.clear_plan_graph_cache()


def unregister_strategy(name: str) -> None:
    """Remove a custom strategy preset and its planner. Built-in strategies
    cannot be unregistered."""
    from repro_torch.plan import api, planners
    if name in {s.value for s in Strategy}:
        raise ValueError(f"cannot unregister built-in strategy {name!r}")
    _CUSTOM_SPECS.pop(("conv", name), None)
    _CUSTOM_SPECS.pop(("matmul", name), None)
    planners.PLANNERS.pop(name, None)
    api.clear_plan_cache()
    from repro_torch.plan import netplan
    netplan.clear_plan_graph_cache()


# ---------------------------------------------------------------------- sweep
def _as_networks(networks) -> list[tuple[str, tuple]]:
    """Normalize the ``networks`` argument: a CNN-zoo name, an iterable of
    names, an iterable of workloads, or a {name: workloads} mapping."""
    from repro_torch.plan.workload import conv_workloads
    if isinstance(networks, str):
        return [(networks, conv_workloads(networks))]
    if isinstance(networks, dict):
        return [(name, tuple(wls)) for name, wls in networks.items()]
    items = list(networks)
    if not items:
        return []
    if all(isinstance(it, str) for it in items):
        return [(name, conv_workloads(name)) for name in items]
    return [("custom", tuple(items))]


def sweep(networks, budgets, strategies=("paper_opt",),
          controllers=("passive",), objective: Objective = "interconnect_words",
          exact_iters: bool | None = None, paper_convention: bool = False,
          per_layer: bool = False) -> list[dict]:
    """Evaluate networks x budgets x strategies x controllers into tidy rows.

    Each cell plans its whole network in one shot (``plan_many`` batches the
    exact conv search across layers) and yields one row, or one row per
    layer with ``per_layer=True`` (layer rows carry the ``workload`` and
    ``schedule`` objects).

    The ``cost`` column re-scores the *chosen* schedules under ``objective``
    (ceil iteration counts); selection follows each strategy's own preset.
    ``interconnect_words`` and the other word columns follow the sweep's
    ``exact_iters``/``paper_convention`` conventions, as ``network_traffic``
    does, and ``bytes`` weighs them by element width. ``us_per_call`` is
    the host time of the cell's ``plan_many`` call, in microseconds.
    """
    from repro_torch.plan import api
    obj_fn = get_objective(objective)
    obj_name = objective if isinstance(objective, str) else getattr(
        objective, "__name__", "custom")
    if isinstance(budgets, (int, np.integer)):
        budgets = (int(budgets),)
    rows: list[dict] = []
    for net_name, workloads in _as_networks(networks):
        for budget in budgets:
            for strategy in strategies:
                strat = api.coerce_strategy(strategy)
                strat_name = strat.value if isinstance(strat, Strategy) else strat
                exact = (strat is Strategy.EXACT_OPT if exact_iters is None
                         else exact_iters)
                for controller in controllers:
                    ctrl = Controller.coerce(controller)
                    wls = tuple(
                        dataclasses.replace(w, groups=1)
                        if paper_convention and isinstance(w, ConvWorkload)
                        and w.groups > 1 else w
                        for w in workloads)
                    # us_per_call times the planning itself; the
                    # objective re-scoring below is reporting, not planning
                    with Stopwatch() as sw:
                        plans = api.plan_many(wls, budget, strat, ctrl,
                                              exact_iters=exact)
                    costs = [
                        float(obj_fn(p.workload,
                                     Candidates.single(p.schedule.kind,
                                                       p.schedule.bm,
                                                       p.schedule.bn,
                                                       p.schedule.bk),
                                     ctrl)[0])
                        for p in plans]
                    base = {"network": net_name, "budget": int(budget),
                            "strategy": strat_name, "controller": ctrl.value,
                            "objective": obj_name, "us_per_call": sw.us}
                    if per_layer:
                        for p, c in zip(plans, costs):
                            rows.append({
                                **base, "layer": p.workload.name,
                                "m": p.schedule.bm, "n": p.schedule.bn,
                                "bk": p.schedule.bk, "cost": c,
                                **p.traffic.as_dict(),
                                "workload": p.workload,
                                "schedule": p.schedule})
                    else:
                        totals: dict[str, float] = {}
                        for p in plans:
                            for key, val in p.traffic.as_dict().items():
                                totals[key] = totals.get(key, 0.0) + val
                        rows.append({**base, "cost": float(sum(costs)),
                                     "n_layers": len(plans), **totals})
    return rows


def certify_space(workload: Workload, budget: int | None = None, *,
                  controller="passive", space: "SearchSpace | None" = None):
    """Certify every candidate this module would search over: delegates to
    `repro_torch.check.dataflow`, which proves the matching kernel's
    launches once per grid-degeneracy class and the vectorized word counts
    equal to the model over the whole space. Returns a
    `repro_torch.check.dataflow.SpaceCertificate`."""
    from repro_torch.check.dataflow import (certify_conv_space,
                                            certify_matmul_space)
    if isinstance(workload, ConvWorkload):
        return certify_conv_space(workload, budget, controller, space)
    return certify_matmul_space(workload, budget, controller, space)


def pareto(rows, x: str = "budget", y: str = "cost") -> list[dict]:
    """The non-dominated subset of ``rows``, minimizing both ``x`` and ``y``
    (e.g. the MAC-budget-vs-traffic frontier of the paper's central
    trade-off). Rows missing either key are ignored; output is sorted by
    ``x`` ascending."""
    pts = [r for r in rows if r.get(x) is not None and r.get(y) is not None]
    pts.sort(key=lambda r: (r[x], r[y]))
    frontier: list[dict] = []
    best_y = float("inf")
    for r in pts:
        if r[y] < best_y:
            frontier.append(r)
            best_y = r[y]
    return frontier
