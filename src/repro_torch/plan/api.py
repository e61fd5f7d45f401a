"""The front door: ``plan(workload, budget, strategy, controller) -> Plan``.

One entry point for both workload kinds: conv channel partitions against a
MAC budget (the paper's accelerator) and GEMM block shapes against a
per-block byte budget. A strategy name resolves to its planner
(`planners.get_planner`), a preset of the design-space search in `dse`.
Results are LRU-cached on the full (workload, budget, strategy, controller,
exact_iters) key; workloads are frozen dataclasses, so the key is exact.

`network_traffic` and `min_network_traffic` sum a network's words: the
quantities of the paper's Tables I-III.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.errors import PlanError
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import span
from repro_torch.plan import conv_model, gemm_model
from repro_torch.plan.planners import PLANNERS, get_planner
from repro_torch.plan.schedule import Controller, Schedule, Strategy
from repro_torch.plan.traffic import TrafficReport, traffic_report
from repro_torch.plan.workload import (ConvWorkload, MatmulWorkload, Workload,
                                       conv_workloads)

DEFAULT_P_MACS = 2048          # the paper's central MAC budget
_CACHE_SIZE = 4096


@dataclasses.dataclass(frozen=True)
class Plan:
    """A scheduled workload plus its predicted traffic."""

    workload: Workload
    budget: int
    schedule: Schedule
    traffic: TrafficReport

    @property
    def controller(self) -> Controller:
        return self.schedule.controller

    @property
    def vmem_bytes(self) -> int:
        """The planner's on-chip bytes of a matmul plan at the workload's
        element types (`Schedule.vmem_bytes`)."""
        if not isinstance(self.workload, MatmulWorkload):
            raise TypeError("vmem_bytes is defined for matmul plans only; "
                            f"this plan schedules a "
                            f"{type(self.workload).__name__}")
        return self.schedule.vmem_bytes(workload=self.workload)


def default_budget(workload: Workload) -> int:
    """P MACs for convs, shared-memory bytes for matmuls."""
    if isinstance(workload, ConvWorkload):
        return DEFAULT_P_MACS
    return gemm_model.SMEM_BUDGET


def coerce_strategy(value: "Strategy | str") -> "Strategy | str":
    """Coerce to a `Strategy` member, or pass through the name of a custom
    strategy registered with ``dse.register_strategy`` / ``register_planner``
    (strings stay strings, so the plan cache keys them). Any other name
    raises `PlanError`."""
    if isinstance(value, Strategy):
        return value
    try:
        return Strategy(value)
    except ValueError:
        if value in PLANNERS:
            return value
        waits = (" (the sim_* strategies wait for the SoC simulator, ROADMAP "
                 "A10)" if str(value).startswith("sim_") else "")
        raise PlanError(
            f"unknown strategy {value!r}{waits}; known: "
            f"{sorted(set([s.value for s in Strategy]) | set(PLANNERS))}"
        ) from None


@functools.lru_cache(maxsize=_CACHE_SIZE)
def _plan_cached(workload: Workload, budget: int, strategy: "Strategy | str",
                 controller: Controller, exact_iters: bool) -> Plan:
    with span("plan", cat="plan", workload=workload.name or "shape",
              strategy=(strategy.value if isinstance(strategy, Strategy)
                        else str(strategy)),
              controller=controller.value):
        schedule = get_planner(strategy)(workload, budget, controller)
        return Plan(workload=workload, budget=budget, schedule=schedule,
                    traffic=traffic_report(workload, schedule, exact_iters))


# ``plan()``'s LRU statistics, sampled straight off the lru_cache at
# metric-collection time (callback gauges: no bookkeeping on the hot path).
for _field in ("hits", "misses", "currsize"):
    REGISTRY.gauge("plan_cache", "plan() LRU statistics",
                   labels={"field": _field},
                   fn=(lambda f=_field:
                       float(getattr(_plan_cached.cache_info(), f))))
del _field


def plan(workload: Workload, budget: int | None = None,
         strategy: "Strategy | str" = Strategy.PAPER_OPT,
         controller: "Controller | str" = Controller.PASSIVE,
         exact_iters: bool = True, *, checked: bool = False) -> Plan:
    """Plan one workload: choose a `Schedule` and predict its traffic.

    budget: P MACs (conv) or bytes (matmul); None picks the kind's default.
    ``exact_iters`` selects ceil iteration counts for the conv traffic report
    (False reproduces the paper's real-valued convention). ``strategy``
    takes the built-in `Strategy` values and any name registered through
    ``dse.register_strategy``. ``checked=True`` runs the
    `repro_torch.check` verifier passes on the result and raises
    `repro_torch.check.CheckError` on any error-severity diagnostic (e.g. a
    budget so small that the fallback schedule breaks eq 1).
    """
    budget = default_budget(workload) if budget is None else int(budget)
    result = _plan_cached(workload, budget, coerce_strategy(strategy),
                          Controller.coerce(controller), exact_iters)
    if checked:
        from repro_torch.check import verify     # deferred: check imports plan
        verify(result, context=f"plan({workload!r}) failed verification")
    return result


def plan_many(workloads, budget: int | None = None,
              strategy: "Strategy | str" = Strategy.PAPER_OPT,
              controller: "Controller | str" = Controller.PASSIVE,
              exact_iters: bool = True) -> list[Plan]:
    """Plan a list of workloads (or a named CNN) under one budget. An
    all-conv exact search runs as one batch across the network: the same
    schedules as per-layer ``plan()`` calls, one segmented argmin."""
    if isinstance(workloads, str):
        workloads = conv_workloads(workloads)
    workloads = list(workloads)
    strategy = coerce_strategy(strategy)
    controller = Controller.coerce(controller)
    if (strategy in (Strategy.EXACT_OPT, Strategy.EXHAUSTIVE_VMEM)
            and workloads and all(isinstance(w, ConvWorkload)
                                  for w in workloads)):
        p_macs = DEFAULT_P_MACS if budget is None else int(budget)
        mns = conv_model.conv_exact_search_batch(workloads, p_macs, controller)
        plans = []
        for wl, (m, n) in zip(workloads, mns):
            schedule = Schedule(kind="conv", bm=m, bn=n, bk=0,
                                controller=controller)
            plans.append(Plan(workload=wl, budget=p_macs, schedule=schedule,
                              traffic=traffic_report(wl, schedule, exact_iters)))
        return plans
    return [plan(w, budget, strategy, controller, exact_iters)
            for w in workloads]


def plan_cache_info():
    return _plan_cached.cache_info()


def clear_plan_cache() -> None:
    _plan_cached.cache_clear()


# ----------------------------------------------------------- network helpers
def network_traffic(workloads, budget: int,
                    strategy: "Strategy | str" = Strategy.PAPER_OPT,
                    controller: "Controller | str" = Controller.PASSIVE,
                    exact_iters: bool | None = None,
                    paper_convention: bool = False) -> float:
    """Total conv interconnect words of a network at one budget: the
    quantity of the paper's Tables I/II.

    ``paper_convention=True`` treats grouped/depthwise convolutions as dense
    reductions (groups ignored), the paper's modelling choice; the default
    is groups-aware. ``exact_iters=None`` keeps the legacy convention: ceil
    iteration counts for the exact search only.
    """
    if isinstance(workloads, str):
        workloads = conv_workloads(workloads)
    strategy = coerce_strategy(strategy)
    controller = Controller.coerce(controller)
    exact = strategy is Strategy.EXACT_OPT if exact_iters is None else exact_iters
    wls = [dataclasses.replace(wl, groups=1)
           if paper_convention and wl.groups > 1 else wl for wl in workloads]
    plans = plan_many(wls, budget, strategy, controller, exact_iters=exact)
    return sum(p.traffic.interconnect_words for p in plans)


def min_network_traffic(workloads) -> float:
    """Table III floor: unlimited MACs (eq 4 with m=M, n=N)."""
    if isinstance(workloads, str):
        workloads = conv_workloads(workloads)
    return conv_model.min_conv_bandwidth(workloads)
