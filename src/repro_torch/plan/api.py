"""The front door: ``plan(workload, budget, strategy, controller) -> Plan``.

One entry point for both workload kinds: conv channel partitions against a
MAC budget (the paper's accelerator) and GEMM block shapes against a
per-block byte budget. Strategies dispatch straight onto `conv_model` and
`gemm_model`:

  conv    max_input / max_output / equal / paper_opt -> `closed_form_mn`
          exact_opt (alias exhaustive_vmem)         -> the exact search
  matmul  exhaustive_vmem / exact_opt               -> `gemm_model.plan_gemm`
"""

from __future__ import annotations

import dataclasses

from repro_torch.plan import conv_model, gemm_model
from repro_torch.plan.schedule import Controller, Schedule, Strategy
from repro_torch.plan.traffic import TrafficReport, traffic_report
from repro_torch.plan.workload import (ConvWorkload, MatmulWorkload, Workload,
                                       conv_workloads)

DEFAULT_P_MACS = 2048          # the paper's central MAC budget

_CONV_CLOSED = (Strategy.MAX_INPUT, Strategy.MAX_OUTPUT, Strategy.EQUAL,
                Strategy.PAPER_OPT)
_EXACT = (Strategy.EXACT_OPT, Strategy.EXHAUSTIVE_VMEM)


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


def default_budget(workload: Workload) -> int:
    """P MACs for convs, shared-memory bytes for matmuls."""
    if isinstance(workload, ConvWorkload):
        return DEFAULT_P_MACS
    return gemm_model.SMEM_BUDGET


def _schedule(workload: Workload, budget: int, strategy: Strategy,
              controller: Controller) -> Schedule:
    if isinstance(workload, ConvWorkload):
        if strategy in _CONV_CLOSED:
            m, n = conv_model.closed_form_mn(workload, budget, strategy)
        elif strategy in _EXACT:
            (m, n), = conv_model.conv_exact_search_batch([workload], budget,
                                                         controller)
        else:
            raise ValueError(f"strategy {strategy.value} is not ported for convs")
        return Schedule(kind="conv", bm=m, bn=n, bk=0, controller=controller)
    if isinstance(workload, MatmulWorkload):
        return gemm_model.plan_gemm(workload, budget, strategy, controller)
    raise TypeError(f"unknown workload type {type(workload).__name__}")


def plan(workload: Workload, budget: int | None = None,
         strategy: "Strategy | str" = Strategy.PAPER_OPT,
         controller: "Controller | str" = Controller.PASSIVE,
         exact_iters: bool = True) -> Plan:
    """Plan one workload: choose a `Schedule` and predict its traffic.

    budget: P MACs (conv) or bytes (matmul); None picks the kind's default.
    ``exact_iters`` selects ceil iteration counts for the conv traffic report
    (False reproduces the paper's real-valued convention).
    """
    budget = default_budget(workload) if budget is None else int(budget)
    schedule = _schedule(workload, budget, Strategy.coerce(strategy),
                         Controller.coerce(controller))
    return Plan(workload=workload, budget=budget, schedule=schedule,
                traffic=traffic_report(workload, schedule, exact_iters))


def plan_many(workloads, budget: int | None = None,
              strategy: "Strategy | str" = Strategy.PAPER_OPT,
              controller: "Controller | str" = Controller.PASSIVE,
              exact_iters: bool = True) -> list[Plan]:
    """Plan a list of workloads (or a named CNN) under one budget. An
    all-conv exact search runs as one batch across the network."""
    if isinstance(workloads, str):
        workloads = conv_workloads(workloads)
    workloads = list(workloads)
    strategy = Strategy.coerce(strategy)
    controller = Controller.coerce(controller)
    if (strategy in _EXACT and workloads
            and all(isinstance(w, ConvWorkload) for w in workloads)):
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
