"""`sim_latency` / `sim_energy`: simulated time and energy as first-class DSE
objectives — and as ``plan(strategy=...)`` presets.

The first-order objectives rank candidate schedules by *words moved*; these
rank by what the cycle-approximate simulator says the words *cost*: latency
folds in burst/row-buffer efficiency, DMA overlap, and bus/SRAM service
rates, and energy adds the DRAM row-activation term the byte-count model
cannot see. An objective call evaluates the whole grid through the batched
evaluator (`repro_torch.sim.batch`) — one closed-form array pass, no per-candidate
Python objects — so a full conv exact space costs microseconds, not the
milliseconds-per-layer of the old per-candidate ``simulate()`` loop
(``scalar_sim_objective`` keeps that loop as the frozen parity oracle).

``sim_latency`` and ``sim_energy`` are module-level `SimObjective` instances
(hoisted once at import — repeated DSE sweeps share them instead of
re-closing over the hardware parameters per call).

Importing ``repro_torch.sim`` registers both objectives and the matching strategy
presets; `repro_torch.plan` also lazy-imports this package when it meets an
unknown ``sim_*`` strategy/objective name, so

    plan.plan(wl, strategy="sim_latency", controller="active")
    dse.sweep("resnet18", 2048, strategies=("sim_latency",), ...)

work without an explicit import.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from repro_torch.plan import dse
from repro_torch.plan.objectives import OBJECTIVES, register_objective
from repro_torch.plan.schedule import Controller
from repro_torch.plan.space import Candidates
from repro_torch.plan.workload import Workload
from repro_torch.sim.batch import BatchSimResult, simulate_batch
from repro_torch.sim.engine import simulate
from repro_torch.sim.params import DEFAULT_PARAMS, SimParams

__all__ = ["SimObjective", "sim_latency", "sim_energy", "make_sim_objective",
           "scalar_sim_objective", "register_sim_strategies"]


class SimObjective:
    """A vectorized DSE objective over a simulated `SimReport` metric.

    Callable with the standard objective signature
    ``(workload, Candidates, controller) -> float64 cost array``; the whole
    grid is evaluated in one `simulate_batch` pass. ``batch()`` exposes the
    full `BatchSimResult` (with the netplan residency knobs) for consumers
    that need more than the cost column, e.g. the sim-objective network
    planner.
    """

    def __init__(self, metric: str, params: SimParams | None = None,
                 name: str | None = None) -> None:
        self.metric = metric
        self.params = DEFAULT_PARAMS if params is None else params
        self.__name__ = f"sim_{metric}" if name is None else name

    def __repr__(self) -> str:
        return f"SimObjective({self.metric!r})"

    def batch(self, wl: Workload, cands: Candidates,
              controller: "Controller | str", *,
              spilled_in_words: int | None = None,
              out_spilled: bool = True) -> BatchSimResult:
        return simulate_batch(wl, cands, controller, self.params,
                              spilled_in_words=spilled_in_words,
                              out_spilled=out_spilled)

    def __call__(self, wl: Workload, cands: Candidates,
                 controller: Controller) -> np.ndarray:
        return np.asarray(self.batch(wl, cands, controller)
                          .metric(self.metric), dtype=np.float64)


def make_sim_objective(metric: str,
                       params: SimParams | None = None) -> SimObjective:
    """A vectorized objective over ``SimReport.<metric>`` — build your own
    variant with custom hardware parameters and register it under a new
    name. (`sim_latency` / `sim_energy` are the two premade instances.)"""
    return SimObjective(metric, params)


def scalar_sim_objective(
        metric: str, params: SimParams | None = None
) -> Callable[[Workload, Candidates, Controller], np.ndarray]:
    """The per-candidate ``simulate()`` loop, kept frozen as the parity
    oracle for the batch evaluator's tests and as the loop-rate baseline.
    Do not optimise."""
    params = DEFAULT_PARAMS if params is None else params

    def objective(wl: Workload, cands: Candidates,
                  controller: Controller) -> np.ndarray:
        out = np.empty(len(cands), dtype=np.float64)
        for i in range(len(cands)):
            rep = simulate(wl, cands.schedule_at(i, controller), params)
            out[i] = getattr(rep, metric)
        return out

    objective.__name__ = f"sim_{metric}_scalar"
    return objective


#: Simulated end-to-end seconds (default hardware parameters). Named after
#: its registered strategy/objective key, as the old function was.
sim_latency = SimObjective("latency_s", name="sim_latency")

#: Simulated pJ, including the DRAM row-activation term.
sim_energy = SimObjective("energy_pj", name="sim_energy")


def register_sim_strategies() -> None:
    """Idempotently register the objectives and their strategy presets (the
    sim analogues of ``exact_opt``: same candidate spaces and feasibility
    constraints, simulated cost instead of word count)."""
    if "sim_latency" in OBJECTIVES:
        return
    register_objective("sim_latency")(sim_latency)
    register_objective("sim_energy")(sim_energy)
    for name in ("sim_latency", "sim_energy"):
        dse.register_strategy(
            name,
            conv=dse.StrategySpec(
                space=dse.ConvExactSpace(),
                constraints=(dse.MacBudget(), dse.GroupDivisible()),
                objective=name),
            matmul=dse.StrategySpec(
                space=dse.AlignedBlockSpace(),
                constraints=(dse.VmemBudget(),),
                objective=name))


register_sim_strategies()
