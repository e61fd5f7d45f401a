"""`Planner` protocol + registry.

A planner maps (workload, budget, controller) -> `Schedule`. The registry is
keyed by strategy name, and ``repro_torch.plan.plan`` looks planners up
here. Every built-in planner is a preset of (space, constraints, objective)
resolved by ``dse.strategy_spec`` and run as one masked argmin:

  name              conv preset                  matmul preset
  ----------------  ---------------------------  -----------------------------
  paper_opt         eq (7) closed-form point     first-order square blocks
  exact_opt         exact space + MAC budget     aligned space + byte budget
  first_order       alias of paper_opt           first-order square blocks
  exhaustive_vmem   alias of exact_opt           aligned space + byte budget
  equal             m = n = sqrt(P)/K            first-order square blocks
  max_input/max_output                           (conv-only paper baselines)

Custom presets, including ones built around a registered `Objective`, enter
through ``dse.register_strategy``.
"""

from __future__ import annotations

from typing import Callable, Protocol

from repro_torch.plan import dse
from repro_torch.plan.schedule import Controller, Schedule, Strategy
from repro_torch.plan.workload import Workload


class Planner(Protocol):
    """Anything that turns a budgeted workload into a `Schedule`."""

    def __call__(self, workload: Workload, budget: int,
                 controller: Controller) -> Schedule: ...


PLANNERS: dict[str, Planner] = {}


def register_planner(name: str) -> Callable[[Planner], Planner]:
    def deco(fn: Planner) -> Planner:
        if name in PLANNERS:
            raise ValueError(f"planner {name!r} already registered")
        PLANNERS[name] = fn
        return fn
    return deco


def get_planner(name: "str | Strategy") -> Planner:
    key = name.value if isinstance(name, Strategy) else name
    try:
        return PLANNERS[key]
    except KeyError:
        raise KeyError(
            f"unknown planner {key!r}; registered: {sorted(PLANNERS)}") from None


def _strategy_planner(strategy: Strategy) -> Planner:
    def planner(workload: Workload, budget: int,
                controller: Controller) -> Schedule:
        return dse.plan_with_strategy(workload, budget, strategy, controller)
    planner.__name__ = f"plan_{strategy.value}"
    return planner


for _s in Strategy:
    register_planner(_s.value)(_strategy_planner(_s))
