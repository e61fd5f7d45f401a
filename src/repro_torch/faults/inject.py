"""Seeded fault-schedule generation and degraded re-planning.

`generate_schedule` is the single source of randomness in the fault layer:
one ``random.Random(seed)`` drives every draw, and every fault parameter is
picked from a small quantized pool (½/¼/¾ survival fractions, 1.5x/2x/4x
DRAM throttles, ...), so (a) the same seed always yields byte-identical
schedules and (b) degraded planning parameters repeat across seeds, which
keeps the chaos harness hitting the graph-level plan LRU instead of running
a fresh beam search per schedule.

`apply_to_plan` is the degradation path itself: fold the schedule's
plan-affecting faults over a `NetPlan`'s parameters (`degraded_plan_args`)
and re-derive the plan. Budget / residency degradations ride the incremental
``NetPlan.replan``; a `ControllerFallback` changes the word-count model
itself, so it re-plans from scratch (same strategy/objective/`PlanContext`).
Either way the chaos harness pins the result word-for-word against a fresh
cache-bypassing ``fleet.plan_graph_loop`` under the same degraded params.
"""

from __future__ import annotations

import random
from typing import Optional, Sequence, Tuple

from repro_torch.faults.models import (ControllerFallback, DmaStall, DramThrottle,
                                 EngineDegrade, Fault, FaultEvent,
                                 FaultSchedule, PlanArgs, RequestStorm,
                                 VmemShrink)
from repro_torch.plan.netplan import NetPlan, plan_graph

__all__ = ["generate_schedule", "degraded_plan_args", "plan_args_of",
           "apply_to_plan", "storm_windows", "SURVIVING_FRACS",
           "THROTTLE_FACTORS", "STORM_FACTORS"]

# Quantized fault-parameter pools. Coarse on purpose: degraded plan
# parameters drawn from a small set recur across seeds, so chaos runs reuse
# cached degraded plans instead of exploding the search space.
SURVIVING_FRACS = (0.25, 0.5, 0.75)
THROTTLE_FACTORS = (1.5, 2.0, 4.0)
STORM_FACTORS = (2.0, 4.0, 8.0)
_DURATIONS_EPOCHS = (64, 256, 1024, None)     # None = permanent
_EPOCH_START_HORIZON = 4096


def _draw_fault(rng: random.Random) -> Fault:
    start = rng.randrange(_EPOCH_START_HORIZON)
    dur = rng.choice(_DURATIONS_EPOCHS)
    kind = rng.randrange(6)
    if kind == 0:
        return EngineDegrade(start_epoch=start, duration_epochs=dur,
                             surviving_frac=rng.choice(SURVIVING_FRACS))
    if kind == 1:
        return VmemShrink(start_epoch=start, duration_epochs=dur,
                          surviving_frac=rng.choice(SURVIVING_FRACS))
    if kind == 2:
        return DramThrottle(start_epoch=start, duration_epochs=dur,
                            t_burst_factor=rng.choice(THROTTLE_FACTORS),
                            row_buffer_disabled=rng.random() < 0.5)
    if kind == 3:
        return ControllerFallback(start_epoch=start, duration_epochs=dur)
    if kind == 4:
        return DmaStall(start_epoch=start, duration_epochs=dur)
    return RequestStorm(start_epoch=start, duration_epochs=dur,
                        rate_factor=rng.choice(STORM_FACTORS),
                        duration_s=rng.choice((0.1, 0.2)))


def generate_schedule(seed: int, *, horizon_s: float = 1.0,
                      max_events: int = 3) -> FaultSchedule:
    """A reproducible fault schedule: 1..``max_events`` injections at seeded
    times within ``[0, horizon_s)``, each a seeded draw from the quantized
    fault pools. Same ``seed`` (and kwargs) → byte-identical schedule."""
    rng = random.Random(seed)
    n = rng.randint(1, max(1, max_events))
    times = sorted(round(rng.uniform(0.0, horizon_s), 6) for _ in range(n))
    events = tuple(FaultEvent(t_s=t, fault=_draw_fault(rng)) for t in times)
    return FaultSchedule(seed=seed, horizon_s=horizon_s, events=events)


def plan_args_of(netp: NetPlan) -> PlanArgs:
    """The fault-degradable parameters of an existing plan."""
    return PlanArgs(budget=netp.budget,
                    residency_bytes=netp.residency_bytes,
                    controller=netp.controller)


def degraded_plan_args(faults: Sequence[Fault],
                       base: PlanArgs) -> PlanArgs:
    """Fold every plan-affecting fault over ``base``, in injection order
    (degradations compound: two half-VMEM faults leave a quarter)."""
    for f in faults:
        if f.affects_plan:
            base = f.apply_plan(base)
    return base


def apply_to_plan(netp: NetPlan, faults: Sequence[Fault], *,
                  checked: bool = False) -> Optional[NetPlan]:
    """Re-derive ``netp`` under the degradations in ``faults``.

    Returns ``netp`` itself when no fault touches its parameters. Budget /
    residency changes take the incremental ``NetPlan.replan`` path; a
    controller fallback re-plans from scratch under the same strategy,
    objective and `PlanContext` (the controller changes the word-count model,
    which `replan` deliberately does not support). The result is bit-for-bit
    a fresh ``plan_graph`` under the degraded parameters — the property the
    chaos harness and test suite pin.
    """
    base = plan_args_of(netp)
    deg = degraded_plan_args(faults, base)
    if deg == base:
        return netp
    if deg.controller is netp.controller:
        return netp.replan(budget=deg.budget,
                           residency_bytes=deg.residency_bytes,
                           checked=checked)
    rp = netp._replay
    return plan_graph(
        netp.graph, deg.budget,
        rp.strategy if rp is not None else netp.strategy,
        deg.controller, deg.residency_bytes, netp.beam_width,
        objective=rp.objective if rp is not None else None,
        checked=checked,
        context=rp.context if rp is not None else None)


def storm_windows(schedule: FaultSchedule) -> Tuple[Tuple[float, float,
                                                          float], ...]:
    """The schedule's load-storm windows as ``(t0, t1, rate_factor)`` —
    the shape the planner-service load generator consumes."""
    out = []
    for ev in schedule.storms():
        storm = ev.fault
        assert isinstance(storm, RequestStorm)
        out.append((ev.t_s, ev.t_s + storm.duration_s, storm.rate_factor))
    return tuple(out)
