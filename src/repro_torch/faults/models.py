"""Typed fault taxonomy for the plan→sim→serve stack.

Every fault is a frozen dataclass describing one *degradation of the machine
or its load*, with two orthogonal projections:

  * **sim projection** (`apply_params`): a pure ``SimParams -> SimParams``
    transform, applied to the epochs inside the fault's
    ``[start_epoch, start_epoch + duration_epochs)`` window by
    ``repro_torch.sim.simulate(..., faults=...)``. Sim faults may change *timing
    and energy only* — word counts are computed from the workload/schedule
    arithmetic and are pinned bit-for-bit against the un-faulted totals.
  * **plan projection** (`apply_plan`): a pure ``PlanArgs -> PlanArgs``
    transform mapping the fault onto degraded planning parameters (MAC
    budget P, residency bytes, controller). ``repro_torch.faults.inject``
    feeds the result to ``NetPlan.replan`` / ``plan_graph`` and the chaos
    harness pins the replanned result word for word against a fresh plan.

`RequestStorm` is the odd one out: it degrades the *load*, not the machine —
the planner-service load generator multiplies its arrival rate inside the
storm window. The class flags (``affects_sim`` / ``affects_plan`` /
``affects_serve``) let schedules be partitioned without isinstance ladders.

Fault *schedules* (`FaultSchedule`: seeded, time-ordered `FaultEvent`\\ s)
are built by `repro_torch.faults.inject.generate_schedule`; the same seed
always yields the same schedule, so every chaos run is reproducible.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterator, NamedTuple, Optional, Tuple

from repro_torch.plan.schedule import Controller
from repro_torch.sim.params import SimParams


class PlanArgs(NamedTuple):
    """The planning parameters a fault can degrade.

    ``budget=None`` means the per-workload default — `EngineDegrade` resolves
    it against ``repro_torch.plan.DEFAULT_P_MACS`` before shrinking so the degraded
    budget is always concrete.
    """

    budget: Optional[int]
    residency_bytes: int
    controller: Controller


@dataclasses.dataclass(frozen=True)
class Fault:
    """Base fault event.

    ``start_epoch`` / ``duration_epochs`` bound the *sim* projection's
    transient window in epoch-walk order (``duration_epochs=None`` =
    permanent from ``start_epoch`` on). The plan/serve projections treat the
    fault as state — active from its `FaultEvent` injection time onward.
    """

    start_epoch: int = 0
    duration_epochs: Optional[int] = None

    #: which layers of the stack this fault kind degrades
    affects_sim: bool = dataclasses.field(default=False, repr=False)
    affects_plan: bool = dataclasses.field(default=False, repr=False)
    affects_serve: bool = dataclasses.field(default=False, repr=False)

    def window(self, n_epochs: int) -> Tuple[int, int]:
        """The fault's active epoch range clipped to ``[0, n_epochs)``."""
        start = min(max(int(self.start_epoch), 0), n_epochs)
        if self.duration_epochs is None:
            return start, n_epochs
        return start, min(start + max(int(self.duration_epochs), 0), n_epochs)

    def shifted(self, delta_epochs: int) -> "Fault":
        """The same fault with its epoch window translated by ``delta``
        (used to thread one network-global window across per-node walks).
        A window that starts before the new frame is clipped — the elapsed
        part of its duration is spent, not deferred."""
        start = self.start_epoch + delta_epochs
        dur = self.duration_epochs
        if start < 0:
            if dur is not None:
                dur = max(dur + start, 0)
            start = 0
        return dataclasses.replace(self, start_epoch=start,
                                   duration_epochs=dur)

    # -- sim projection: timing/energy only, never word counts --------------
    def apply_params(self, params: SimParams) -> SimParams:
        return params

    # -- plan projection: degraded planning parameters ----------------------
    def apply_plan(self, args: PlanArgs) -> PlanArgs:
        return args


@dataclasses.dataclass(frozen=True)
class EngineDegrade(Fault):
    """Loss of MAC capacity: only ``surviving_frac`` of the engine's P MACs
    (equivalently, of the fleet's devices) still answer.

    Sim: the MAC array retires proportionally fewer MACs per cycle.
    Plan: eq (1)'s budget P shrinks by the same fraction, so the optimal
    (m, n) partition moves: serving the old schedule is the stale-plan
    failure. ``surviving_devices`` optionally pins an absolute device count
    (the reference's elastic mesh reads it).
    """

    surviving_frac: float = 0.5
    surviving_devices: Optional[int] = None
    affects_sim: bool = dataclasses.field(default=True, repr=False)
    affects_plan: bool = dataclasses.field(default=True, repr=False)

    def __post_init__(self) -> None:
        if not 0.0 < self.surviving_frac <= 1.0:
            raise ValueError(f"surviving_frac must be in (0, 1], got "
                             f"{self.surviving_frac}")

    def apply_params(self, params: SimParams) -> SimParams:
        macs = max(1, int(params.macs_per_cycle * self.surviving_frac))
        return dataclasses.replace(params, macs_per_cycle=macs)

    def apply_plan(self, args: PlanArgs) -> PlanArgs:
        from repro_torch.plan.api import DEFAULT_P_MACS
        base = DEFAULT_P_MACS if args.budget is None else int(args.budget)
        return args._replace(budget=max(1, int(base * self.surviving_frac)))


@dataclasses.dataclass(frozen=True)
class VmemShrink(Fault):
    """Loss of engine-side SRAM: the residency buffer holding fused
    inter-layer feature maps shrinks to ``surviving_frac`` of its bytes.

    Plan-level only: tensors that no longer fit must spill, so the fused
    residency assignment (and with it the schedule choices) must be
    re-derived — ``NetPlan.replan(residency_bytes=...)``.
    """

    surviving_frac: float = 0.5
    affects_plan: bool = dataclasses.field(default=True, repr=False)

    def __post_init__(self) -> None:
        if not 0.0 <= self.surviving_frac <= 1.0:
            raise ValueError(f"surviving_frac must be in [0, 1], got "
                             f"{self.surviving_frac}")

    def apply_plan(self, args: PlanArgs) -> PlanArgs:
        return args._replace(
            residency_bytes=int(args.residency_bytes * self.surviving_frac))


@dataclasses.dataclass(frozen=True)
class DramThrottle(Fault):
    """DRAM-channel degradation: bursts take ``t_burst_factor`` times as
    long (thermal throttling / a failed rank), and with
    ``row_buffer_disabled`` the open-page row buffer no longer caches —
    every burst pays a row activation (closed-page mode).

    Sim-level only: word counts are unchanged; fetch-bound phases slow down
    and row-activation energy rises.
    """

    t_burst_factor: float = 2.0
    row_buffer_disabled: bool = False
    affects_sim: bool = dataclasses.field(default=True, repr=False)

    def __post_init__(self) -> None:
        if self.t_burst_factor < 1.0:
            raise ValueError(f"t_burst_factor must be >= 1, got "
                             f"{self.t_burst_factor}")

    def apply_params(self, params: SimParams) -> SimParams:
        dram = params.dram
        t_burst = max(1, int(math.ceil(dram.t_burst * self.t_burst_factor)))
        row_bytes = dram.burst_bytes if self.row_buffer_disabled \
            else dram.row_bytes
        return dataclasses.replace(
            params, dram=dataclasses.replace(dram, t_burst=t_burst,
                                             row_bytes=row_bytes))


@dataclasses.dataclass(frozen=True)
class ControllerFallback(Fault):
    """The active memory controller falls back to passive operation (its
    local read-modify-write unit is down): partial sums round-trip over the
    interconnect again, giving up the paper's Section III saving.

    Plan-level: the controller is part of the schedule (it changes the word
    counts the planner optimizes), so the fallback re-plans under
    ``controller="passive"`` rather than re-timing the old schedule — a
    controller change is never a timing-only fault.
    """

    to: Controller = Controller.PASSIVE
    affects_plan: bool = dataclasses.field(default=True, repr=False)

    def apply_plan(self, args: PlanArgs) -> PlanArgs:
        return args._replace(controller=self.to)


@dataclasses.dataclass(frozen=True)
class DmaStall(Fault):
    """The DMA prefetch engine stalls: double buffering is lost, so the next
    input block's fetch serializes with the current block's compute instead
    of hiding behind it. Sim-level only; word counts unchanged."""

    affects_sim: bool = dataclasses.field(default=True, repr=False)

    def apply_params(self, params: SimParams) -> SimParams:
        return dataclasses.replace(params, dma_double_buffer=False)


@dataclasses.dataclass(frozen=True)
class RequestStorm(Fault):
    """A load fault: the planner service's arrival rate multiplies by
    ``rate_factor`` for ``duration_s`` seconds of virtual time. Exercises
    the bounded admission queue, load shedding, and the circuit breaker."""

    rate_factor: float = 4.0
    duration_s: float = 0.2
    affects_serve: bool = dataclasses.field(default=True, repr=False)

    def __post_init__(self) -> None:
        if self.rate_factor < 1.0 or self.duration_s <= 0.0:
            raise ValueError(f"need rate_factor >= 1 and duration_s > 0, "
                             f"got {self}")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled injection: the fault becomes active at virtual-clock
    time ``t_s`` (serve/plan projections) with its own epoch window (sim
    projection)."""

    t_s: float
    fault: Fault


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A seeded, time-ordered sequence of fault injections.

    Built by a seeded generator (the reference's ``generate_schedule``); the
    ``seed`` is carried so reports and failures name the schedule that
    produced them.
    """

    seed: int
    horizon_s: float
    events: Tuple[FaultEvent, ...]

    def __post_init__(self) -> None:
        ts = [e.t_s for e in self.events]
        if ts != sorted(ts):
            raise ValueError("fault events must be time-ordered")

    def __iter__(self) -> Iterator[FaultEvent]:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def sim_faults(self) -> Tuple[Fault, ...]:
        """The machine faults the simulator prices (timing/energy only)."""
        return tuple(e.fault for e in self.events if e.fault.affects_sim)

    def plan_faults(self) -> Tuple[Fault, ...]:
        """The faults that degrade planning parameters, in injection order."""
        return tuple(e.fault for e in self.events if e.fault.affects_plan)

    def storms(self) -> Tuple[FaultEvent, ...]:
        """The load faults, with their injection times."""
        return tuple(e for e in self.events if e.fault.affects_serve)
