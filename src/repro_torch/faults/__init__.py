"""`repro_torch.faults`: deterministic fault injection and graceful
degradation, the reference's ``repro.faults`` on the port's planner and
simulator.

A typed fault taxonomy (`models`), seeded reproducible fault schedules and
degraded re-planning (`inject`), and a chaos harness (`chaos`) that drives
randomized schedules through the zoo and the hardened planner service
(`repro_torch.launch.planserve.ResilientPlanServer`) while asserting the
stack's invariants: word counts never drift under machine faults, degraded
re-planning is bit for bit a fresh plan, every surviving plan passes
`repro_torch.check`, and service availability stays above the floor. All of
it runs on the host in numpy and equals the reference with ``==``.

    from repro_torch import faults, sim

    sched = faults.generate_schedule(seed=7)
    rep = netp.simulate()                       # healthy timing
    hurt = sim.simulate_network(netp, faults=sched.sim_faults())
    hurt.as_traffic_report() == rep.as_traffic_report()   # words: invariant
    degraded = faults.apply_to_plan(netp, sched.plan_faults())

    python -m repro_torch.faults --schedules 50 --smoke   # the chaos harness
"""

from repro_torch.faults.chaos import (DEFAULT_AVAILABILITY_FLOOR_PCT,
                                      ChaosReport, run_chaos)
from repro_torch.faults.inject import (STORM_FACTORS, SURVIVING_FRACS,
                                       THROTTLE_FACTORS, apply_to_plan,
                                       degraded_plan_args, generate_schedule,
                                       plan_args_of, storm_windows)
from repro_torch.faults.models import (ControllerFallback, DmaStall,
                                       DramThrottle, EngineDegrade, Fault,
                                       FaultEvent, FaultSchedule, PlanArgs,
                                       RequestStorm, VmemShrink)

__all__ = [
    "Fault", "EngineDegrade", "VmemShrink", "DramThrottle",
    "ControllerFallback", "DmaStall", "RequestStorm",
    "FaultEvent", "FaultSchedule", "PlanArgs",
    "generate_schedule", "degraded_plan_args", "plan_args_of",
    "apply_to_plan", "storm_windows",
    "SURVIVING_FRACS", "THROTTLE_FACTORS", "STORM_FACTORS",
    "ChaosReport", "run_chaos", "DEFAULT_AVAILABILITY_FLOOR_PCT",
]
