"""`repro_torch.faults`: the typed fault taxonomy (`models`).

The simulator applies a fault's sim projection inside its epoch window
(``repro_torch.sim.simulate(..., faults=...)``,
``sim.simulate_network(..., faults=...)``): timing and energy change, word
counts never do.

    from repro_torch import faults, sim

    hurt = sim.simulate_network(netp, faults=[faults.DramThrottle(
        start_epoch=0, duration_epochs=100, row_buffer_disabled=True)])
    hurt.as_traffic_report() == netp.simulate().as_traffic_report()

The reference's seeded schedules and degraded re-planning (``inject``), its
chaos harness (``chaos``, ``python -m repro.faults``) and the hardened
planner service that consumes them are not ported yet: ROADMAP A10(b).
"""

from repro_torch.faults.models import (ControllerFallback, DmaStall,
                                       DramThrottle, EngineDegrade, Fault,
                                       FaultEvent, FaultSchedule, PlanArgs,
                                       RequestStorm, VmemShrink)

__all__ = [
    "Fault", "EngineDegrade", "VmemShrink", "DramThrottle",
    "ControllerFallback", "DmaStall", "RequestStorm",
    "FaultEvent", "FaultSchedule", "PlanArgs",
]
