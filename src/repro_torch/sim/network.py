"""Whole-network simulation over a planned `NetworkGraph` / `NetPlan`.

Each workload node runs through the single-workload simulator with the
residency assignment threaded in exactly the way the analytical
``netplan.network_report`` counts it: a resident input edge is read from the
engine-side residency buffer (an SRAM access, no DRAM fetch, no bus words),
a resident output keeps the whole psum stream off the interconnect. Virtual
ops (pool / add / input / ...) move no modelled traffic, matching the
analytical convention — so the merged report's word totals equal
``network_report`` exactly, which the test suite asserts on the full zoo.

Nodes execute sequentially (the engine is one accelerator): cycles add,
per-phase timelines chain in topological order.
"""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Any, Sequence

from repro_torch.plan.graph import NetworkGraph
from repro_torch.plan.netplan import NetPlan
from repro_torch.plan.schedule import Controller, Schedule
from repro_torch.plan.workload import Workload
from repro_torch.sim.engine import epoch_count, simulate
from repro_torch.sim.params import DEFAULT_PARAMS, SimParams
from repro_torch.sim.report import SimReport, merge_reports

if TYPE_CHECKING:
    from repro_torch.faults.models import Fault

__all__ = ["simulate_network", "node_report_cache_info",
           "clear_node_report_cache"]


# Per-node report cache: every argument is a frozen dataclass (or scalar, or
# a tuple of frozen fault dataclasses), so the key is exact, and `SimReport`
# is immutable, so sharing one instance across callers is safe. Repeated
# network sweeps (controller comparisons, netplan baselines) hit the same
# node reports instead of re-walking the epoch classes; the common
# un-faulted path keys on ``faults=()``.
@functools.lru_cache(maxsize=4096)
def _node_report(workload: Workload, schedule: Schedule, params: SimParams,
                 spilled: int, out_spilled: bool, name: str,
                 faults: "tuple[Fault, ...]" = ()) -> SimReport:
    return simulate(workload, schedule, params, spilled_in_words=spilled,
                    out_spilled=out_spilled, name=name, faults=faults)


def node_report_cache_info() -> Any:
    return _node_report.cache_info()


def clear_node_report_cache() -> None:
    _node_report.cache_clear()


def simulate_network(plan_or_graph: "NetPlan | NetworkGraph",
                     schedules: dict[str, Schedule] | None = None,
                     resident: frozenset[str] = frozenset(),
                     params: SimParams | None = None,
                     faults: "Sequence[Fault] | None" = None) -> SimReport:
    """Simulate a planned network.

    Pass a `NetPlan` (schedules + residency travel with it), or a
    `NetworkGraph` plus an explicit ``schedules`` dict and ``resident``
    tensor set (the ``amc.run_network`` calling convention).

    ``faults`` are transient machine faults whose epoch windows are expressed
    on the *network-global* epoch index (nodes execute sequentially, so node
    k's local epoch 0 sits at the sum of all earlier nodes' epoch counts);
    each node sees the faults shifted into its own frame. Faults change
    timing and energy only — the merged word totals stay equal to
    ``network_report`` bit-for-bit.
    """
    if isinstance(plan_or_graph, NetPlan):
        if schedules is not None:
            raise TypeError("pass schedules either via the NetPlan or "
                            "explicitly, not both")
        graph = plan_or_graph.graph
        schedules = plan_or_graph.schedules
        resident = plan_or_graph.resident_tensors
    else:
        graph = plan_or_graph
        if schedules is None:
            raise TypeError("a bare NetworkGraph needs an explicit "
                            "schedules= dict")
    params = DEFAULT_PARAMS if params is None else params
    resident = frozenset(resident)
    faults = tuple(faults) if faults else ()

    reports: list[SimReport] = []
    offset = 0
    for node in graph.workload_nodes:
        sched = schedules[node.name]
        spilled = sum(graph.tensors[t].words for t in node.ins
                      if t not in resident)
        node_epochs = epoch_count(node.workload, sched) if faults else 0
        # Shift each global fault window into this node's local epoch frame
        # and drop faults that cannot overlap it — keeps the per-node cache
        # key the healthy ``()`` wherever the fault is not actually active.
        local = tuple(f.shifted(-offset) for f in faults
                      if f.window(offset + node_epochs)[1] > offset
                      and f.window(offset + node_epochs)[0] < offset
                      + node_epochs)
        reports.append(_node_report(
            node.workload, sched, params, spilled,
            node.out not in resident, node.name, local))
        offset += node_epochs
    # Label like amc.run_network: active if any node runs active.
    controller = (Controller.ACTIVE
                  if any(r.controller is Controller.ACTIVE for r in reports)
                  else Controller.PASSIVE)
    return merge_reports(graph.name, controller, params, reports)
