"""Network-level partition planner: a thin wrapper over `repro_torch.plan`.

``plan_network`` plans every layer of a CNN (or any list of conv layers) and
emits, per layer, the chosen `Schedule`, its iteration counts and its
interconnect words under both controllers, with network totals. The
per-layer answer is the independent-layer (``no_fusion``) baseline of the
graph planner (`plan.netplan`); the result carries the graph's feature-map
edges, and ``residency_bytes > 0`` attaches the fused-residency `NetPlan`.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.cnn_zoo import ConvLayer
from repro_torch.plan import netplan as _netplan
from repro_torch.plan.graph import NetworkGraph
from repro_torch.plan.netplan import EdgePlan, NetPlan
from repro_torch.plan.schedule import Controller, Partition, Schedule, Strategy
from repro_torch.plan.traffic import traffic_report


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    layer: ConvLayer
    schedule: Schedule
    in_iters: int
    out_iters: int
    bw_passive: float
    bw_active: float

    @property
    def partition(self) -> Partition:
        """The schedule as the paper's (m, n) partition."""
        return self.schedule.as_partition()

    @property
    def saving_pct(self) -> float:
        if self.bw_passive == 0:
            return 0.0
        return 100.0 * (1.0 - self.bw_active / self.bw_passive)


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    name: str
    p_macs: int
    strategy: str
    layers: tuple[LayerPlan, ...]
    # the feature-map edges with their planned traffic and residency, and
    # the fused-residency plan when one was asked for
    edges: tuple[EdgePlan, ...] = ()
    residency_bytes: int = 0
    fused: NetPlan | None = None

    @property
    def total_passive(self) -> float:
        return sum(lp.bw_passive for lp in self.layers)

    @property
    def total_active(self) -> float:
        return sum(lp.bw_active for lp in self.layers)

    @property
    def saving_pct(self) -> float:
        if self.total_passive == 0:
            return 0.0
        return 100.0 * (1.0 - self.total_active / self.total_passive)

    @property
    def total_fused(self) -> float:
        """Fused-residency network words (the no-fusion total when no
        residency budget was given)."""
        if self.fused is None:
            return self.total_passive
        return self.fused.total_words

    def report(self) -> str:
        lines = [f"# plan: {self.name} @ P={self.p_macs} strategy={self.strategy}",
                 f"{'layer':<28}{'m':>5}{'n':>5}{'it_in':>6}{'it_out':>7}"
                 f"{'BW passive':>14}{'BW active':>14}{'save%':>7}"]
        for lp in self.layers:
            lines.append(f"{lp.layer.name:<28}{lp.schedule.m:>5}{lp.schedule.n:>5}"
                         f"{lp.in_iters:>6}{lp.out_iters:>7}"
                         f"{lp.bw_passive:>14.3e}{lp.bw_active:>14.3e}"
                         f"{lp.saving_pct:>7.1f}")
        lines.append(f"{'TOTAL':<28}{'':>23}{self.total_passive:>14.3e}"
                     f"{self.total_active:>14.3e}{self.saving_pct:>7.1f}")
        if self.fused is not None:
            lines.append(
                f"fused-residency ({self.residency_bytes / 2**20:.1f}MiB): "
                f"{self.fused.total_words:.3e} words "
                f"({self.fused.saving_pct:.1f}% off the no-fusion baseline, "
                f"{sum(1 for e in self.edges if e.resident)}/{len(self.edges)}"
                f" edges resident)")
        return "\n".join(lines)


def plan_network(name_or_layers, p_macs: int,
                 strategy: "str | Strategy" = "paper_opt",
                 residency_bytes: int = 0) -> NetworkPlan:
    """Plan every layer of a network: a CNN name of
    `repro_torch.core.cnn_zoo` or any iterable of `ConvLayer`s.

    The per-layer numbers are the independent-layer answer: one schedule a
    layer, chosen under the passive controller as in the paper, with its
    words under both controllers. ``residency_bytes > 0`` also runs the
    fused-residency graph planner and attaches it as ``.fused``; the edge
    columns always come from the network graph.
    """
    strategy = Strategy.coerce(strategy)
    if isinstance(name_or_layers, str):
        graph = NetworkGraph.from_cnn(name_or_layers)
    else:
        graph = NetworkGraph.from_layers(list(name_or_layers))

    netp = _netplan.plan_graph(graph, p_macs, strategy, Controller.PASSIVE,
                               residency_bytes=residency_bytes)
    plans = []
    for wl, pp in zip(graph.workloads, netp.baseline):
        sched = pp.schedule
        active_sched = dataclasses.replace(sched, controller=Controller.ACTIVE)
        bw_active = traffic_report(wl, active_sched,
                                   exact_iters=True).interconnect_words
        mg, ng = wl.cin // wl.groups, wl.cout // wl.groups
        plans.append(LayerPlan(
            layer=wl.to_layer(), schedule=sched,
            in_iters=math.ceil(mg / min(sched.m, mg)),
            out_iters=math.ceil(ng / min(sched.n, ng)),
            bw_passive=pp.traffic.interconnect_words,
            bw_active=bw_active))
    return NetworkPlan(name=graph.name, p_macs=p_macs, strategy=strategy.value,
                       layers=tuple(plans), edges=netp.edges,
                       residency_bytes=int(residency_bytes),
                       fused=netp if residency_bytes > 0 else None)
