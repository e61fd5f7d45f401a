"""Entry points: `verify`, the inline gate of the ``checked=True`` planning
modes, and `check_plans`, the CLI's sweep over the zoo."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from repro_torch.check.diagnostics import Diagnostic, raise_on_error
from repro_torch.check.kernels import check_network_kernels, same_padded
from repro_torch.check.passes import check
from repro_torch.core.cnn_zoo import PAPER_CNNS
from repro_torch.obs.trace import Stopwatch
from repro_torch.plan.api import coerce_strategy
from repro_torch.plan.schedule import Controller


def verify(obj: object, context: str = "", budget: Optional[int] = None
           ) -> List[Diagnostic]:
    """Check one IR object and raise `CheckError` on errors; returns the
    (warning-only) diagnostics otherwise."""
    diags = check(obj, budget)
    raise_on_error(diags, context or f"verification of "
                                     f"{type(obj).__name__} failed")
    return diags


def check_plans(nets: Sequence[str] = PAPER_CNNS,
                controllers: Sequence[str] = ("passive", "active"),
                strategy: str = "exact_opt",
                budget: Optional[int] = None,
                with_kernels: bool = False,
                ) -> Tuple[List[Diagnostic], dict[str, float]]:
    """Plan every (net, controller) pair and verify the NetPlan end to end.

    Returns (diagnostics, host seconds per "net/controller" subject, each
    timed by a `Stopwatch` spanned as ``check.plans/{net}/{ctrl}``). With
    ``with_kernels=True`` also pre-flights the launch of every dense
    "same"-padded conv node (the others the runner never launches).
    """
    from repro_torch.plan.netplan import plan_graph

    strat = coerce_strategy(strategy)
    diags: List[Diagnostic] = []
    timings: dict[str, float] = {}
    for net in nets:
        for ctrl in controllers:
            with Stopwatch(f"check.plans/{net}/{ctrl}", cat="check") as sw:
                netp = plan_graph(net, budget=budget, strategy=strat,
                                  controller=Controller(ctrl))
                found = check(netp)
                if with_kernels:
                    sub = {n.name: netp.schedules.get(n.name)
                           for n in netp.graph.workload_nodes
                           if n.workload.groups == 1
                           and same_padded(n.workload)}
                    launchable = [n.name for n in netp.graph.workload_nodes
                                  if n.name in sub]
                    found += [d for d in check_network_kernels(netp.graph, sub)
                              if d.subject in launchable
                              and d.code != "RPC033"]
                diags += [Diagnostic(d.code, f"{net}/{ctrl}:{d.subject}",
                                     d.message, d.severity, d.hint, d.file,
                                     d.line) for d in found]
            timings[f"{net}/{ctrl}"] = sw.s
    return diags, timings
