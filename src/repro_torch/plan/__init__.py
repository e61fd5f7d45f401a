"""Planning: choose each workload's schedule and predict its traffic.

    from repro_torch import plan
    p = plan.plan(plan.ConvWorkload(...), 2048, "exact_opt", "active")
    p.schedule.m, p.schedule.n, p.traffic.interconnect_words, p.traffic.bytes
    plan.plan(wl, 2048, checked=True)       # verified by repro_torch.check

    plan.network_traffic("alexnet", 2048, "paper_opt", "passive",
                         paper_convention=True)          # a Table I cell
    plan.dse.sweep(["resnet18"], (512, 2048), ("paper_opt", "exact_opt"),
                   ("passive", "active"))                # tidy rows

    netp = plan.plan_graph("resnet18", 2048, "exact_opt", "active")
    netp.schedules, netp.resident_tensors, netp.saving_pct   # fused plan
    plan.plan_graphs(["alexnet", "resnet18"], 2048)      # a fleet batch
"""

from repro_torch.plan import dse, fleet, graph, netplan, objectives, space
from repro_torch.plan.api import (DEFAULT_P_MACS, Plan, clear_plan_cache,
                                  coerce_strategy, default_budget,
                                  min_network_traffic, network_traffic, plan,
                                  plan_cache_info, plan_many)
from repro_torch.plan.conv_model import optimal_m_realvalued
from repro_torch.plan.dse import (Constraint, SearchResult, StrategySpec,
                                  certify_space, register_strategy,
                                  unregister_strategy)
from repro_torch.plan.gemm_model import LANE, SMEM_BUDGET, SUBLANE, MatmulBlocks
from repro_torch.plan.fleet import plan_graphs
from repro_torch.plan.graph import NetworkGraph, Node, Tensor
from repro_torch.plan.netplan import (DEFAULT_RESIDENCY_BYTES, EdgePlan,
                                      NetPlan, NodePlan, PlanContext,
                                      clear_plan_graph_cache, network_report,
                                      plan_graph, plan_graph_cache_info)
from repro_torch.plan.objectives import (OBJECTIVES, Objective, get_objective,
                                        register_objective)
from repro_torch.plan.planners import (PLANNERS, Planner, get_planner,
                                       register_planner)
from repro_torch.plan.schedule import Controller, Partition, Schedule, Strategy
from repro_torch.plan.space import Candidates, SearchSpace
from repro_torch.plan.traffic import TrafficReport, conv_traffic, traffic_report
from repro_torch.plan.workload import (ConvWorkload, MatmulWorkload, Workload,
                                       conv_workloads, transformer_matmuls)

__all__ = [
    "Plan", "plan", "plan_many", "plan_cache_info", "clear_plan_cache",
    "default_budget", "network_traffic", "min_network_traffic",
    "coerce_strategy",
    "DEFAULT_P_MACS", "SMEM_BUDGET", "LANE", "SUBLANE",
    "Planner", "PLANNERS", "register_planner", "get_planner",
    "Controller", "Partition", "Schedule", "Strategy",
    "TrafficReport", "conv_traffic", "traffic_report", "MatmulBlocks",
    "ConvWorkload", "MatmulWorkload", "Workload", "conv_workloads",
    "transformer_matmuls", "optimal_m_realvalued",
    # design-space exploration (repro_torch.plan.dse)
    "dse", "objectives", "space",
    "Constraint", "SearchResult", "StrategySpec", "certify_space",
    "register_strategy", "unregister_strategy",
    "OBJECTIVES", "Objective", "get_objective", "register_objective",
    "Candidates", "SearchSpace",
    # network-graph planning (repro_torch.plan.graph / .netplan)
    "graph", "netplan", "NetworkGraph", "Node", "Tensor",
    "NetPlan", "NodePlan", "EdgePlan", "plan_graph", "network_report",
    "DEFAULT_RESIDENCY_BYTES",
    # fleet planning (repro_torch.plan.fleet)
    "fleet", "plan_graphs", "PlanContext",
    "plan_graph_cache_info", "clear_plan_graph_cache",
]
