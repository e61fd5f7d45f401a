"""Planning: choose each workload's schedule and predict its word traffic.

    from repro_torch import plan
    p = plan.plan(plan.ConvWorkload(...), 2048, "exact_opt", "active")
    p.schedule.m, p.schedule.n, p.traffic.interconnect_words
"""

from repro_torch.plan.api import (DEFAULT_P_MACS, Plan, default_budget, plan,
                                  plan_many)
from repro_torch.plan.gemm_model import SMEM_BUDGET
from repro_torch.plan.graph import NetworkGraph, Node, Tensor
from repro_torch.plan.schedule import Controller, Schedule, Strategy
from repro_torch.plan.traffic import TrafficReport, conv_traffic, traffic_report
from repro_torch.plan.workload import (ConvWorkload, MatmulWorkload, Workload,
                                       conv_workloads)

__all__ = [
    "DEFAULT_P_MACS", "SMEM_BUDGET", "Plan",
    "default_budget", "plan", "plan_many", "NetworkGraph", "Node", "Tensor",
    "Controller", "Schedule", "Strategy", "TrafficReport", "conv_traffic",
    "traffic_report", "ConvWorkload", "MatmulWorkload", "Workload",
    "conv_workloads",
]
