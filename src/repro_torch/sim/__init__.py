"""`repro_torch.sim` — a cycle-approximate memory-hierarchy & interconnect
simulator that validates and extends the first-order model.

The analytical pipeline (`repro_torch.plan`) counts words moved per eqs 1-7; this
package models what those words *cost* on the paper's SoC: a DRAM/HBM channel
with burst-size and open-page (row-buffer) accounting, banked SRAMs with
read/write ports, a double-buffered DMA prefetcher, and the passive vs.
active memory controller as a port policy (Section III). Word totals are
exact — cross-validated against `TrafficReport` / ``network_report`` and the
instrumented ``core.amc`` meters — while timing, bandwidth, row-miss,
bank-conflict, and energy numbers are the second-order signal the word count
cannot express.

    from repro_torch import sim, plan

    wl = plan.conv_workloads("resnet18")[5]
    p = plan.plan(wl, 2048, "exact_opt", "active")
    rep = sim.simulate(wl, p.schedule)
    rep.latency_s, rep.peak_bw_bytes_s, rep.row_misses, rep.energy_pj

    netp = plan.plan_graph("resnet18", 2048, "exact_opt", "active")
    sim.simulate_network(netp).summary()

Importing this package registers ``sim_latency`` / ``sim_energy`` as DSE
objectives *and* strategies, so ``plan.plan(wl, strategy="sim_latency")`` and
``dse.sweep(..., objective="sim_energy")`` rank candidates by simulated cost.
Both objectives run at grid rate through the batched evaluator
(``sim.simulate_batch``): the whole candidate grid is costed in one
closed-form array pass that matches scalar ``simulate()`` float-exactly, and
``plan.plan_graph(..., objective="sim_latency")`` scores its beam states with
the same batched per-node evaluations. ``sim.simulate_batch(..., xp=torch,
device="cuda")`` evaluates the same closed form on the card in float64.

Every time and energy here is the model's, of the paper's SoC at its 1 GHz
clock (`SimParams`), not a measurement of the card the port's kernels run
on; the card's own roofline is `repro_torch.roofline.constants`.
"""

from repro_torch.sim import objectives  # noqa: F401  (registers sim_* strategies)
from repro_torch.sim.batch import BatchSimResult, simulate_batch
from repro_torch.sim.energy import (ENERGY_PJ_DRAM_BYTE, ENERGY_PJ_DRAM_ROW_ACT,
                              ENERGY_PJ_INTERCONNECT_BYTE,
                              ENERGY_PJ_SRAM_BYTE, energy_breakdown)
from repro_torch.sim.engine import simulate
from repro_torch.sim.network import (clear_node_report_cache,
                               node_report_cache_info, simulate_network)
from repro_torch.sim.objectives import (SimObjective, make_sim_objective,
                                  register_sim_strategies,
                                  scalar_sim_objective, sim_energy,
                                  sim_latency)
from repro_torch.sim.params import (DEFAULT_PARAMS, DramParams, SimParams,
                              SramParams)
from repro_torch.sim.report import Phase, SimReport, merge_reports

__all__ = [
    "simulate", "simulate_network", "simulate_batch", "BatchSimResult",
    "node_report_cache_info", "clear_node_report_cache",
    "SimParams", "DramParams", "SramParams", "DEFAULT_PARAMS",
    "SimReport", "Phase", "merge_reports",
    "sim_latency", "sim_energy", "SimObjective", "make_sim_objective",
    "scalar_sim_objective", "register_sim_strategies",
    "energy_breakdown", "ENERGY_PJ_DRAM_BYTE", "ENERGY_PJ_DRAM_ROW_ACT",
    "ENERGY_PJ_INTERCONNECT_BYTE", "ENERGY_PJ_SRAM_BYTE",
]
