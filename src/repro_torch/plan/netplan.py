"""Network-level planner: per-node schedules + fused-residency edges.

The per-layer pipeline minimizes each layer's eq-(2)+(3) traffic in
isolation, so the feature map layer *i* ships out and layer *i+1* ships
back in counts as unavoidable. This module plans the whole `NetworkGraph`:

  * every producer->consumer **edge** is modelled: a consumer re-reads each
    input tensor once per output block (``S_e * ceil(N/n)`` words for convs,
    ``S_e * ceil(N/bn)`` for GEMMs), which is how eq (2) decomposes over the
    input tensors;
  * an edge whose tensor fits the **residency budget** (an engine-side
    buffer of the paper's SoC) can be held *resident* for its whole live
    interval: its producer's eq-(3) output traffic and its consumers' share
    of eq (2) stay off the bus. Local accesses are still counted: like the
    active controller, residency moves words off the interconnect, it does
    not remove the work;
  * schedules and residency are chosen jointly by a beam search (DP over the
    topological order, states deduplicated on the live resident set); for a
    fixed residency assignment the per-node optimum is one masked argmin over
    the same `repro_torch.plan.dse` candidate grids ``plan()`` searches.

The all-spilled assignment is the independent-layer answer: `NetPlan.baseline`
is ``plan_many``'s result, the ``no_fusion`` reference.

Each beam step scores its whole state frontier in one vectorized call
(`_NodeGrid.score_frontier`, or `_SimNodeGrid`'s batched simulation when the
beam minimizes simulated cost); a `PlanContext` memoizes candidate grids,
per-layer baseline schedules, residency-adjusted reports and sim
evaluations on name-stripped workload shapes; repeated ``plan_graph`` calls hit a graph-level LRU
(`plan_graph_cache_info` / `clear_plan_graph_cache`); and
:meth:`NetPlan.replan` re-plans under a changed budget, residency or graph
from the first step that differs, equal to a fresh ``plan_graph``.

The residency budget models the SoC's buffer, not the card: the kernels
write every feature map to device memory whatever the plan holds resident.
Every total carries its bytes beside its words (`TrafficReport.bytes`), and
``checked=True`` runs the `repro_torch.check` NetPlan verifier on the
result, and `NetPlan.simulate` runs the plan through the SoC simulator
(`repro_torch.sim`), whose word totals equal `NetPlan.traffic`.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np

from repro_torch.errors import BudgetError, PlanError
from repro_torch.obs.metrics import REGISTRY, StatsCounter
from repro_torch.obs.trace import span
from repro_torch.plan import api as _api
from repro_torch.plan import conv_model, dse, gemm_model
from repro_torch.plan.graph import NetworkGraph, Node
from repro_torch.plan.schedule import Controller, Schedule, Strategy
from repro_torch.plan.traffic import TrafficReport, traffic_report
from repro_torch.plan.units import nbytes
from repro_torch.plan.workload import ConvWorkload, MatmulWorkload

# Engine-side residency buffer (bytes) for holding inter-layer feature maps
# on chip: a few MiB of SRAM, the scale of the paper's SoC.
DEFAULT_RESIDENCY_BYTES = 2 * 2**20
DEFAULT_BEAM_WIDTH = 8

# Distinguishes "argument not passed" from an explicit None in replan().
_UNSET = object()


# ------------------------------------------------------- shared memoization
def _shape_key(wl):
    """The workload with its name stripped: two layers of the same shape are
    the same planning problem, so every cross-network memo keys on this."""
    return dataclasses.replace(wl, name="")


def _grid_objective_key(sim_obj) -> tuple:
    """Hashable identity of a sim objective for grid and baseline memo keys:
    a `SimObjective`'s behaviour is fixed by (type, metric, params)."""
    return (type(sim_obj).__qualname__, sim_obj.metric, sim_obj.params)


class PlanContext:
    """Cross-call memoization shared by `plan_graph`, `NetPlan.replan` and
    `repro_torch.plan.fleet.plan_graphs`.

    One context is one planning session (a fleet batch or a single
    ``plan_graph`` call). All memos key on name-stripped workload shapes, so
    two nodes, in one network or across a fleet, that share a shape share
    candidate grids, per-layer baseline schedules and residency-adjusted
    traffic reports and sim-objective grid evaluations. ``stats`` counts hits
    and misses per memo; it is a
    `collections.Counter` whose increments also roll up into the
    process-wide ``plan_context_stats{key=...}`` metrics.
    """

    def __init__(self) -> None:
        self.grids: dict = {}       # grid key -> _NodeGrid | _SimNodeGrid
        self.scheds: dict = {}      # baseline key -> (Schedule, TrafficReport)
        self.reports: dict = {}     # bus-report key -> TrafficReport
        self.stats: collections.Counter = StatsCounter()
        self._shapes: dict = {}     # workload -> name-stripped workload
        self._graphs: dict = {}     # zoo CNN name -> NetworkGraph

    def shape_of(self, wl):
        key = self._shapes.get(wl)
        if key is None:
            key = self._shapes[wl] = _shape_key(wl)
        return key

    def graph_of(self, graph_or_name) -> NetworkGraph:
        """`_coerce_graph` with zoo-name memoization: a fleet batch naming
        the same CNN repeatedly builds its graph once per context."""
        if isinstance(graph_or_name, str):
            hit = self._graphs.get(graph_or_name)
            if hit is None:
                hit = self._graphs[graph_or_name] = \
                    NetworkGraph.from_cnn(graph_or_name)
            return hit
        return _coerce_graph(graph_or_name)

    def grid(self, wl, budget, strategy, controller: Controller, sim_obj):
        """The node grid for one workload shape, built once per context."""
        b = _api.default_budget(wl) if budget is None else int(budget)
        name = (strategy.value if isinstance(strategy, Strategy)
                else str(strategy))
        obj_key = None if sim_obj is None else _grid_objective_key(sim_obj)
        key = (self.shape_of(wl), b, name, controller, obj_key)
        hit = self.grids.get(key)
        if hit is not None:
            self.stats["grid_hits"] += 1
            return hit
        self.stats["grid_misses"] += 1
        wl_s = self.shape_of(wl)
        if sim_obj is not None:
            cands, mask, _ = _node_candidates(wl_s, budget, strategy,
                                              controller)
            grid: "_NodeGrid | _SimNodeGrid" = _SimNodeGrid(
                wl=wl_s, cands=cands, mask=mask, controller=controller,
                objective=sim_obj, stats=self.stats)
        else:
            grid = _node_grid(wl_s, budget, strategy, controller)
        self.grids[key] = grid
        return grid

    def bus_report(self, wl, schedule: Schedule, spilled_in_words: int,
                   out_spilled: bool) -> TrafficReport:
        key = (self.shape_of(wl), schedule, spilled_in_words, out_spilled)
        hit = self.reports.get(key)
        if hit is not None:
            self.stats["report_hits"] += 1
            return hit
        self.stats["report_misses"] += 1
        rep = _node_bus_report(wl, schedule, spilled_in_words, out_spilled)
        self.reports[key] = rep
        return rep


# ----------------------------------------------------------- per-node grids
@dataclasses.dataclass(frozen=True)
class _NodeGrid:
    """Vectorized per-candidate cost pieces for one workload node.

    For a residency state with ``A`` spilled input words, the node's bus cost
    over the candidate grid is ``A * read_iters + fixed + spill * out_traffic``
    (conv: fixed = 0, out_traffic = eq-3 B_o; GEMM: fixed = weight reads,
    out_traffic = the C-tile traffic). The all-spilled cost with A = all input
    words is the per-layer objective ``plan()`` minimizes.
    """

    cands: dse.Candidates
    mask: np.ndarray
    read_iters: np.ndarray     # int64: input re-reads per candidate
    fixed: np.ndarray          # float64: bus words independent of residency
    #   (+inf on mask-infeasible candidates, so plain argmin skips them)
    out_traffic: np.ndarray    # float64: output words, elided when resident

    def best(self, spilled_in_words: int, out_spilled: bool
             ) -> tuple[int, float]:
        cost = spilled_in_words * self.read_iters + self.fixed
        if out_spilled:
            cost = cost + self.out_traffic
        i = int(np.argmin(np.where(self.mask, cost, np.inf)))
        return i, float(cost[i])

    def score_frontier(self, spilled: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray]:
        """(idx_spill, cost_spill, idx_resident, cost_resident) over a whole
        state frontier: one argmin per out-spilled variant on the
        ``(states, candidates)`` cost matrix. Row ``i`` equals
        ``best(spilled[i], ...)`` bit for bit: the rows do the same float64
        operations in the same order, and ``np.argmin`` along the candidate
        axis keeps the same first-minimum tie-break."""
        cost_r = spilled[:, None] * self.read_iters + self.fixed
        cost_s = cost_r + self.out_traffic
        rows = np.arange(len(spilled))
        # ``fixed`` carries +inf on infeasible candidates, so the plain
        # argmin is the masked argmin (same first-minimum tie-break).
        idx_s = np.argmin(cost_s, axis=1)
        idx_r = np.argmin(cost_r, axis=1)
        return (idx_s, cost_s[rows, idx_s].astype(np.float64),
                idx_r, cost_r[rows, idx_r].astype(np.float64))


def _node_candidates(wl, budget: int | None, strategy, controller: Controller):
    """(cands, mask, kind): the strategy preset's feasible candidate grid for
    one workload node, with the space's fallback taken when nothing is
    feasible; shared by the word-count and the simulated-cost node grids."""
    budget = _api.default_budget(wl) if budget is None else int(budget)
    kind = "conv" if isinstance(wl, ConvWorkload) else "matmul"
    spec = dse.strategy_spec(strategy, kind)
    cands = spec.space(wl, budget)
    mask = np.ones(len(cands), dtype=bool)
    for c in spec.constraints:
        mask &= c(wl, cands, budget)
    if not mask.any():
        fallback = getattr(spec.space, "fallback", None)
        if fallback is None:
            raise BudgetError(
                f"no feasible candidate for {wl!r} at {budget}")
        cands = fallback(wl, budget)
        mask = np.ones(len(cands), dtype=bool)
    return cands, mask, kind


def _node_grid(wl, budget: int | None, strategy,
               controller: Controller) -> _NodeGrid:
    cands, mask, kind = _node_candidates(wl, budget, strategy, controller)
    if kind == "conv":
        ng = wl.cout // wl.groups
        read_iters = -(-ng // np.minimum(cands.bn, ng))
        _, b_o = conv_model.conv_bandwidth_grid(wl, cands.bm, cands.bn,
                                                controller, exact_iters=True)
        fixed = np.zeros(len(cands), dtype=np.float64)
        out_traffic = b_o
    else:
        t = gemm_model.matmul_traffic_grid(wl.m, wl.n, wl.k, cands.bm,
                                           cands.bn, cands.bk, controller)
        read_iters = -(-wl.n // np.asarray(cands.bn, np.int64))
        fixed = t["b_reads"]
        out_traffic = t["c_traffic"]
    fixed = np.where(mask, fixed, np.inf)
    return _NodeGrid(cands=cands, mask=mask, read_iters=read_iters,
                     fixed=fixed, out_traffic=out_traffic)


@dataclasses.dataclass(eq=False)
class _SimNodeGrid:
    """Simulated-cost analogue of `_NodeGrid`: the node's cost over the
    candidate grid is a batched ``simulate_batch`` evaluation under the beam
    state's residency (``spilled_in_words`` / ``out_spilled``), cached per
    residency key. Grids are shared through a `PlanContext`, so beam states
    of one network or of a whole fleet that agree on a node shape's spilled
    words share one evaluation; a frontier's missing keys are evaluated in
    one vector-``spilled_in_words`` batch call."""

    wl: "ConvWorkload | MatmulWorkload"
    cands: dse.Candidates
    mask: np.ndarray
    controller: Controller
    objective: object                  # repro_torch.sim.SimObjective
    stats: collections.Counter | None = None
    _cache: dict = dataclasses.field(default_factory=dict)

    def _ensure(self, spills, out_spilled: bool) -> None:
        """Evaluate every (spilled, out_spilled) key not yet cached, all of
        them in one batched simulate call."""
        missing = sorted({int(s) for s in spills
                          if (int(s), out_spilled) not in self._cache})
        if self.stats is not None:
            self.stats["sim_eval_misses"] += len(missing)
        if not missing:
            return
        if self.stats is not None:
            self.stats["sim_batch_calls"] += 1
        vec = np.asarray(missing, dtype=np.int64)
        with span("sim.eval_batch", cat="plan", node=self.wl.name or "shape",
                  states=len(missing), candidates=len(self.cands),
                  out_spilled=out_spilled):
            res = self.objective.batch(self.wl, self.cands, self.controller,
                                       spilled_in_words=vec,
                                       out_spilled=out_spilled)
        cost = np.asarray(res.metric(self.objective.metric), dtype=np.float64)
        if cost.ndim == 1:      # spill-independent metric: every row equal
            cost = np.broadcast_to(cost, (len(missing), cost.size))
        idx = np.argmin(np.where(self.mask, cost, np.inf), axis=1)
        for r, s in enumerate(missing):
            self._cache[(s, out_spilled)] = (int(idx[r]),
                                             float(cost[r, idx[r]]))

    def best(self, spilled_in_words: int, out_spilled: bool
             ) -> tuple[int, float]:
        key = (int(spilled_in_words), out_spilled)
        hit = self._cache.get(key)
        if hit is not None:
            if self.stats is not None:
                self.stats["sim_eval_hits"] += 1
            return hit
        self._ensure((spilled_in_words,), out_spilled)
        return self._cache[key]

    def score_frontier(self, spilled: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray]:
        """Frontier scoring through the shared residency-key cache; rows
        equal per-state ``best`` calls (the same cached scalars)."""
        keys = [int(s) for s in spilled]
        out: list[np.ndarray] = []
        for out_spilled in (True, False):
            # A requested key is a hit unless it forced a fresh evaluation:
            # rows that agree on spilled words, within one network's
            # frontier or across a fleet bucket's concatenated frontiers,
            # share the one cached evaluation.
            before = (self.stats["sim_eval_misses"]
                      if self.stats is not None else 0)
            self._ensure(keys, out_spilled)
            if self.stats is not None:
                fresh = self.stats["sim_eval_misses"] - before
                self.stats["sim_eval_hits"] += len(keys) - fresh
            pairs = [self._cache[(k, out_spilled)] for k in keys]
            out.append(np.asarray([p[0] for p in pairs], dtype=np.int64))
            out.append(np.asarray([p[1] for p in pairs], dtype=np.float64))
        return out[0], out[1], out[2], out[3]


def _resolve_sim_objective(strategy, objective):
    """A `repro_torch.sim.SimObjective` when the beam should score with
    simulated cost, else None (word-count planning).

    ``objective=None`` inherits the strategy's own scoring: a ``sim_*``
    strategy plans its per-layer searches by simulated cost, so the network
    beam does too. An explicit objective must be a sim objective
    (``"sim_latency"`` / ``"sim_energy"`` / a ``make_sim_objective`` result)
    or ``"interconnect_words"`` (the word-count default): other word
    objectives do not decompose over the residency states the beam explores.
    """
    name = strategy.value if isinstance(strategy, Strategy) else str(strategy)
    if objective is None and not name.startswith("sim_"):
        return None
    if isinstance(objective, str) and objective == "interconnect_words":
        return None
    from repro_torch.plan.objectives import get_objective
    from repro_torch.sim.objectives import SimObjective
    if isinstance(objective, SimObjective):
        return objective
    try:
        obj = get_objective(objective if objective is not None else name)
    except KeyError:
        obj = None
    if isinstance(obj, SimObjective):
        return obj
    if objective is None:       # a custom "sim_"-named, non-sim strategy
        return None
    raise PlanError(
        f"plan_graph objective {objective!r} is not a sim objective; pass "
        f"'sim_latency', 'sim_energy', a make_sim_objective(...) instance, "
        f"or 'interconnect_words' (the word-count default)")


# ------------------------------------------------------- analytical totals
def _node_bus_report(wl, schedule: Schedule, spilled_in_words: int,
                     out_spilled: bool) -> TrafficReport:
    """Residency-adjusted `TrafficReport` for one node: interconnect words
    drop the resident shares; local (SRAM + residency buffer) accesses match
    the per-layer model unchanged."""
    if isinstance(wl, ConvWorkload):
        b_i, b_o = conv_model.conv_bandwidth(wl, schedule.m, schedule.n,
                                             schedule.controller,
                                             exact_iters=True)
        g = wl.groups
        mg, ng = wl.cin // g, wl.cout // g
        out_iters = math.ceil(ng / min(schedule.n, ng))
        in_iters = math.ceil(mg / min(schedule.m, mg))
        in_bus = float(spilled_in_words * out_iters)
        out_bus = b_o if out_spilled else 0.0
        sram_reads = b_i + (in_iters - 1) * wl.out_acts
        sram_writes = float(in_iters * wl.out_acts)
        word_bytes = wl.word_bytes
    elif isinstance(wl, MatmulWorkload):
        t = gemm_model.matmul_traffic(wl.m, wl.n, wl.k, schedule,
                                      schedule.controller)
        gj = math.ceil(wl.n / schedule.bn)
        gk = math.ceil(wl.k / schedule.bk)
        in_bus = float(spilled_in_words * gj + t["b_reads"])
        out_bus = t["c_traffic"] if out_spilled else 0.0
        acc = wl.m * wl.n
        sram_reads = float((gk - 1) * acc)
        sram_writes = float(gk * acc)
        word_bytes = wl.in_dtype.itemsize
    else:
        raise TypeError(f"unknown workload {type(wl).__name__}")
    total = in_bus + out_bus
    return TrafficReport(interconnect_words=total, input_words=in_bus,
                         output_words=out_bus, sram_reads=sram_reads,
                         sram_writes=sram_writes,
                         bytes=nbytes(total, word_bytes))


def network_report(graph: NetworkGraph, schedules: dict[str, Schedule],
                   resident=frozenset(), *,
                   context: PlanContext | None = None) -> TrafficReport:
    """Analytical network totals for (schedules, residency assignment): the
    quantity `repro_torch.core.amc.run_network` meters word for word. With
    an empty resident set this is the sum of the per-layer reports.
    ``context`` optionally memoizes the per-node reports across calls."""
    resident = frozenset(resident)
    totals = np.zeros(6, dtype=np.float64)
    for node in graph.workload_nodes:
        spilled = sum(graph.tensors[t].words for t in node.ins
                      if t not in resident)
        out_spilled = node.out not in resident
        if context is not None:
            rep = context.bus_report(node.workload, schedules[node.name],
                                     spilled, out_spilled)
        else:
            rep = _node_bus_report(node.workload, schedules[node.name],
                                   spilled, out_spilled)
        totals += np.asarray([rep.interconnect_words, rep.input_words,
                              rep.output_words, rep.sram_reads,
                              rep.sram_writes, rep.bytes])
    return TrafficReport(*totals)


# ------------------------------------------------------------------ results
@dataclasses.dataclass(frozen=True)
class NodePlan:
    """One planned graph node (virtual ops carry no schedule/traffic)."""

    name: str
    op: str
    workload: "ConvWorkload | MatmulWorkload | None"
    schedule: Schedule | None
    traffic: TrafficReport | None       # residency-adjusted bus traffic


@dataclasses.dataclass(frozen=True)
class EdgePlan:
    """One feature-map edge with its planned traffic and residency."""

    tensor: str
    words: int
    nbytes: int
    producer: str
    consumers: tuple[str, ...]
    resident: bool
    read_words: float      # consumer-side interconnect words (0 if resident)
    write_words: float     # producer-side output interconnect words
    saved_words: float     # words kept off the bus vs spilling this edge


@dataclasses.dataclass(frozen=True)
class NetPlan:
    """A planned network graph: schedules, residency and totals.

    ``baseline`` is the independent-layer answer (``plan_many``), the
    ``no_fusion`` reference; ``traffic`` is the fused-residency total.
    ``run_network_kernels`` takes a NetPlan and runs its ``schedules``.
    """

    graph: NetworkGraph
    budget: int | None
    strategy: str
    controller: Controller
    residency_bytes: int
    beam_width: int
    nodes: tuple[NodePlan, ...]
    edges: tuple[EdgePlan, ...]
    traffic: TrafficReport
    baseline: tuple[_api.Plan, ...]
    peak_resident_bytes: int
    # Replay handle for incremental re-planning (PlanContext + beam trace);
    # excluded from equality/repr so plans compare on their content.
    _replay: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def schedules(self) -> dict[str, Schedule]:
        return {n.name: n.schedule for n in self.nodes
                if n.schedule is not None}

    @property
    def resident_tensors(self) -> frozenset[str]:
        return frozenset(e.tensor for e in self.edges if e.resident)

    @property
    def total_words(self) -> float:
        return self.traffic.interconnect_words

    @property
    def baseline_words(self) -> float:
        """The ``no_fusion`` network total: the per-layer sum."""
        return sum(p.traffic.interconnect_words for p in self.baseline)

    @property
    def saving_pct(self) -> float:
        if self.baseline_words == 0:
            return 0.0
        return 100.0 * (1.0 - self.total_words / self.baseline_words)

    def simulate(self, params=None):
        """Run this plan through the SoC simulator: a
        `repro_torch.sim.SimReport` whose word totals equal `traffic`, plus
        the modelled SoC's time, bandwidth and energy, which the word counts
        cannot express."""
        from repro_torch.sim import simulate_network
        return simulate_network(self, params=params)

    def replan(self, budget: Any = _UNSET, residency_bytes: Any = _UNSET,
               subgraph: Any = None, beam_width: Any = _UNSET, *,
               checked: bool = False) -> "NetPlan":
        """Re-plan under changed parameters or a modified graph, equal to a
        fresh ``plan_graph``.

        Omitted arguments keep this plan's values; ``subgraph`` supplies a
        replacement `NetworkGraph` (or anything ``plan_graph`` accepts). The
        replay reuses this plan's `PlanContext` and, when only the graph
        changed, resumes the beam from the first step whose (node, output
        tensor, live range, residability) differs, from the recorded state
        frontier. Everything the beam transition at step *i* reads is fixed
        by those per-step invariants, so the resumed search is the fresh one.
        ``checked=True`` verifies the result as `plan_graph` does.
        """
        return _verified(_replan(self, budget, residency_bytes, subgraph,
                                 beam_width), checked)

    def report(self) -> str:
        lines = [f"# netplan: {self.graph.name} strategy={self.strategy} "
                 f"controller={self.controller.value} "
                 f"residency={self.residency_bytes / 2**20:.1f}MiB",
                 f"{'edge':<34}{'words':>10}{'KiB':>8}{'resident':>9}"
                 f"{'bus words':>12}{'saved':>12}"]
        for e in self.edges:
            lines.append(f"{e.tensor:<34}{e.words:>10}{e.nbytes / 1024:>8.0f}"
                         f"{'yes' if e.resident else 'no':>9}"
                         f"{e.read_words + e.write_words:>12.3e}"
                         f"{e.saved_words:>12.3e}")
        lines.append(
            f"{'TOTAL':<34}{'':>27}{self.total_words:>12.3e}"
            f"{self.baseline_words - self.total_words:>12.3e}")
        lines.append(f"no_fusion={self.baseline_words:.3e} words   "
                     f"fused={self.total_words:.3e} words   "
                     f"saving={self.saving_pct:.1f}%   "
                     f"peak_resident={self.peak_resident_bytes / 2**20:.2f}MiB")
        return "\n".join(lines)


# -------------------------------------------------------------- beam search
class _State(NamedTuple):
    cost: float
    bytes_live: int
    peak_bytes: int
    live: frozenset          # resident tensors currently occupying the buffer
    resident: frozenset      # every tensor ever held resident
    choices: tuple           # chosen candidate index per workload node


@dataclasses.dataclass(frozen=True)
class _Replay:
    """Everything `NetPlan.replan` needs to resume the search."""

    context: PlanContext
    budget: int | None
    strategy: "Strategy | str"
    controller: Controller
    residency_bytes: int
    beam_width: int
    objective: Any
    sim_obj: Any
    non_residable: frozenset
    last_use: dict
    trace: "tuple | None"    # trace[i] = state frontier entering step i


def _residency_sets(graph: NetworkGraph) -> tuple[set, dict]:
    """(non_residable tensors, tensor -> last-use step) for the beam.

    External data must cross the bus: network inputs and outputs are never
    resident. When spilling a tensor would still charge nothing (a virtual
    producer, so no eq-3 term, and no workload consumer, so no eq-2 reads),
    the obligation to ship the network's result moves to the producer's
    inputs, through chains of virtual ops (e.g. the final ResNet add). A
    spilled tensor with a workload consumer already crosses the bus via that
    consumer's reads, so the walk stops there.
    """
    non_residable = set(graph.inputs) | set(graph.outputs)
    frontier = list(graph.outputs)
    while frontier:
        t = frontier.pop()
        prod = graph.nodes[graph.producer[t]]
        if prod.workload is not None or prod.op == "input":
            continue
        if any(graph.nodes[c].workload is not None
               for c in graph.consumers[t]):
            continue
        for s in prod.ins:
            if s not in non_residable:
                non_residable.add(s)
                frontier.append(s)
    last_use = {t: rng[1] for t, rng in graph.live_ranges().items()}
    return non_residable, last_use


@dataclasses.dataclass
class _NetBeam:
    """Mutable beam-search state for one network (one fleet lane)."""

    graph: NetworkGraph
    grids: dict            # node index -> _NodeGrid | _SimNodeGrid
    non_residable: frozenset
    last_use: dict
    residency_bytes: int
    beam_width: int
    states: list
    trace: list            # trace[i] = state frontier entering step i
    words: dict = dataclasses.field(default_factory=dict)   # tensor -> words
    nbytes: dict = dataclasses.field(default_factory=dict)  # tensor -> bytes

    def __post_init__(self) -> None:
        if not self.words:
            for name, t in self.graph.tensors.items():
                self.words[name] = t.words
                self.nbytes[name] = t.nbytes

    def frontier_spills(self, node: Node) -> np.ndarray:
        words = self.words
        return np.asarray(
            [sum(words[t] for t in node.ins if t not in st.live)
             for st in self.states], dtype=np.int64)

    def advance(self, i: int, node: Node, scores) -> None:
        """One beam step: expand every state with the node spilled /
        resident, dedup on the live resident set, prune to the beam.
        ``scores`` is `score_frontier`'s (idx_s, cost_s, idx_r, cost_r)
        aligned with ``states`` (None for virtual nodes)."""
        nbytes = self.nbytes
        last_use = self.last_use
        out = node.out
        out_bytes = nbytes[out]
        residable = (out not in self.non_residable
                     and self.residency_bytes > 0)
        if scores is not None:      # one bulk ndarray -> python conversion
            all_idx_s, all_cost_s, all_idx_r, all_cost_r = \
                (a.tolist() for a in scores)
        nxt: list[_State] = []
        for s_i, st in enumerate(self.states):
            if scores is not None:
                idx_s = all_idx_s[s_i]
                cost_s = all_cost_s[s_i]
                idx_r = all_idx_r[s_i]
                cost_r = all_cost_r[s_i]
            else:
                idx_s = idx_r = None     # type: ignore[assignment]
                cost_s = cost_r = 0.0
            # The node's output is allocated while its inputs are still
            # held, then tensors whose last consumer is this node die.
            dead = [t for t in st.live if last_use[t] <= i]
            if dead:
                live_after = st.live.difference(dead)
                bytes_after = st.bytes_live - sum(nbytes[t] for t in dead)
            else:
                live_after = st.live
                bytes_after = st.bytes_live
            choice = ((st.choices + (idx_s,)) if scores is not None
                      else st.choices)
            nxt.append(_State(
                cost=st.cost + cost_s, bytes_live=bytes_after,
                peak_bytes=st.peak_bytes, live=live_after,
                resident=st.resident, choices=choice))
            if residable and st.bytes_live + out_bytes <= self.residency_bytes:
                choice = ((st.choices + (idx_r,)) if scores is not None
                          else st.choices)
                nxt.append(_State(
                    cost=st.cost + cost_r,
                    bytes_live=bytes_after + out_bytes,
                    peak_bytes=max(st.peak_bytes,
                                   st.bytes_live + out_bytes),
                    live=live_after | {out},
                    resident=st.resident | {out},
                    choices=choice))
        # Dedup on the live resident set (the only state the future sees),
        # keep the cheapest, then prune to the beam. The sort is stable, so
        # ties keep the insertion order of ``nxt``.
        best_by_key: dict[frozenset, _State] = {}
        for st in nxt:
            cur = best_by_key.get(st.live)
            if cur is None or st.cost < cur.cost:
                best_by_key[st.live] = st
        self.states = sorted(best_by_key.values(),
                             key=lambda s: s.cost)[:self.beam_width]
        self.trace.append(self.states)

    def step(self, i: int) -> None:
        node = self.graph.nodes[i]
        grid = self.grids.get(i)
        scores = None
        if grid is not None:
            scores = grid.score_frontier(self.frontier_spills(node))
        self.advance(i, node, scores)


def _make_beam(graph: NetworkGraph, budget, strategy, controller: Controller,
               residency_bytes: int, beam_width: int, sim_obj,
               ctx: PlanContext, sets: "tuple[set, dict] | None" = None
               ) -> _NetBeam:
    grids: dict = {}
    for i, node in enumerate(graph.nodes):
        if node.workload is not None:
            grids[i] = ctx.grid(node.workload, budget, strategy, controller,
                                sim_obj)
    non_residable, last_use = _residency_sets(graph) if sets is None else sets
    init = [_State(cost=0.0, bytes_live=0, peak_bytes=0,
                   live=frozenset(), resident=frozenset(), choices=())]
    return _NetBeam(graph=graph, grids=grids,
                    non_residable=frozenset(non_residable), last_use=last_use,
                    residency_bytes=residency_bytes, beam_width=beam_width,
                    states=init, trace=[init])


def _baseline_plans(graph: NetworkGraph, budget, strategy,
                    controller: Controller, sim_obj, objective,
                    ctx: PlanContext) -> tuple:
    """The ``no_fusion`` baseline: the per-layer pipeline's answer
    (``plan_many``; under an explicit sim objective, the per-layer searches
    scored by it), memoized per workload shape.

    ``plan_many``'s batched all-conv exact search is a per-layer segmented
    argmin and its other path is per-layer ``plan()`` calls, so computing only
    the memo-missing shapes gives the full list's answer bit for bit.
    """
    workloads = list(graph.workloads)
    name = strategy.value if isinstance(strategy, Strategy) else str(strategy)
    override = sim_obj is not None and objective is not None
    tag = (("override", _grid_objective_key(sim_obj)) if override
           else ("words",))
    exact_batch = (not override
                   and strategy in (Strategy.EXACT_OPT,
                                    Strategy.EXHAUSTIVE_VMEM)
                   and bool(workloads)
                   and all(isinstance(w, ConvWorkload) for w in workloads))

    entries = []
    missing: dict = {}
    for wl in workloads:
        b = _api.default_budget(wl) if budget is None else int(budget)
        key = (ctx.shape_of(wl), b, name, controller, tag)
        entries.append((key, wl, b))
        if key not in ctx.scheds and key not in missing:
            missing[key] = (ctx.shape_of(wl), b)
        ctx.stats["sched_hits" if key in ctx.scheds
                  else "sched_misses"] += 1

    if missing:
        if exact_batch:
            wls = [wl for wl, _ in missing.values()]
            # All-conv exact search shares one MAC budget across the list.
            p_macs = next(iter(missing.values()))[1]
            mns = conv_model.conv_exact_search_batch(wls, p_macs, controller)
            for key, (wl, _), (m, n) in zip(missing, missing.values(), mns):
                sched = Schedule(kind="conv", bm=m, bn=n, bk=0,
                                 controller=controller)
                ctx.scheds[key] = (sched, traffic_report(wl, sched,
                                                         exact_iters=True))
        elif override:
            for key, (wl, b) in missing.items():
                sched = dse.plan_with_strategy(wl, b, strategy, controller,
                                               objective=sim_obj)
                ctx.scheds[key] = (sched, traffic_report(wl, sched,
                                                         exact_iters=True))
        else:
            for key, (wl, b) in missing.items():
                p = _api.plan(wl, b, strategy, controller, exact_iters=True)
                ctx.scheds[key] = (p.schedule, p.traffic)

    return tuple(_api.Plan(workload=wl, budget=b,
                           schedule=ctx.scheds[key][0],
                           traffic=ctx.scheds[key][1])
                 for key, wl, b in entries)


def _coerce_graph(graph_or_name) -> NetworkGraph:
    if isinstance(graph_or_name, NetworkGraph):
        return graph_or_name
    if isinstance(graph_or_name, str):
        return NetworkGraph.from_cnn(graph_or_name)
    return NetworkGraph.from_layers(graph_or_name)


# ------------------------------------------------------- graph-level cache
class PlanGraphCacheInfo(NamedTuple):
    hits: int
    misses: int
    maxsize: int
    currsize: int


_GRAPH_CACHE: "collections.OrderedDict[tuple, tuple[NetPlan, Any]]" = \
    collections.OrderedDict()
_GRAPH_CACHE_MAXSIZE = 128
# Hit/miss counts live in the obs registry (``plan_graph_cache{event=...}``)
# so the planner service and the CLI expose them without private imports;
# `plan_graph_cache_info` reads them back as ints.
_CACHE_HITS = REGISTRY.counter("plan_graph_cache",
                               "plan_graph LRU lookups by outcome",
                               labels={"event": "hits"})
_CACHE_MISSES = REGISTRY.counter("plan_graph_cache",
                                 "plan_graph LRU lookups by outcome",
                                 labels={"event": "misses"})
REGISTRY.gauge("plan_graph_cache_size", "entries in the plan_graph LRU",
               fn=lambda: float(len(_GRAPH_CACHE)))


def _graph_signature(graph: NetworkGraph) -> tuple:
    """Structural identity of a graph for the plan cache: name, the full
    node tuple (frozen dataclasses, workloads included), and every tensor."""
    return (graph.name, tuple(graph.nodes),
            tuple(sorted((t.name, t.channels, t.h, t.w, t.word_bytes)
                         for t in graph.tensors.values())))


def _objective_cache_key(objective) -> Any:
    if objective is None or isinstance(objective, str):
        return objective
    from repro_torch.sim.objectives import SimObjective
    if isinstance(objective, SimObjective):
        return ("sim",) + _grid_objective_key(objective)
    # Any other callable: key on identity; the cache entry keeps a strong
    # reference, so the id stays valid for the entry's lifetime.
    return ("id", id(objective))


def _cache_key(graph: NetworkGraph, budget, strategy,
               controller: Controller, residency_bytes, beam_width,
               objective) -> tuple:
    name = strategy.value if isinstance(strategy, Strategy) else str(strategy)
    return (_graph_signature(graph),
            None if budget is None else int(budget), name, controller,
            residency_bytes, beam_width, _objective_cache_key(objective))


def _cache_get(key: tuple) -> "NetPlan | None":
    entry = _GRAPH_CACHE.get(key)
    if entry is None:
        _CACHE_MISSES.inc()
        return None
    _GRAPH_CACHE.move_to_end(key)
    _CACHE_HITS.inc()
    return entry[0]


def _cache_put(key: tuple, netp: NetPlan, objective) -> None:
    _GRAPH_CACHE[key] = (netp, objective)
    _GRAPH_CACHE.move_to_end(key)
    while len(_GRAPH_CACHE) > _GRAPH_CACHE_MAXSIZE:
        _GRAPH_CACHE.popitem(last=False)


def plan_graph_cache_info() -> PlanGraphCacheInfo:
    """``plan()``-style cache statistics for the graph-level plan cache."""
    return PlanGraphCacheInfo(hits=int(_CACHE_HITS.value),
                              misses=int(_CACHE_MISSES.value),
                              maxsize=_GRAPH_CACHE_MAXSIZE,
                              currsize=len(_GRAPH_CACHE))


def clear_plan_graph_cache() -> None:
    _GRAPH_CACHE.clear()
    _CACHE_HITS.reset()
    _CACHE_MISSES.reset()


# ------------------------------------------------------------------ planning
def plan_graph(graph_or_name, budget: int | None = None,
               strategy: "Strategy | str" = Strategy.EXACT_OPT,
               controller: "Controller | str" = Controller.PASSIVE,
               residency_bytes: int = DEFAULT_RESIDENCY_BYTES,
               beam_width: int = DEFAULT_BEAM_WIDTH, *,
               objective=None, checked: bool = False,
               context: PlanContext | None = None) -> NetPlan:
    """Plan a whole network graph: joint per-node schedules + fused edges.

    Accepts a `NetworkGraph`, a zoo CNN name, or an iterable of ConvLayers.
    ``residency_bytes=0`` disables fusion (the result equals the
    independent-layer baseline). Tensors entering or leaving the network are
    never held resident: external data must cross the bus.

    ``objective`` selects what the beam minimizes. The default is the
    strategy's own scoring: interconnect words for the word-count
    strategies, simulated cost for the ``sim_*`` presets. Passing
    ``"sim_latency"`` / ``"sim_energy"`` (or a ``sim.make_sim_objective``
    instance) re-scores any strategy's candidate spaces by batched per-node
    simulation: each beam state's residency goes into one
    ``simulate_batch`` grid evaluation per node (cached per residency key),
    and the ``no_fusion`` baseline becomes the per-layer sim-optimal plans,
    equal to ``plan(wl, strategy="sim_latency")`` layer by layer. Any other
    objective raises `PlanError`.

    Repeat calls with identical arguments hit a graph-level LRU
    (`plan_graph_cache_info` / `clear_plan_graph_cache`). ``context``
    supplies a `PlanContext` whose shape-keyed memos (grids, baselines, sim
    evaluations) are shared across calls.

    ``checked=True`` runs the full `repro_torch.check` NetPlan verifier on
    the result (graph invariants, per-node feasibility, word conservation,
    the residency-budget proof) and raises `repro_torch.check.CheckError`
    on any error-severity diagnostic, a cached plan included.
    """
    graph = _coerce_graph(graph_or_name)
    strategy = _api.coerce_strategy(strategy)
    controller = Controller.coerce(controller)
    with span("plan_graph", cat="plan", graph=graph.name,
              strategy=(strategy.value if isinstance(strategy, Strategy)
                        else str(strategy)),
              controller=controller.value) as sp:
        key = _cache_key(graph, budget, strategy, controller,
                         residency_bytes, beam_width, objective)
        hit = _cache_get(key)
        if hit is not None:
            sp.set("cache", "hit")
            return _verified(hit, checked)
        sp.set("cache", "miss")
        ctx = PlanContext() if context is None else context
        netp = _plan_graph_uncached(graph, budget, strategy, controller,
                                    residency_bytes, beam_width, objective,
                                    ctx)
        _cache_put(key, netp, objective)
        return _verified(netp, checked)


def _verified(netp: NetPlan, checked: bool) -> NetPlan:
    if checked:
        from repro_torch.check import verify     # deferred: check imports plan
        verify(netp, context=f"plan_graph({netp.graph.name!r}) failed "
                             f"verification")
    return netp


def _unfused(graph: NetworkGraph, baseline: tuple, budget, strategy,
             controller: Controller, residency_bytes, beam_width, objective,
             sim_obj, ctx: PlanContext) -> NetPlan:
    """Nothing can be held resident: the baseline schedules are the answer,
    with no candidate grids and no beam."""
    chosen = {n.name: p.schedule
              for n, p in zip(graph.workload_nodes, baseline)}
    netp = _assemble(graph, budget, strategy, controller, residency_bytes,
                     beam_width, chosen, frozenset(), baseline, 0, ctx)
    _attach_replay(netp, ctx, budget, strategy, controller, residency_bytes,
                   beam_width, objective, sim_obj, frozenset(), {}, None)
    return netp


def _plan_graph_uncached(graph: NetworkGraph, budget, strategy,
                         controller: Controller, residency_bytes,
                         beam_width, objective, ctx: PlanContext) -> NetPlan:
    sim_obj = _resolve_sim_objective(strategy, objective)
    baseline = _baseline_plans(graph, budget, strategy, controller, sim_obj,
                               objective, ctx)
    if residency_bytes <= 0:
        return _unfused(graph, baseline, budget, strategy, controller,
                        residency_bytes, beam_width, objective, sim_obj, ctx)
    beam = _make_beam(graph, budget, strategy, controller, residency_bytes,
                      beam_width, sim_obj, ctx)
    for i in range(len(graph.nodes)):
        beam.step(i)
    return _finish(graph, beam, baseline, budget, strategy, controller,
                   residency_bytes, beam_width, objective, sim_obj, ctx)


def _finish(graph: NetworkGraph, beam: _NetBeam, baseline: tuple, budget,
            strategy, controller: Controller, residency_bytes, beam_width,
            objective, sim_obj, ctx: PlanContext) -> NetPlan:
    best = beam.states[0]
    if not best.resident:
        # With nothing resident the beam's argmin choices are the per-layer
        # ones; reuse the baseline schedules outright.
        chosen = {n.name: p.schedule
                  for n, p in zip(graph.workload_nodes, baseline)}
    else:
        chosen = {}
        wl_idx = 0
        for i, node in enumerate(graph.nodes):
            if i in beam.grids:
                chosen[node.name] = beam.grids[i].cands.schedule_at(
                    best.choices[wl_idx], controller)
                wl_idx += 1
    netp = _assemble(graph, budget, strategy, controller, residency_bytes,
                     beam_width, chosen, best.resident, baseline,
                     best.peak_bytes, ctx)
    _attach_replay(netp, ctx, budget, strategy, controller, residency_bytes,
                   beam_width, objective, sim_obj, beam.non_residable,
                   beam.last_use, tuple(beam.trace))
    return netp


def _attach_replay(netp: NetPlan, ctx: PlanContext, budget, strategy,
                   controller: Controller, residency_bytes, beam_width,
                   objective, sim_obj, non_residable, last_use,
                   trace) -> None:
    object.__setattr__(netp, "_replay", _Replay(
        context=ctx, budget=budget, strategy=strategy, controller=controller,
        residency_bytes=residency_bytes, beam_width=beam_width,
        objective=objective, sim_obj=sim_obj,
        non_residable=frozenset(non_residable), last_use=dict(last_use),
        trace=trace))


def _dirty_index(old_graph: NetworkGraph, new_graph: NetworkGraph,
                 nr_old: frozenset, lu_old: dict,
                 nr_new, lu_new: dict) -> int:
    """First beam step whose transition could differ between the old and the
    new graph. The transition at step *i* reads only: the node itself (ins,
    out, workload, hence the grid, which the shared `PlanContext` keeps),
    the out tensor's size, the last-use step of each earlier output, and the
    out tensor's residability. Every tensor is one earlier node's output, so
    checking those four per step makes the shared prefix's transitions
    identical: the recorded frontier entering the first dirty step is the
    fresh run's."""
    for i, node in enumerate(new_graph.nodes):
        if i >= len(old_graph.nodes):
            return i
        old = old_graph.nodes[i]
        if (node != old
                or new_graph.tensors[node.out] != old_graph.tensors[old.out]
                or lu_new.get(node.out) != lu_old.get(old.out)
                or ((node.out in nr_new) != (old.out in nr_old))):
            return i
    return len(new_graph.nodes)


def _replan(netp: NetPlan, budget, residency_bytes, subgraph,
            beam_width) -> NetPlan:
    rp: "_Replay | None" = netp._replay
    new_budget = netp.budget if budget is _UNSET else budget
    new_res = netp.residency_bytes if residency_bytes is _UNSET \
        else residency_bytes
    new_beam = netp.beam_width if beam_width is _UNSET else beam_width
    graph = netp.graph if subgraph is None else _coerce_graph(subgraph)
    strategy = (rp.strategy if rp is not None
                else _api.coerce_strategy(netp.strategy))
    controller = netp.controller
    objective = rp.objective if rp is not None else None

    key = _cache_key(graph, new_budget, strategy, controller, new_res,
                     new_beam, objective)
    hit = _cache_get(key)
    if hit is not None:
        return hit

    ctx = rp.context if rp is not None else PlanContext()
    sim_obj = (rp.sim_obj if rp is not None
               else _resolve_sim_objective(strategy, objective))
    baseline = _baseline_plans(graph, new_budget, strategy, controller,
                               sim_obj, objective, ctx)
    if new_res <= 0:
        out = _unfused(graph, baseline, new_budget, strategy, controller,
                       new_res, new_beam, objective, sim_obj, ctx)
        _cache_put(key, out, objective)
        return out

    sets = _residency_sets(graph)
    params_same = (rp is not None and rp.trace is not None
                   and new_budget == rp.budget
                   and new_res == rp.residency_bytes
                   and new_beam == rp.beam_width)
    if not params_same:
        d = 0
    elif subgraph is None:
        # Nothing changed: this plan is the fresh answer.
        return netp
    else:
        d = _dirty_index(netp.graph, graph, rp.non_residable, rp.last_use,
                         sets[0], sets[1])
    beam = _make_beam(graph, new_budget, strategy, controller, new_res,
                      new_beam, sim_obj, ctx, sets=sets)
    if d > 0:
        beam.states = list(rp.trace[d])
        beam.trace = list(rp.trace[:d + 1])
    for i in range(d, len(graph.nodes)):
        beam.step(i)
    out = _finish(graph, beam, baseline, new_budget, strategy, controller,
                  new_res, new_beam, objective, sim_obj, ctx)
    _cache_put(key, out, objective)
    return out


def _assemble(graph: NetworkGraph, budget, strategy, controller: Controller,
              residency_bytes: int, beam_width: int,
              chosen: dict[str, Schedule], resident: frozenset,
              baseline: tuple, peak_bytes: int,
              ctx: PlanContext | None = None) -> NetPlan:
    """Materialize a `NetPlan` from chosen schedules + residency set."""
    bus_report = (ctx.bus_report if ctx is not None else _node_bus_report)
    node_plans = []
    by_name: dict[str, NodePlan] = {}
    for node in graph.nodes:
        if node.workload is None:
            np_plan = NodePlan(name=node.name, op=node.op, workload=None,
                               schedule=None, traffic=None)
        else:
            spilled = sum(graph.tensors[t].words for t in node.ins
                          if t not in resident)
            rep = bus_report(node.workload, chosen[node.name], spilled,
                             node.out not in resident)
            np_plan = NodePlan(name=node.name, op=node.op,
                               workload=node.workload,
                               schedule=chosen[node.name], traffic=rep)
        node_plans.append(np_plan)
        by_name[node.name] = np_plan

    def _read_iters(consumer: Node) -> int:
        wl, sched = consumer.workload, chosen[consumer.name]
        if isinstance(wl, ConvWorkload):
            ng = wl.cout // wl.groups
            return math.ceil(ng / min(sched.n, ng))
        return math.ceil(wl.n / sched.bn)

    edges = []
    for tname, prod_step, cons_steps in graph.edge_list():
        tensor = graph.tensors[tname]
        prod = graph.nodes[prod_step]
        cons = tuple(graph.nodes[c] for c in cons_steps)
        is_res = tname in resident
        reads = float(sum(tensor.words * _read_iters(c) for c in cons
                          if c.workload is not None))
        if prod.workload is not None:
            prod_plan = by_name[prod.name]
            write = bus_report(prod.workload, prod_plan.schedule,
                               0, True).output_words
        else:
            write = 0.0
        edges.append(EdgePlan(
            tensor=tname, words=tensor.words, nbytes=tensor.nbytes,
            producer=prod.name, consumers=tuple(c.name for c in cons),
            resident=is_res,
            read_words=0.0 if is_res else reads,
            write_words=0.0 if is_res else write,
            saved_words=(reads + write) if is_res else 0.0))

    traffic = network_report(graph, chosen, resident, context=ctx)
    return NetPlan(graph=graph, budget=budget,
                   strategy=(strategy.value if isinstance(strategy, Strategy)
                             else str(strategy)),
                   controller=controller, residency_bytes=int(residency_bytes),
                   beam_width=beam_width, nodes=tuple(node_plans),
                   edges=tuple(edges), traffic=traffic, baseline=baseline,
                   peak_resident_bytes=peak_bytes)
