"""Fleet-rate planning: batched whole-network beam search across graphs.

``plan_graphs(graphs, ...)`` plans many `NetworkGraph`\\ s in one batched
search, the way ``plan_many`` batches the per-layer pipeline:

  * one shared `PlanContext` memoizes candidate grids, per-layer baseline
    schedules and residency-adjusted traffic reports on name-stripped
    workload shapes, so the zoo's repeated conv shapes are planned once per
    shape, not once per (network, node);
  * the per-network beams run in lockstep over the topological step index,
    and at each step all frontiers that land on the same node grid are
    scored in one `score_frontier` call over their concatenated
    ``(states, candidates)`` cost matrix;
  * duplicate requests (same graph and parameters) are planned once and fan
    out to every position, and each result lands in the graph-level plan
    cache that ``plan_graph`` reads.

Every returned `NetPlan` is bit for bit the sequential ``plan_graph`` answer:
frontier scoring is row-wise independent (the same float64 operations, the
same first-minimum tie-break), and the expansion, dedup and prune are the
same `netplan._NetBeam` the sequential planner runs. ``plan_graph_loop`` is
the frozen one-state-at-a-time planner both are held against.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.obs.trace import span
from repro_torch.plan import api as _api
from repro_torch.plan import netplan as _np
from repro_torch.plan.graph import NetworkGraph
from repro_torch.plan.netplan import (DEFAULT_BEAM_WIDTH, DEFAULT_RESIDENCY_BYTES,
                                      NetPlan, PlanContext)
from repro_torch.plan.schedule import Controller, Strategy

__all__ = ["plan_graphs", "plan_graph_loop", "PlanContext"]


@dataclasses.dataclass
class _Lane:
    """One in-flight network of the fleet batch."""

    graph: NetworkGraph
    key: tuple                    # graph-level plan cache key
    positions: list               # indices into the result list
    baseline: tuple = ()
    beam: "Any" = None
    netp: "NetPlan | None" = None


def plan_graphs(graphs, budget: int | None = None,
                strategy: "Strategy | str" = Strategy.EXACT_OPT,
                controller: "Controller | str" = Controller.PASSIVE,
                residency_bytes: int = DEFAULT_RESIDENCY_BYTES,
                beam_width: int = DEFAULT_BEAM_WIDTH, *,
                objective=None, checked: bool = False,
                context: PlanContext | None = None) -> list[NetPlan]:
    """Plan many network graphs in one batched beam search.

    Accepts an iterable of anything ``plan_graph`` accepts (graphs, zoo CNN
    names, layer iterables); the other arguments apply to the whole fleet
    and mean what they mean on ``plan_graph``. Returns one `NetPlan` per
    input, in order, each equal to the sequential ``plan_graph`` call.

    ``context`` supplies a persistent `PlanContext`, so grids are shared
    across fleet calls too; by default each call gets a fresh one. Results
    hit and fill the same graph-level LRU as ``plan_graph``.
    """
    _np._check_objective(objective)
    strategy = _api.coerce_strategy(strategy)
    controller = Controller.coerce(controller)
    ctx = PlanContext() if context is None else context
    coerced = [ctx.graph_of(g) for g in graphs]
    with span("fleet.plan_graphs", cat="plan", nets=len(coerced),
              controller=controller.value):
        results = _plan_graphs_batched(coerced, budget, strategy, controller,
                                       residency_bytes, beam_width, objective,
                                       ctx)
        if checked:
            seen: set[int] = set()
            for netp in results:
                if id(netp) not in seen:
                    seen.add(id(netp))
                    _np._verified(netp, True)
        return results


def _plan_graphs_batched(coerced, budget, strategy, controller,
                         residency_bytes, beam_width, objective,
                         ctx) -> list[NetPlan]:
    results: "list[NetPlan | None]" = [None] * len(coerced)
    lanes: dict[tuple, _Lane] = {}
    for pos, graph in enumerate(coerced):
        key = _np._cache_key(graph, budget, strategy, controller,
                             residency_bytes, beam_width, objective)
        lane = lanes.get(key)
        if lane is not None:          # duplicate request: plan once, fan out
            lane.positions.append(pos)
            continue
        hit = _np._cache_get(key)
        if hit is not None:
            results[pos] = hit
            continue
        lanes[key] = _Lane(graph=graph, key=key, positions=[pos])

    # Per-lane precompute: the baseline (shape-memoized) and either the
    # residency <= 0 answer or a beam to run.
    live: list[_Lane] = []
    for lane in lanes.values():
        lane.baseline = _np._baseline_plans(lane.graph, budget, strategy,
                                            controller, ctx)
        if residency_bytes <= 0:
            lane.netp = _np._unfused(lane.graph, lane.baseline, budget,
                                     strategy, controller, residency_bytes,
                                     beam_width, objective, ctx)
            continue
        lane.beam = _np._make_beam(lane.graph, budget, strategy, controller,
                                   residency_bytes, beam_width, ctx)
        live.append(lane)

    # Lockstep beam: at each topological step, bucket the active lanes by
    # node grid and score each bucket's concatenated frontier in one call.
    # Frontier scoring is row-wise independent, so the per-lane slices equal
    # the lane's own score_frontier call bit for bit.
    for step in range(max((len(ln.graph.nodes) for ln in live), default=0)):
        buckets: dict[int, list] = {}
        for lane in live:
            if step >= len(lane.graph.nodes):
                continue
            node = lane.graph.nodes[step]
            grid = lane.beam.grids.get(step)
            if grid is None:
                lane.beam.advance(step, node, None)
            else:
                buckets.setdefault(id(grid), []).append((lane, node, grid))
        for group in buckets.values():
            grid = group[0][2]
            spills = [lane.beam.frontier_spills(node)
                      for lane, node, _ in group]
            if len(group) == 1:
                lane, node, _ = group[0]
                lane.beam.advance(step, node, grid.score_frontier(spills[0]))
                continue
            ctx.stats["fleet_bucketed_steps"] += 1
            joint = np.concatenate(spills)
            with span("fleet.bucket_step", cat="plan", step=step,
                      lanes=len(group), states=len(joint)):
                cat = grid.score_frontier(joint)
            off = 0
            for (lane, node, _), sp in zip(group, spills):
                lane.beam.advance(step, node,
                                  tuple(a[off:off + len(sp)] for a in cat))
                off += len(sp)

    for lane in live:
        lane.netp = _np._finish(lane.graph, lane.beam, lane.baseline, budget,
                                strategy, controller, residency_bytes,
                                beam_width, objective, ctx)

    for lane in lanes.values():
        _np._cache_put(lane.key, lane.netp)
        for pos in lane.positions:
            results[pos] = lane.netp
    return [r for r in results if r is not None]


def plan_graph_loop(graph_or_name, budget: int | None = None,
                    strategy: "Strategy | str" = Strategy.EXACT_OPT,
                    controller: "Controller | str" = Controller.PASSIVE,
                    residency_bytes: int = DEFAULT_RESIDENCY_BYTES,
                    beam_width: int = DEFAULT_BEAM_WIDTH) -> NetPlan:
    """Frozen loop-rate reference planner, the pre-fleet implementation.

    One network, one node and one beam state at a time: the graph and every
    candidate grid are rebuilt per call, every state is scored with a scalar
    ``grid.best`` call, the baseline re-runs ``plan_many``, and nothing is
    shared or cached across calls. Kept as the parity oracle for
    ``plan_graphs`` and ``plan_graph``. Do not optimise.
    """
    graph = _np._coerce_graph(graph_or_name)
    strategy = _api.coerce_strategy(strategy)
    controller = Controller.coerce(controller)
    baseline = tuple(_api.plan_many(list(graph.workloads), budget, strategy,
                                    controller, exact_iters=True))
    if residency_bytes <= 0:
        chosen = {n.name: p.schedule
                  for n, p in zip(graph.workload_nodes, baseline)}
        return _np._assemble(graph, budget, strategy, controller,
                             residency_bytes, beam_width, chosen,
                             frozenset(), baseline, 0)

    grids = {i: _np._node_grid(node.workload, budget, strategy, controller)
             for i, node in enumerate(graph.nodes)
             if node.workload is not None}
    non_residable, last_use = _np._residency_sets(graph)

    states = [_np._State(cost=0.0, bytes_live=0, peak_bytes=0,
                         live=frozenset(), resident=frozenset(), choices=())]
    for i, node in enumerate(graph.nodes):
        grid = grids.get(i)
        out_bytes = graph.tensors[node.out].nbytes
        nxt = []
        for st in states:
            if grid is not None:
                spilled = sum(graph.tensors[t].words for t in node.ins
                              if t not in st.live)
                idx_s, cost_s = grid.best(spilled, out_spilled=True)
                idx_r, cost_r = grid.best(spilled, out_spilled=False)
            else:
                idx_s = idx_r = None
                cost_s = cost_r = 0.0
            dead = frozenset(t for t in st.live if last_use[t] <= i)
            live_after = st.live - dead
            bytes_after = st.bytes_live - sum(graph.tensors[t].nbytes
                                              for t in dead)
            choice = ((st.choices + (idx_s,)) if grid is not None
                      else st.choices)
            nxt.append(_np._State(
                cost=st.cost + cost_s, bytes_live=bytes_after,
                peak_bytes=st.peak_bytes, live=live_after,
                resident=st.resident, choices=choice))
            if (node.out not in non_residable
                    and st.bytes_live + out_bytes <= residency_bytes):
                choice = ((st.choices + (idx_r,)) if grid is not None
                          else st.choices)
                nxt.append(_np._State(
                    cost=st.cost + cost_r,
                    bytes_live=bytes_after + out_bytes,
                    peak_bytes=max(st.peak_bytes,
                                   st.bytes_live + out_bytes),
                    live=live_after | {node.out},
                    resident=st.resident | {node.out},
                    choices=choice))
        best_by_key: dict[frozenset, Any] = {}
        for st in nxt:
            cur = best_by_key.get(st.live)
            if cur is None or st.cost < cur.cost:
                best_by_key[st.live] = st
        states = sorted(best_by_key.values(),
                        key=lambda s: s.cost)[:beam_width]

    best = states[0]
    if not best.resident:
        chosen = {n.name: p.schedule
                  for n, p in zip(graph.workload_nodes, baseline)}
    else:
        chosen = {}
        wl_idx = 0
        for i, node in enumerate(graph.nodes):
            if i in grids:
                chosen[node.name] = grids[i].cands.schedule_at(
                    best.choices[wl_idx], controller)
                wl_idx += 1
    return _np._assemble(graph, budget, strategy, controller,
                         residency_bytes, beam_width, chosen, best.resident,
                         baseline, best.peak_bytes)
