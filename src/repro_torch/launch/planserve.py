"""Planner as a service: batch (graph, budget, objective) jobs into fleet
planning calls and report plans/s with p50/p99 latency under load.

    PYTHONPATH=src python -m repro_torch.launch.planserve --smoke --json \
        --requests 64 --rate 500 --batch 16

The server keeps one persistent `repro_torch.plan.PlanContext` and drains
FIFO micro-batches of concurrent requests into single ``plan_graphs`` calls,
so candidate grids and baseline schedules are shared across every request
the process serves, and repeat requests are answered from the graph-level
plan LRU. The load generator draws a seeded Poisson arrival process on a
virtual clock (only planning work is timed, on the host), which makes the
reported latency distribution deterministic enough to compare across runs.

The ``speedup`` section times the same request stream both ways: a loop of
`repro_torch.plan.fleet.plan_graph_loop` calls (the frozen pre-fleet planner
that rebuilds every graph, grid and baseline per call) against the batched
server. Every served `NetPlan` equals the sequential answer; the report
counts the plans whose words or schedules differ (``word_mismatches``).

Planning runs on the host in numpy; nothing here touches the card.

The hardened server of the reference (`ServerPolicy`,
`ResilientPlanServer`, `fault_catalog`, `run_fault_load`) needs the fault
models and the simulator's ``sim_latency`` objective, which are not ported
yet: each raises `NotImplementedError` naming ROADMAP A10.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, NoReturn

import numpy as np

from repro_torch.obs.metrics import REGISTRY, Histogram
from repro_torch.obs.trace import Stopwatch, get_tracer, span
from repro_torch.plan import PlanContext, plan_graphs
from repro_torch.plan.fleet import plan_graph_loop
from repro_torch.plan.netplan import (DEFAULT_BEAM_WIDTH,
                                      DEFAULT_RESIDENCY_BYTES)

#: The service catalog the load report covers: the paper's CNN zoo crossed
#: with both word-count strategies and both memory controllers.
STRATEGIES = ("exact_opt", "paper_opt")
CONTROLLERS = ("passive", "active")


@dataclasses.dataclass(frozen=True)
class PlanRequest:
    """One planning job: a graph (or zoo CNN name) plus plan parameters."""

    graph: Any
    budget: "int | None" = None
    strategy: str = "exact_opt"
    controller: str = "passive"
    residency_bytes: int = DEFAULT_RESIDENCY_BYTES
    beam_width: int = DEFAULT_BEAM_WIDTH
    objective: Any = None

    def params(self) -> tuple:
        """Fleet-call grouping key: every field except the graph."""
        return (self.budget, self.strategy, self.controller,
                self.residency_bytes, self.beam_width, self.objective)


class PlanServer:
    """Drains micro-batches of `PlanRequest`\\ s through ``plan_graphs``.

    One persistent `PlanContext` lives for the server's lifetime; each
    ``serve`` call groups its batch by plan parameters and issues one
    ``plan_graphs`` call per group (duplicate graphs inside a group are
    planned once by the fleet planner itself)."""

    def __init__(self) -> None:
        self.context = PlanContext()
        self.served = 0
        self._served_metric = REGISTRY.counter(
            "planserve_requests_served", "requests answered by PlanServer")
        self._batch_metric = REGISTRY.counter(
            "planserve_batches", "micro-batches drained by PlanServer")

    def serve(self, requests: "list[PlanRequest]") -> list:
        """Plan a micro-batch; returns one `NetPlan` per request, in order."""
        with span("planserve.batch", cat="serve", requests=len(requests)) \
                as sp:
            groups: dict[tuple, list[int]] = {}
            for i, req in enumerate(requests):
                groups.setdefault(req.params(), []).append(i)
            sp.set("groups", len(groups))
            out: list = [None] * len(requests)
            for params, idxs in groups.items():
                budget, strategy, controller, residency, beam, objective = \
                    params
                plans = plan_graphs([requests[i].graph for i in idxs],
                                    budget=budget, strategy=strategy,
                                    controller=controller,
                                    residency_bytes=residency,
                                    beam_width=beam,
                                    objective=objective, context=self.context)
                for i, netp in zip(idxs, plans):
                    out[i] = netp
            self.served += len(requests)
            self._served_metric.inc(len(requests))
            self._batch_metric.inc()
            return out


def catalog(smoke: bool = False) -> list[PlanRequest]:
    """The zoo x strategies x controllers request catalog (32 entries; the
    smoke catalog keeps 2 networks, 8 entries)."""
    from repro_torch.core.cnn_zoo import PAPER_CNNS
    names = list(PAPER_CNNS)[:2] if smoke else list(PAPER_CNNS)
    return [PlanRequest(graph=n, strategy=s, controller=c)
            for n in names for s in STRATEGIES for c in CONTROLLERS]


def run_load(requests: int = 64, rate_per_s: float = 500.0,
             batch_max: int = 16, seed: int = 0,
             smoke: bool = False) -> dict:
    """Serve a seeded Poisson request stream; return the service report.

    Arrivals are drawn over the catalog round-robin on a virtual clock;
    only the planning work inside ``PlanServer.serve`` is timed (a
    `Stopwatch` per micro-batch), so a request's latency is its queueing
    delay plus the measured host time of the micro-batch that served it.

    Each latency also feeds the ``planserve_latency_seconds`` histogram in
    `REGISTRY`; the report carries the histogram's ``p50_ms_hist`` /
    ``p99_ms_hist`` beside the ``np.percentile`` values and asserts they
    agree within 1% (the histogram's log buckets bound the error at about
    0.25%). When a tracer is active, every request is recorded as a
    virtual-clock queue-delay and service span pair.
    """
    cat = catalog(smoke)
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate_per_s, size=requests))
    stream = [(float(arrivals[i]), cat[i % len(cat)])
              for i in range(requests)]

    server = PlanServer()
    hist = Histogram("planserve_latency_seconds")   # this run only
    registry_hist = REGISTRY.histogram(
        "planserve_latency_seconds", "request latency under run_load")
    clock = 0.0
    latencies = []
    n_batches = 0
    busy_s = 0.0
    i = 0
    while i < len(stream):
        if clock < stream[i][0]:
            clock = stream[i][0]          # idle until the next arrival
        batch = [req for t, req in stream[i:i + batch_max] if t <= clock]
        if not batch:
            batch = [stream[i][1]]
        t_start = clock
        with Stopwatch() as sw:
            server.serve(batch)
        wall = sw.s
        clock += wall
        busy_s += wall
        tracer = get_tracer()
        for j in range(len(batch)):
            arrival = stream[i + j][0]
            lat = clock - arrival
            latencies.append(lat)
            hist.observe(lat)
            registry_hist.observe(lat)
            if tracer is not None:
                # Virtual-clock spans: queue delay, then in-batch service.
                name = str(stream[i + j][1].graph)
                qid = tracer.record(f"queue {name}", arrival,
                                    t_start - arrival, cat="serve",
                                    attrs=(("request", i + j),)).span_id
                tracer.record(f"serve {name}", t_start, wall, cat="serve",
                              parent_id=qid,
                              attrs=(("request", i + j),
                                     ("batch", n_batches)))
        i += len(batch)
        n_batches += 1

    lat_ms = np.asarray(latencies) * 1e3
    p50 = float(np.percentile(lat_ms, 50))
    p99 = float(np.percentile(lat_ms, 99))
    p50_hist = hist.quantile(0.50) * 1e3
    p99_hist = hist.quantile(0.99) * 1e3
    assert abs(p50_hist - p50) <= 0.01 * p50 + 1e-9, (p50_hist, p50)
    assert abs(p99_hist - p99) <= 0.01 * p99 + 1e-9, (p99_hist, p99)
    return {
        "requests": requests,
        "catalog_size": len(cat),
        "batches": n_batches,
        "batch_max": batch_max,
        "rate_per_s": rate_per_s,
        "plans_per_s": requests / clock,
        "busy_plans_per_s": requests / busy_s,
        "p50_ms": p50,
        "p99_ms": p99,
        "p50_ms_hist": p50_hist,
        "p99_ms_hist": p99_hist,
    }


# ------------------------------------------------ the hardened server (A10)
def _waits_for_a10(name: str) -> NoReturn:
    raise NotImplementedError(
        f"planserve.{name} needs the fault models (repro_torch.faults) and "
        f"the simulator's sim_latency objective, which are not ported yet: "
        f"ROADMAP A10")


class ServerPolicy:
    """The reference's knobs of the hardened server; waits for A10."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        _waits_for_a10("ServerPolicy")


class ResilientPlanServer(PlanServer):
    """The reference's server hardened for faults and overload; waits for
    A10."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        _waits_for_a10("ResilientPlanServer")


def fault_catalog(smoke: bool = False) -> list[PlanRequest]:
    """The reference's fault-load catalog (``sim_latency``); waits for A10."""
    _waits_for_a10("fault_catalog")


def run_fault_load(*args: Any, **kwargs: Any) -> dict:
    """The reference's fault-injection load run; waits for A10."""
    _waits_for_a10("run_fault_load")


def run_speedup(passes: int = 8, smoke: bool = False) -> dict:
    """Time the same zoo request stream sequentially and batched.

    The stream is ``passes`` rounds over the CNN zoo at default parameters,
    the repeat traffic a planner service sees. Sequential planning is a loop
    of frozen pre-fleet ``plan_graph_loop`` calls (per-call graph, grid and
    baseline rebuilds, scalar per-state scoring); the batched side is the
    server: one ``plan_graphs`` micro-batch per round against a persistent
    context and the graph-level plan LRU. Plans whose words or schedules
    differ between the two are counted before timing.
    """
    from repro_torch.core.cnn_zoo import PAPER_CNNS
    from repro_torch.plan import clear_plan_graph_cache
    names = (list(PAPER_CNNS)[:2] if smoke else list(PAPER_CNNS))

    server = PlanServer()
    clear_plan_graph_cache()
    reqs = [PlanRequest(graph=n) for n in names]
    batched_plans = server.serve(reqs)        # warm-up and parity capture
    loop_plans = [plan_graph_loop(n) for n in names]
    mismatch = sum(
        a.total_words != b.total_words or a.baseline_words != b.baseline_words
        or [p.schedule for p in a.nodes] != [p.schedule for p in b.nodes]
        for a, b in zip(batched_plans, loop_plans))

    with Stopwatch() as seq:
        for _ in range(passes):
            for n in names:
                plan_graph_loop(n)
    t_seq = seq.s

    clear_plan_graph_cache()
    server = PlanServer()
    with Stopwatch() as bat:
        for _ in range(passes):
            server.serve(reqs)
    t_batched = bat.s

    total = passes * len(names)
    return {
        "stream_requests": total,
        "sequential_s": t_seq,
        "batched_s": t_batched,
        "sequential_plans_per_s": total / t_seq,
        "batched_plans_per_s": total / t_batched,
        "batched_vs_sequential": t_seq / t_batched,
        "word_mismatches": mismatch,
        "fleet_total_mwords": sum(p.total_words for p in batched_plans) / 1e6,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=500.0)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--passes", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json")
    args = ap.parse_args(argv)

    report = {
        "load": run_load(requests=args.requests, rate_per_s=args.rate,
                         batch_max=args.batch, seed=args.seed,
                         smoke=args.smoke),
        "speedup": run_speedup(passes=args.passes, smoke=args.smoke),
    }
    if args.as_json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        ld, sp = report["load"], report["speedup"]
        print(f"served {ld['requests']} requests in {ld['batches']} batches: "
              f"{ld['plans_per_s']:.0f} plans/s  "
              f"p50={ld['p50_ms']:.2f}ms p99={ld['p99_ms']:.2f}ms")
        print(f"speedup over {sp['stream_requests']}-request zoo stream: "
              f"batched {sp['batched_vs_sequential']:.1f}x sequential "
              f"({sp['batched_plans_per_s']:.0f} vs "
              f"{sp['sequential_plans_per_s']:.0f} plans/s), "
              f"word_mismatches={sp['word_mismatches']}")
    return report


if __name__ == "__main__":
    main()
