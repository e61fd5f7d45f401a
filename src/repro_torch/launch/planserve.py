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

The hardened server (`ServerPolicy`, `ResilientPlanServer`,
`fault_catalog`, `run_fault_load`) serves the ``sim_latency`` objective
under `repro_torch.faults` schedules on the load generator's virtual clock:
degraded re-planning, a circuit breaker to the word-count objective, retry
with seeded backoff, admission and deadlines. Its report equals the
reference's for a seed, key by key.

Planning runs on the host in numpy; nothing here touches the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import random
from typing import TYPE_CHECKING, Any

import numpy as np

from repro_torch.errors import PlanError
from repro_torch.obs.metrics import REGISTRY, Histogram
from repro_torch.obs.trace import Stopwatch, get_tracer, span
from repro_torch.plan import PlanContext, plan_graphs
from repro_torch.plan.fleet import plan_graph_loop
from repro_torch.plan.netplan import (DEFAULT_BEAM_WIDTH,
                                      DEFAULT_RESIDENCY_BYTES)
from repro_torch.plan.schedule import Controller

if TYPE_CHECKING:
    from repro_torch.faults.models import Fault, FaultSchedule

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


# ------------------------------------------------------ graceful degradation
@dataclasses.dataclass(frozen=True)
class ServerPolicy:
    """Knobs of the hardened server (`ResilientPlanServer`).

    Deadlines, queue bounds, and the circuit breaker all live on the load
    generator's *virtual* clock; the backoff and virtual service-time
    constants are virtual seconds too, so a fault-load run is exactly
    reproducible for a given seed regardless of the machine it runs on.
    """

    deadline_s: float = 0.5          # per-request, from arrival
    queue_max: int = 64              # bounded admission queue
    retries: int = 2                 # retry attempts per micro-batch
    backoff_base_s: float = 0.01     # exponential backoff: base * 2**attempt
    backoff_jitter: float = 0.5      # +/- fraction of seeded jitter
    breaker_backlog: int = 32        # queue depth that opens the breaker
    breaker_cooldown_s: float = 0.25  # min open time before probing closed
    # Virtual service-time model: per-batch + per-request virtual seconds in
    # each mode. The sim-objective mode is modelled slower than the
    # analytical word-count mode — that asymmetry is what the breaker trades
    # away under pressure.
    svc_sim_s: float = 0.004
    svc_sim_per_req_s: float = 0.002
    svc_words_s: float = 0.001
    svc_words_per_req_s: float = 0.0005


class ResilientPlanServer(PlanServer):
    """`PlanServer` hardened for degraded machines and overload.

    Three mechanisms, all observable through ``repro_torch.obs`` counters/spans:

    * **degraded re-planning** — plan-affecting faults injected via
      :meth:`inject` (EngineDegrade / VmemShrink / ControllerFallback) fold
      into every subsequent request's parameters
      (`repro_torch.faults.inject.degraded_plan_args`), so served plans are always
      derived for the hardware that actually exists;
    * **circuit breaker** — under pressure (queue backlog or a degraded
      engine) the server falls back from the expensive ``sim_latency``
      objective to the cheap analytical ``interconnect_words`` objective
      (``objective=None``), probing closed again after a cooldown once the
      backlog drains and no engine fault is active;
    * **retry with exponential backoff + jitter** — the load loop re-serves
      a micro-batch interrupted by a mid-service fault after
      :meth:`backoff_s` virtual seconds (seeded jitter, reproducible).

    Deadlines and the bounded admission queue live in :func:`run_fault_load`
    (they are properties of the arrival process, not of planning itself).
    """

    def __init__(self, policy: "ServerPolicy | None" = None,
                 seed: int = 0) -> None:
        super().__init__()
        self.policy = policy if policy is not None else ServerPolicy()
        self._rng = random.Random(seed)
        self.active_faults: "list[Fault]" = []
        self.breaker_open = False
        self._breaker_opened_at = 0.0
        # Per-instance tallies (the REGISTRY counters are process-global and
        # accumulate across servers; reports must count this run only).
        self.breaker_opens = 0
        self.mode_switches = 0
        self._faults_metric = REGISTRY.counter(
            "planserve_faults_injected", "fault events injected")
        self._mode_metric = REGISTRY.counter(
            "planserve_mode_switches", "circuit-breaker open/close flips")
        self._breaker_metric = REGISTRY.counter(
            "planserve_breaker_opens", "circuit-breaker opens")
        self._shed_metric = REGISTRY.counter(
            "planserve_sheds", "requests rejected by admission control")
        self._deadline_metric = REGISTRY.counter(
            "planserve_deadline_misses", "requests expired past deadline")
        self._retry_metric = REGISTRY.counter(
            "planserve_retries", "micro-batch retry attempts")
        self._error_metric = REGISTRY.counter(
            "planserve_plan_errors", "micro-batches failed with PlanError")

    # -- fault state --------------------------------------------------------
    def inject(self, fault: "Fault", now_s: float) -> None:
        """Make ``fault`` part of the server's world from ``now_s`` on."""
        self._faults_metric.inc()
        with span("planserve.fault", cat="fault",
                  kind=type(fault).__name__, t=now_s):
            if fault.affects_plan:
                self.active_faults.append(fault)
            if self._engine_degraded():
                self.open_breaker(now_s, reason="engine_degrade")

    def _engine_degraded(self) -> bool:
        return any(type(f).__name__ == "EngineDegrade"
                   for f in self.active_faults)

    # -- circuit breaker ----------------------------------------------------
    def open_breaker(self, now_s: float, reason: str) -> None:
        self._breaker_opened_at = now_s
        if self.breaker_open:
            return
        self.breaker_open = True
        self.breaker_opens += 1
        self.mode_switches += 1
        self._breaker_metric.inc()
        self._mode_metric.inc()
        with span("planserve.breaker", cat="serve", state="open",
                  reason=reason, t=now_s):
            pass

    def maybe_close_breaker(self, now_s: float, backlog: int) -> None:
        """Probe closed: cooldown elapsed, backlog drained, engine healthy."""
        if (self.breaker_open and not self._engine_degraded()
                and backlog < self.policy.breaker_backlog
                and now_s - self._breaker_opened_at
                >= self.policy.breaker_cooldown_s):
            self.breaker_open = False
            self.mode_switches += 1
            self._mode_metric.inc()
            with span("planserve.breaker", cat="serve", state="closed",
                      t=now_s):
                pass

    # -- virtual-time models ------------------------------------------------
    def virtual_service_s(self, n_requests: int) -> float:
        p = self.policy
        if self.breaker_open:
            return p.svc_words_s + p.svc_words_per_req_s * n_requests
        return p.svc_sim_s + p.svc_sim_per_req_s * n_requests

    def backoff_s(self, attempt: int) -> float:
        p = self.policy
        jitter = 1.0 + p.backoff_jitter * self._rng.uniform(-1.0, 1.0)
        return p.backoff_base_s * (2.0 ** attempt) * jitter

    # -- degraded serving ---------------------------------------------------
    def degraded_request(self, req: PlanRequest) -> PlanRequest:
        """``req`` with the active faults folded into its parameters (and,
        with the breaker open, the objective dropped to the analytical
        word count)."""
        from repro_torch.faults.inject import degraded_plan_args
        from repro_torch.faults.models import PlanArgs
        args = degraded_plan_args(self.active_faults, PlanArgs(
            budget=req.budget, residency_bytes=req.residency_bytes,
            controller=Controller.coerce(req.controller)))
        return dataclasses.replace(
            req, budget=args.budget, residency_bytes=args.residency_bytes,
            controller=args.controller.value,
            objective=None if self.breaker_open else req.objective)

    def serve_degraded(self, requests: "list[PlanRequest]") -> list:
        """One micro-batch under the current fault state + breaker mode."""
        return self.serve([self.degraded_request(r) for r in requests])


def fault_catalog(smoke: bool = False) -> list[PlanRequest]:
    """The fault-load catalog: zoo x controllers under the ``sim_latency``
    objective — the expensive healthy-mode service the breaker degrades."""
    from repro_torch.core.cnn_zoo import PAPER_CNNS
    names = list(PAPER_CNNS)[:2] if smoke else list(PAPER_CNNS)
    return [PlanRequest(graph=n, controller=c, objective="sim_latency")
            for n in names for c in CONTROLLERS]


def run_fault_load(schedule: "FaultSchedule | None" = None,
                   requests: int = 96, rate_per_s: float = 400.0,
                   batch_max: int = 8, seed: int = 0, smoke: bool = True,
                   policy: "ServerPolicy | None" = None,
                   server: "ResilientPlanServer | None" = None) -> dict:
    """Serve a seeded Poisson stream through a `ResilientPlanServer` while
    injecting ``schedule``'s faults — entirely on the virtual clock.

    The discrete-event loop is deterministic end to end: arrivals, storm
    surges, backoff jitter, and the per-batch service times all come from
    seeded draws or the `ServerPolicy` virtual service-time model, so
    availability / shed-rate / p99 reproduce exactly for a given
    (schedule, seed); they equal the reference's report key by key and are
    compared with the reference's. Real planning still runs inside
    each batch (`ResilientPlanServer.serve_degraded`), it just does not
    drive the clock.

    `RequestStorm` events multiply the arrival rate inside their window;
    plan-affecting faults landing mid-service abort the in-flight batch,
    which is retried with exponential backoff + jitter under the newly
    degraded parameters. Requests are dropped by admission control
    (``queue_max``), expired in queue, or counted as deadline misses when
    they complete late; availability is the fraction of arrivals answered
    with a plan inside their deadline.
    """
    from collections import deque

    server = ResilientPlanServer(policy, seed) if server is None else server
    pol = server.policy
    cat = fault_catalog(smoke)
    rng = np.random.default_rng(seed)
    times = list(np.cumsum(rng.exponential(1.0 / rate_per_s,
                                           size=requests)))
    storms = []
    if schedule is not None:
        from repro_torch.faults.inject import storm_windows
        storms = list(storm_windows(schedule))
    for t0, t1, factor in storms:
        extra = rng.poisson(rate_per_s * (factor - 1.0) * (t1 - t0))
        times.extend(float(t) for t in rng.uniform(t0, t1, size=int(extra)))
    arrivals = [(t, cat[i % len(cat)]) for i, t in enumerate(sorted(times))]
    events = ([(e.t_s, e.fault) for e in schedule]
              if schedule is not None else [])

    queue: "deque[tuple[float, PlanRequest]]" = deque()
    clock = 0.0
    ai = ei = 0
    ok = sheds = expired = late = retries = plan_errors = 0
    latencies: list[float] = []
    degraded_lat: list[float] = []
    while ai < len(arrivals) or queue:
        if not queue and clock < arrivals[ai][0]:
            clock = arrivals[ai][0]      # idle until the next arrival
        while ei < len(events) and events[ei][0] <= clock:
            server.inject(events[ei][1], clock)
            ei += 1
        while ai < len(arrivals) and arrivals[ai][0] <= clock:
            t, req = arrivals[ai]
            ai += 1
            if len(queue) >= pol.queue_max:
                sheds += 1
                server._shed_metric.inc()
            else:
                queue.append((t, req))
        if not queue:
            continue
        while queue and queue[0][0] + pol.deadline_s < clock:
            queue.popleft()              # expired before service started
            expired += 1
            server._deadline_metric.inc()
        if not queue:
            continue
        if len(queue) >= pol.breaker_backlog:
            server.open_breaker(clock, reason="backlog")
        server.maybe_close_breaker(clock, len(queue))
        batch = [queue.popleft()
                 for _ in range(min(batch_max, len(queue)))]
        svc = server.virtual_service_s(len(batch))
        attempt = 0
        # A plan-affecting fault landing inside the service window aborts
        # the in-flight batch: inject, back off, re-serve degraded.
        while (ei < len(events) and events[ei][0] < clock + svc
               and events[ei][1].affects_plan and attempt < pol.retries):
            clock = max(clock, events[ei][0])
            server.inject(events[ei][1], clock)
            ei += 1
            attempt += 1
            retries += 1
            server._retry_metric.inc()
            clock += server.backoff_s(attempt)
            svc = server.virtual_service_s(len(batch))
        try:
            server.serve_degraded([req for _, req in batch])
            served = True
        except PlanError:
            server._error_metric.inc()
            plan_errors += 1
            served = False
        degraded = server.breaker_open or bool(server.active_faults)
        clock += svc
        for t_arr, _req in batch:
            lat = clock - t_arr
            if served and lat <= pol.deadline_s:
                ok += 1
                latencies.append(lat)
                if degraded:
                    degraded_lat.append(lat)
            else:
                late += 1
                server._deadline_metric.inc()

    total = len(arrivals)
    lat_ms = np.asarray(latencies) * 1e3 if latencies else np.zeros(1)
    deg_ms = np.asarray(degraded_lat) * 1e3 if degraded_lat else np.zeros(1)
    return {
        "requests": total,
        "served_ok": ok,
        "availability_pct": 100.0 * ok / total if total else 100.0,
        "shed_rate_pct": 100.0 * sheds / total if total else 0.0,
        "sheds": sheds,
        "expired": expired,
        "deadline_late": late,       # includes plan-error batches
        "plan_errors": plan_errors,
        "retries": retries,
        "breaker_opens": server.breaker_opens,
        "mode_switches": server.mode_switches,
        "fault_events": ei,
        "p99_virtual_ms": float(np.percentile(lat_ms, 99)),
        "degraded_p99_virtual_ms": float(np.percentile(deg_ms, 99)),
    }


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
