"""Chaos harness: seeded fault schedules over the zoo + planner service.

One ``run_chaos`` call runs ``n_schedules`` independent seeded fault
schedules (`repro_torch.faults.inject.generate_schedule`) and, for each, checks
the stack's graceful-degradation invariants end to end:

  1. **zero word-count drift** — simulating the base plan under the
     schedule's machine faults yields bit-for-bit the un-faulted first-order
     totals (`SimReport.as_traffic_report`), and degraded time is monotone:
     faulted cycles >= clean cycles;
  2. **replan parity** — folding the schedule's plan-affecting faults over
     the base plan (`apply_to_plan`, i.e. ``NetPlan.replan`` or a
     controller-fallback fresh plan) equals the frozen cache-bypassing
     reference planner `repro_torch.plan.fleet.plan_graph_loop` under the same
     degraded parameters, word-for-word and schedule-for-schedule (the
     oracle bypasses the graph LRU, so the parity is not a cache echo);
  3. **clean static verification** — every surviving degraded plan passes
     `repro_torch.check` with zero error-severity diagnostics;
  4. **availability floor** — the hardened planner service survives the
     schedule (storm surges included) with availability >= the floor.

Everything is deterministic: fault draws, arrivals, backoff jitter, and the
virtual service-time model are all seeded, so a violation reproduces from
its schedule seed alone. Degraded plans and oracle runs are memoized by
their (network, degraded-parameter) key — the quantized fault pools make
configurations recur across seeds, which keeps 50+ schedules tractable.

    PYTHONPATH=src python -m repro_torch.faults --schedules 50 --smoke
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.errors import InvariantViolation
from repro_torch.faults.inject import (apply_to_plan, degraded_plan_args,
                                 generate_schedule, plan_args_of)

__all__ = ["ChaosReport", "run_chaos", "DEFAULT_AVAILABILITY_FLOOR_PCT"]

#: The availability the hardened service must keep under any generated
#: schedule (storms, degraded engines, mid-service faults): the hard minimum
#: chaos enforces, the reference's own.
DEFAULT_AVAILABILITY_FLOOR_PCT = 50.0


@dataclasses.dataclass
class ChaosReport:
    """Aggregated result of one chaos run (see module docstring)."""

    schedules: int = 0
    fault_events: int = 0
    word_drift: int = 0            # invariant 1 failures
    replan_mismatches: int = 0     # invariant 2 failures
    check_diagnostics: int = 0     # invariant 3: error diagnostics seen
    availability_breaches: int = 0  # invariant 4 failures
    availability_min_pct: float = 100.0
    availability_sum_pct: float = 0.0
    served_ok: int = 0
    requests: int = 0
    sheds: int = 0
    retries: int = 0
    breaker_opens: int = 0
    degraded_p99_max_ms: float = 0.0
    violations: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def availability_mean_pct(self) -> float:
        return (self.availability_sum_pct / self.schedules
                if self.schedules else 100.0)

    def summary(self) -> str:
        status = "OK" if self.ok else f"{len(self.violations)} VIOLATIONS"
        lines = [
            f"# chaos: {self.schedules} schedules, "
            f"{self.fault_events} fault events — {status}",
            f"word drift          {self.word_drift}",
            f"replan mismatches   {self.replan_mismatches}",
            f"check diagnostics   {self.check_diagnostics}",
            f"availability        min {self.availability_min_pct:.1f}% "
            f"mean {self.availability_mean_pct:.1f}% "
            f"(breaches {self.availability_breaches})",
            f"service             {self.served_ok}/{self.requests} ok, "
            f"{self.sheds} shed, {self.retries} retries, "
            f"{self.breaker_opens} breaker opens, "
            f"degraded p99 <= {self.degraded_p99_max_ms:.2f}ms",
        ]
        lines.extend(f"VIOLATION {v}" for v in self.violations[:20])
        return "\n".join(lines)


def _plan_equal(a, b) -> bool:
    """Bit-for-bit plan equality: totals, schedules, residency."""
    return (a.total_words == b.total_words
            and a.baseline_words == b.baseline_words
            and a.schedules == b.schedules
            and a.resident_tensors == b.resident_tensors
            and a.peak_resident_bytes == b.peak_resident_bytes)


def run_chaos(n_schedules: int = 50, *, smoke: bool = True, seed0: int = 0,
              availability_floor_pct: float = DEFAULT_AVAILABILITY_FLOOR_PCT,
              strict: bool = False,
              serve: bool = True) -> ChaosReport:
    """Run ``n_schedules`` seeded fault schedules through every invariant.

    ``smoke`` restricts the zoo to its first two CNNs (the CI
    configuration); ``serve=False`` skips the planner-service stage
    (invariants 1-3 only — used by fast unit tests). With ``strict`` the
    first violation raises `repro_torch.errors.InvariantViolation` instead of
    being collected.
    """
    from repro_torch.check import check as static_check
    from repro_torch.check.diagnostics import errors as error_diags
    from repro_torch.core.cnn_zoo import PAPER_CNNS
    from repro_torch.launch.planserve import run_fault_load
    from repro_torch.plan import PlanContext, plan_graph
    from repro_torch.plan.fleet import plan_graph_loop
    from repro_torch.sim.network import simulate_network

    names = list(PAPER_CNNS)[:2] if smoke else list(PAPER_CNNS)
    controllers = ("passive", "active")
    ctx = PlanContext()
    rep = ChaosReport()
    oracle_memo: dict = {}     # degraded key -> frozen-loop reference plan
    check_memo: dict = {}      # degraded key -> error-diagnostic count

    def violate(msg: str) -> None:
        rep.violations.append(msg)
        if strict:
            raise InvariantViolation(msg)

    for i in range(n_schedules):
        seed = seed0 + i
        sched = generate_schedule(seed)
        rep.schedules += 1
        rep.fault_events += len(sched)
        net = names[i % len(names)]
        controller = controllers[(i // len(names)) % 2]
        base = plan_graph(net, controller=controller, context=ctx)

        # 1. word invariance + monotone degraded time under machine faults.
        sim_faults = sched.sim_faults()
        clean = simulate_network(base)
        faulted = simulate_network(base, faults=sim_faults)
        if faulted.as_traffic_report() != clean.as_traffic_report():
            rep.word_drift += 1
            violate(f"seed {seed} {net}/{controller}: word drift under "
                    f"{sim_faults}")
        if faulted.cycles < clean.cycles:
            rep.word_drift += 1
            violate(f"seed {seed} {net}/{controller}: faulted cycles "
                    f"{faulted.cycles} < clean {clean.cycles}")

        # 2. degraded replan == fresh frozen-reference plan, word for word.
        plan_faults = sched.plan_faults()
        degraded = apply_to_plan(base, plan_faults)
        args = degraded_plan_args(plan_faults, plan_args_of(base))
        key = (net, args)
        if degraded is not base or key not in oracle_memo:
            oracle = oracle_memo.get(key)
            if oracle is None:
                oracle = plan_graph_loop(
                    net, args.budget, base.strategy, args.controller,
                    args.residency_bytes, base.beam_width)
                oracle_memo[key] = oracle
            if not _plan_equal(degraded, oracle):
                rep.replan_mismatches += 1
                violate(f"seed {seed} {net}/{controller}: replan after "
                        f"{plan_faults} diverges from fresh plan at {args}")

        # 3. the surviving plan passes static verification.
        if key not in check_memo:
            check_memo[key] = len(error_diags(static_check(degraded)))
        if check_memo[key]:
            rep.check_diagnostics += check_memo[key]
            violate(f"seed {seed} {net}/{controller}: {check_memo[key]} "
                    f"check error(s) on degraded plan at {args}")

        # 4. the hardened service keeps the availability floor.
        if serve:
            load = run_fault_load(sched, seed=seed, smoke=smoke)
            rep.availability_min_pct = min(rep.availability_min_pct,
                                           load["availability_pct"])
            rep.availability_sum_pct += load["availability_pct"]
            rep.served_ok += load["served_ok"]
            rep.requests += load["requests"]
            rep.sheds += load["sheds"]
            rep.retries += load["retries"]
            rep.breaker_opens += load["breaker_opens"]
            rep.degraded_p99_max_ms = max(rep.degraded_p99_max_ms,
                                          load["degraded_p99_virtual_ms"])
            if load["availability_pct"] < availability_floor_pct:
                rep.availability_breaches += 1
                violate(f"seed {seed}: availability "
                        f"{load['availability_pct']:.1f}% < floor "
                        f"{availability_floor_pct:.1f}%")
    return rep


def _main(argv: Optional[list] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.faults",
        description="seeded chaos run over the zoo + planner service")
    ap.add_argument("--schedules", type=int, default=50)
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--no-serve", action="store_true",
                    help="skip the planner-service stage (invariants 1-3)")
    ap.add_argument("--floor", type=float,
                    default=DEFAULT_AVAILABILITY_FLOOR_PCT)
    args = ap.parse_args(argv)
    rep = run_chaos(args.schedules, smoke=args.smoke, seed0=args.seed0,
                    availability_floor_pct=args.floor,
                    serve=not args.no_serve)
    print(rep.summary())
    return 0 if rep.ok else 1


if __name__ == "__main__":
    raise SystemExit(_main())
