"""The port's fault harness (`repro_torch.faults.inject`, `.chaos`, ``python
-m repro_torch.faults``) and the hardened planner service's fault half
(`repro_torch.launch.planserve`) against the live reference (`repro.faults`,
`repro.launch.planserve`) with ``==``: seeded schedules, the fold of the
degraded plan parameters, replan after a fault equal to a fresh plan (and
to the reference's), the breaker, the virtual service and backoff models,
the fault-load report, storm windows and the chaos harness."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

from repro import faults as jfaults
from repro import plan as jplan
from repro import sim as jsim
from repro.launch import planserve as jps
from repro_torch import errors as terrors
from repro_torch import faults as tfaults
from repro_torch import plan as tplan
from repro_torch import sim as tsim
from repro_torch.faults.chaos import _plan_equal
from repro_torch.launch import planserve as tps
from repro_torch.plan.fleet import plan_graph_loop

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKGS = {"port": (tfaults, tplan, tps), "ref": (jfaults, jplan, jps)}


def _fault(f) -> tuple:
    fields = {k: getattr(v, "value", v) for k, v in dataclasses.asdict(f).items()}
    return (type(f).__name__, tuple(sorted(fields.items())))


def _schedule(s) -> tuple:
    return (s.seed, s.horizon_s, tuple((e.t_s, _fault(e.fault)) for e in s))


def _args(a) -> tuple:
    return (a.budget, a.residency_bytes, a.controller.value)


def _plan(p) -> tuple:
    return (p.total_words, p.baseline_words, p.resident_tensors,
            p.peak_resident_bytes, p.controller.value, p.budget,
            tuple((n, s.bm, s.bn, s.controller.value)
                  for n, s in p.schedules.items()))


@pytest.fixture(autouse=True)
def _fresh_caches():
    for p in (jplan, tplan):
        p.clear_plan_graph_cache()
    yield
    for p in (jplan, tplan):
        p.clear_plan_graph_cache()


def test_exports_equal_reference():
    assert tfaults.__all__ == jfaults.__all__
    for name in ("SURVIVING_FRACS", "THROTTLE_FACTORS", "STORM_FACTORS",
                 "DEFAULT_AVAILABILITY_FLOOR_PCT"):
        assert getattr(tfaults, name) == getattr(jfaults, name), name


def test_schedules_are_seed_reproducible_and_equal_reference():
    for seed in range(12):
        a, b = tfaults.generate_schedule(seed), tfaults.generate_schedule(seed)
        assert a == b and a.seed == seed and 1 <= len(a) <= 3
        ts = [e.t_s for e in a]
        assert ts == sorted(ts) and all(0.0 <= t < 1.0 for t in ts)
        assert all(f.affects_sim for f in a.sim_faults())
        assert all(f.affects_plan for f in a.plan_faults())
        assert _schedule(a) == _schedule(jfaults.generate_schedule(seed))
    kw = dict(horizon_s=2.5, max_events=6)
    assert (_schedule(tfaults.generate_schedule(99, **kw))
            == _schedule(jfaults.generate_schedule(99, **kw)))


def _fold(pkg):
    faults, plan, _ = PKGS[pkg]
    ctrl = plan.Controller.ACTIVE
    base = faults.PlanArgs(budget=None, residency_bytes=1 << 20, controller=ctrl)
    half = faults.EngineDegrade(surviving_frac=0.5).apply_plan(base)
    out = faults.degraded_plan_args(
        [faults.VmemShrink(surviving_frac=0.5), faults.VmemShrink(surviving_frac=0.5),
         faults.ControllerFallback(), faults.DramThrottle()], base)
    return _args(half), _args(out)


def test_degraded_plan_args_fold():
    half, out = _fold("port")
    assert half[0] == tplan.DEFAULT_P_MACS // 2
    assert out == (None, (1 << 20) // 4, "passive")  # degradations compound
    assert (half, out) == _fold("ref")


@pytest.mark.parametrize("frac,vfrac,fallback,ctrl", [
    (0.25, 0.5, False, "active"), (0.5, 0.75, True, "active"),
    (0.75, 0.25, False, "passive"), (0.5, 0.5, True, "passive"),
    (0.25, 0.75, True, "active"), (0.75, 0.5, True, "passive")])
def test_replan_after_fault_matches_fresh_plan(frac, vfrac, fallback, ctrl):
    """The degradation path is bit for bit a fresh plan under the degraded
    parameters (the frozen cache-bypassing loop planner), and the
    reference's degraded plan."""
    got = {}
    for pkg, (faults, plan, _) in PKGS.items():
        base = plan.plan_graph("alexnet", 2048, "exact_opt", ctrl)
        fs = [faults.EngineDegrade(surviving_frac=frac),
              faults.VmemShrink(surviving_frac=vfrac)]
        if fallback:
            fs.append(faults.ControllerFallback())
        got[pkg] = (base, faults.apply_to_plan(base, fs),
                    faults.degraded_plan_args(fs, faults.plan_args_of(base)))
    base, degraded, args = got["port"]
    oracle = plan_graph_loop("alexnet", args.budget, base.strategy,
                             args.controller, args.residency_bytes,
                             base.beam_width)
    assert _plan_equal(degraded, oracle)
    assert degraded.budget == args.budget and degraded.controller is args.controller
    assert _args(args) == _args(got["ref"][2])
    assert _plan(degraded) == _plan(got["ref"][1])


def test_apply_to_plan_noop_returns_same_object():
    base = tplan.plan_graph("alexnet", 2048, "exact_opt", "active")
    assert tfaults.apply_to_plan(base, [tfaults.DramThrottle(),
                                        tfaults.DmaStall()]) is base
    assert tfaults.apply_to_plan(base, [tfaults.ControllerFallback(
        to=tplan.Controller.ACTIVE)]) is base


def test_network_sim_words_invariant_over_seeded_schedules():
    got, want = [], []
    for faults, plan, sim, out in ((tfaults, tplan, tsim, got),
                                   (jfaults, jplan, jsim, want)):
        netp = plan.plan_graph("alexnet", 2048, "exact_opt", "active")
        clean = sim.simulate_network(netp)
        for seed in range(4):
            hurt = sim.simulate_network(
                netp, faults=faults.generate_schedule(seed).sim_faults())
            assert hurt.as_traffic_report() == clean.as_traffic_report()
            assert hurt.cycles >= clean.cycles
            out.append(hurt.cycles)
    assert got == want


def _breaker_run(pkg):
    faults, plan, ps = PKGS[pkg]
    srv = ps.ResilientPlanServer(seed=0)
    req = ps.PlanRequest(graph="alexnet", controller="active",
                         objective="sim_latency")
    srv.inject(faults.EngineDegrade(surviving_frac=0.5), now_s=0.0)
    trace = [srv.breaker_open, srv.breaker_opens]
    deg = srv.degraded_request(req)
    trace += [deg.budget, deg.objective]
    srv.maybe_close_breaker(now_s=10.0, backlog=0)   # engine fault still on
    trace.append(srv.breaker_open)
    srv.active_faults.clear()
    srv.maybe_close_breaker(now_s=10.0, backlog=0)
    trace += [srv.breaker_open, srv.mode_switches,
              srv.degraded_request(req).objective]
    return trace


def test_breaker_opens_on_engine_degrade_and_degrades_requests():
    got = _breaker_run("port")
    assert got == [True, 1, tplan.DEFAULT_P_MACS // 2, None, True, False, 2,
                   "sim_latency"]
    assert got == _breaker_run("ref")


def _service_models(pkg):
    _, _, ps = PKGS[pkg]
    pol = ps.ServerPolicy()
    srv = ps.ResilientPlanServer(pol, seed=3)
    healthy = srv.virtual_service_s(8)
    srv.open_breaker(0.0, reason="test")
    words = srv.virtual_service_s(8)
    backoff = [srv.backoff_s(a) for a in range(3)]
    seeded = ps.ResilientPlanServer(pol, seed=5)
    again = [seeded.backoff_s(a) for a in range(4)]
    return healthy, words, backoff, again


def test_virtual_service_and_backoff_models():
    healthy, words, backoff, again = _service_models("port")
    assert words < healthy                      # words mode is cheaper
    assert all(x > 0 for x in backoff) and backoff[2] > backoff[0]
    assert again == _service_models("port")[3]  # seeded
    assert (healthy, words, backoff, again) == _service_models("ref")


def _storm_schedule(faults):
    return faults.FaultSchedule(seed=123, horizon_s=1.0, events=(
        faults.FaultEvent(t_s=0.02, fault=faults.RequestStorm(
            rate_factor=8.0, duration_s=0.2)),
        faults.FaultEvent(t_s=0.05, fault=faults.EngineDegrade(
            surviving_frac=0.5)),
    ))


def test_run_fault_load_is_deterministic_and_equals_reference():
    sched = _storm_schedule(tfaults)
    a = tps.run_fault_load(sched, requests=48, seed=7, smoke=True)
    assert a == tps.run_fault_load(sched, requests=48, seed=7, smoke=True)
    assert a["requests"] > 48 and a["fault_events"] == 2
    assert a["breaker_opens"] >= 1
    assert (a["served_ok"] + a["sheds"] + a["expired"] + a["deadline_late"]
            == a["requests"])
    assert a == jps.run_fault_load(_storm_schedule(jfaults), requests=48,
                                   seed=7, smoke=True)
    healthy = tps.run_fault_load(None, requests=48, seed=7, smoke=True)
    assert healthy["availability_pct"] >= a["availability_pct"]
    assert healthy["fault_events"] == 0 and healthy["breaker_opens"] == 0


def test_storm_windows_shape():
    got = tfaults.storm_windows(_storm_schedule(tfaults))
    assert got == jfaults.storm_windows(_storm_schedule(jfaults))
    assert got == ((0.02, pytest.approx(0.22), 8.0),)


def test_chaos_harness_smoke_equals_reference():
    rep = tfaults.run_chaos(4, smoke=True, seed0=0)
    assert rep.ok and rep.violations == []
    assert rep.schedules == 4 and rep.fault_events >= 4
    assert rep.word_drift == rep.replan_mismatches == rep.check_diagnostics == 0
    assert rep.availability_min_pct >= tfaults.DEFAULT_AVAILABILITY_FLOOR_PCT
    assert "chaos: 4 schedules" in rep.summary()
    want = jfaults.run_chaos(4, smoke=True, seed0=0)
    assert dataclasses.asdict(rep) == dataclasses.asdict(want)
    assert rep.summary() == want.summary()


def test_chaos_strict_mode_raises_on_floor_breach():
    with pytest.raises(terrors.InvariantViolation, match="floor"):
        tfaults.run_chaos(2, smoke=True, seed0=0, availability_floor_pct=101.0,
                          strict=True)


def test_cli_smoke_exits_zero():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.faults", "--schedules", "4",
         "--smoke"], env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "chaos: 4 schedules" in out.stdout and "OK" in out.stdout
