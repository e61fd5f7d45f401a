"""The port's planner service (`repro_torch.launch.planserve`) and the obs
CLI (`python -m repro_torch.obs`) against the live reference: served plans
equal to individual ``plan_graphs`` calls and to the reference's NetPlans
(schedules and words with ``==``), the load report's deterministic fields
equal to the reference's and its histogram percentiles within 1% of
``np.percentile``, the speedup report's words equal, the hardened server's
fault half (ROADMAP A10(b)) equal to the reference's, and the CLI's three
commands."""

import dataclasses
import json

import pytest

from repro import faults as jfaults
from repro import obs as jobs
from repro import plan as jplan
from repro.launch import planserve as jps
from repro_torch import faults as tfaults
from repro_torch import obs as tobs
from repro_torch import plan as tplan
from repro_torch.launch import planserve as tps
from repro_torch.obs.__main__ import main as obs_main


@pytest.fixture(autouse=True)
def _fresh_caches():
    for p in (jplan, tplan):
        p.clear_plan_graph_cache()
    yield
    for p in (jplan, tplan):
        p.clear_plan_graph_cache()


def _sched(s):
    return None if s is None else (s.kind, s.bm, s.bn, s.bk, s.controller.value)


def _view(p):
    """A NetPlan's schedules and words, in a form both packages share."""
    return {
        "graph": p.graph.name, "controller": p.controller.value,
        "nodes": [(n.name, _sched(n.schedule)) for n in p.nodes],
        "baseline": [_sched(b.schedule) for b in p.baseline],
        "edges": [(e.tensor, e.words, e.resident, e.read_words, e.write_words)
                  for e in p.edges],
        "resident": p.resident_tensors,
        "peak_resident_bytes": p.peak_resident_bytes,
        "words": (p.total_words, p.baseline_words),
    }


REQUESTS = [dict(graph="alexnet"),
            dict(graph="squeezenet", controller="active"),
            dict(graph="alexnet", strategy="paper_opt"),
            dict(graph="alexnet"),
            dict(graph="resnet18", strategy="paper_opt", controller="active",
                 budget=512)]


def test_serve_matches_individual_calls_and_reference():
    server = tps.PlanServer()
    with tobs.tracing() as tr:
        plans = server.serve([tps.PlanRequest(**r) for r in REQUESTS])
    assert server.served == len(REQUESTS)
    assert plans[0] is plans[3]                   # one plan per duplicate
    (batch,) = [s for s in tr.spans if s.name == "planserve.batch"]
    assert dict(batch.attrs) == {"requests": 5, "groups": 4}
    assert batch.cat == "serve"
    want = jps.PlanServer().serve([jps.PlanRequest(**r) for r in REQUESTS])
    tplan.clear_plan_graph_cache()
    for req, got, ref in zip(REQUESTS, plans, want):
        single = tplan.plan_graphs([req["graph"]], req.get("budget"),
                                   req.get("strategy", "exact_opt"),
                                   req.get("controller", "passive"))[0]
        assert _view(got) == _view(single) == _view(ref)


def test_server_counters_count_requests_and_batches():
    served = tobs.REGISTRY.counter("planserve_requests_served")
    batches = tobs.REGISTRY.counter("planserve_batches")
    n0, b0 = served.value, batches.value
    server = tps.PlanServer()
    server.serve([tps.PlanRequest(graph="alexnet")] * 3)
    server.serve([tps.PlanRequest(graph="alexnet")])
    assert served.value - n0 == 4.0 and batches.value - b0 == 2.0


def test_catalog_matches_reference():
    for smoke in (True, False):
        got, want = tps.catalog(smoke), jps.catalog(smoke)
        assert [(r.graph, r.strategy, r.controller, r.params()) for r in got] \
            == [(r.graph, r.strategy, r.controller, r.params()) for r in want]
    assert tps.STRATEGIES == jps.STRATEGIES
    assert tps.CONTROLLERS == jps.CONTROLLERS


def test_run_load_matches_reference():
    kw = dict(requests=8, rate_per_s=1e6, batch_max=4, smoke=True)
    hist = tobs.REGISTRY.histogram("planserve_latency_seconds")
    n0 = hist.count
    with tobs.tracing() as tr:
        got = tps.run_load(**kw)
    want = jps.run_load(**kw)
    for key in ("requests", "catalog_size", "batches", "batch_max",
                "rate_per_s"):
        assert got[key] == want[key], key
    assert got["p50_ms"] <= got["p99_ms"] and got["plans_per_s"] > 0
    for q in ("p50", "p99"):
        assert got[f"{q}_ms_hist"] == pytest.approx(got[f"{q}_ms"], rel=0.01)
    assert hist.count - n0 == 8
    # one planserve.batch span per batch, and a virtual-clock queue and
    # serve pair per request, the serve span the queue span's child
    batches = [s for s in tr.spans if s.name == "planserve.batch"]
    assert len(batches) == got["batches"]
    queues = {s.span_id: s for s in tr.spans if s.name.startswith("queue ")}
    serves = [s for s in tr.spans if s.name.startswith("serve ")]
    assert len(queues) == len(serves) == 8
    assert all(s.parent_id in queues and s.cat == "serve" for s in serves)
    assert sorted(dict(s.attrs)["request"] for s in serves) == list(range(8))


def test_run_speedup_matches_reference():
    got = tps.run_speedup(passes=1, smoke=True)
    want = jps.run_speedup(passes=1, smoke=True)
    assert got["word_mismatches"] == want["word_mismatches"] == 0
    assert got["fleet_total_mwords"] == want["fleet_total_mwords"]
    assert got["stream_requests"] == want["stream_requests"] == 2
    assert got["sequential_s"] > 0 and got["batched_s"] > 0
    assert got["batched_vs_sequential"] > 0


def _request(r):
    return (r.graph, r.budget, r.strategy, r.controller, r.residency_bytes,
            r.beam_width, r.objective)


def _degraded_answer(server, ps, faults):
    """A server's answer to a sim_latency request after an engine fault: the
    breaker's state, the degraded request and the plan it serves."""
    server.inject(faults.EngineDegrade(surviving_frac=0.5), now_s=0.0)
    req = server.degraded_request(ps.PlanRequest(
        graph="alexnet", controller="active", objective="sim_latency"))
    (netp,) = server.serve_degraded([req])
    return (server.breaker_open, server.breaker_opens, _request(req),
            _view(netp))


_FAULT_HALF = {
    "ServerPolicy": lambda obj, ps, faults: dataclasses.asdict(obj),
    "ResilientPlanServer": _degraded_answer,
    "fault_catalog": lambda obj, ps, faults: [_request(r) for r in obj],
    "run_fault_load": lambda obj, ps, faults: obj,
}


@pytest.mark.parametrize("name,args", [
    ("ServerPolicy", ()), ("ResilientPlanServer", ()),
    ("fault_catalog", (True,)), ("run_fault_load", ())])
def test_fault_half_waits_for_a10(name, args):
    """The hardened server's four names, which waited for ROADMAP A10(b),
    each equal to the reference's under the same call: the policy's
    fields, a server's answer to a degraded request, the fault catalog
    request by request, and the default fault-load report key by key."""
    got = _FAULT_HALF[name](getattr(tps, name)(*args), tps, tfaults)
    want = _FAULT_HALF[name](getattr(jps, name)(*args), jps, jfaults)
    assert got == want


def test_main_prints_the_report(capsys):
    report = tps.main(["--smoke", "--requests", "4", "--passes", "1",
                       "--json"])
    assert json.loads(capsys.readouterr().out) == report
    assert set(report) == {"load", "speedup"}
    assert report["speedup"]["word_mismatches"] == 0


# --------------------------------------------------------------------- CLI
def test_cli_metrics_dumps_json_and_prometheus(capsys):
    assert obs_main(["metrics", "--no-warm"]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert "plan_graph_cache" in snap and "plan_cache" in snap
    assert obs_main(["metrics", "--no-warm", "--prometheus"]) == 0
    assert "# TYPE plan_graph_cache counter" in capsys.readouterr().out


def test_cli_metrics_warm_serves_plans(capsys):
    assert obs_main(["metrics"]) == 0
    snap = json.loads(capsys.readouterr().out)
    assert snap["planserve_requests_served"]["values"][0]["value"] >= 6
    hits = {v["labels"]["event"]: v["value"]
            for v in snap["plan_graph_cache"]["values"]}
    assert hits["hits"] >= 2


def test_cli_trace_load_writes_span_trace(tmp_path, capsys):
    out = tmp_path / "spans.json"
    assert obs_main(["trace-load", "--smoke", "--requests", "6", "--out",
                     str(out)]) == 0
    doc = json.loads(out.read_text())
    events = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    assert all(e["ph"] in ("X", "M") for e in events)
    xs = [e for e in events if e["ph"] == "X"]
    assert all(e["ts"] >= 0.0 and e["dur"] >= 0.0 for e in xs)
    assert {"planserve.batch", "fleet.plan_graphs"} <= {e["name"] for e in xs}
    assert sum(e["name"].startswith("serve ") for e in xs) == 6
    assert "wrote" in capsys.readouterr().out
    assert not tobs.enabled() and not jobs.enabled()


def test_cli_export_waits_for_a10(tmp_path, capsys):
    """``export`` waited for the SoC simulator (ROADMAP A10(a)); it now
    writes the reference's timeline of the same plan and exits 0."""
    from repro.obs import export as jexport
    out = tmp_path / "alexnet.json"
    assert obs_main(["export", "--net", "alexnet", "--out", str(out)]) == 0
    assert "wrote" in capsys.readouterr().out
    want = jexport.simreport_to_trace(jplan.plan_graph("alexnet").simulate())
    assert json.loads(out.read_text())["traceEvents"] == \
        json.loads(json.dumps(want))
