"""The port's observability layer (`repro_torch.obs`) against the live
reference (`repro.obs`): tracer semantics (nesting, parents, errors, thread
ids, the no-op span, `Stopwatch`), metric semantics, histogram quantiles,
the Prometheus text, the JSON snapshot and `spans_to_trace` compared with
``==``; the instrumented planner and check paths giving the reference's span
structure (names, categories, parents, attributes) with ``==``; and
``kernel.launch`` on the CPU route, one span per `launch.run` call."""

import json
import math
import threading

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import plan as jplan
from repro.check import api as japi
from repro.check import dataflow as jdataflow
from repro.check import kernels as jkernels
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.plan.graph import NetworkGraph as JGraph
from repro_torch import obs as tobs
from repro_torch import plan as tplan
from repro_torch.check import api as tapi
from repro_torch.check import dataflow as tdataflow
from repro_torch.check import kernels as tkernels
from repro_torch.kernels import conv2d_psum, flash_attention, launch, ops
from repro_torch.kernels import psum_matmul
from repro_torch.obs import export as texport
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import trace as ttrace
from repro_torch.plan.graph import NetworkGraph as TGraph


@pytest.fixture(autouse=True)
def _fresh_caches():
    for p in (jplan, tplan):
        p.clear_plan_cache()
        p.clear_plan_graph_cache()
    yield
    assert not tobs.enabled() and not jobs.enabled()


# ------------------------------------------------------------------ tracer
def test_disabled_span_is_shared_noop():
    assert not tobs.enabled()
    s1 = ttrace.span("a", cat="x", k=1)
    s2 = ttrace.span("b")
    assert s1 is s2 is ttrace._NOOP
    with s1 as sp:
        sp.set("ignored", 1)
    assert tobs.get_tracer() is None


def test_tracing_records_nested_spans_with_parents():
    with tobs.tracing() as tr:
        with ttrace.span("outer", cat="t", a=1):
            with ttrace.span("inner", cat="t") as sp:
                sp.set("late", "v")
    assert not tobs.enabled()
    assert len(tr) == 2
    by_name = {s.name: s for s in tr.spans}
    outer, inner = by_name["outer"], by_name["inner"]
    assert outer.parent_id is None
    assert inner.parent_id == outer.span_id
    assert dict(outer.attrs) == {"a": 1}
    assert dict(inner.attrs) == {"late": "v"}
    assert outer.dur_s >= inner.dur_s >= 0.0
    assert outer.cat == "t"


def test_tracing_restores_previous_tracer():
    base = tobs.enable()
    try:
        with tobs.tracing() as inner:
            with ttrace.span("in-scope"):
                pass
        assert tobs.get_tracer() is base
        assert len(inner) == 1 and len(base) == 0
    finally:
        assert tobs.disable() is base
    assert tobs.get_tracer() is None


def test_span_records_error_attr():
    with tobs.tracing() as tr:
        with pytest.raises(RuntimeError):
            with ttrace.span("boom", k=2):
                raise RuntimeError("x")
    (s,) = tr.spans
    assert dict(s.attrs) == {"k": 2, "error": "RuntimeError"}


def test_tracer_record_external_interval_and_clear():
    tr = ttrace.Tracer()
    parent = tr.record("virtual", 10.0, 2.5, cat="serve")
    child = tr.record("child", 10.5, 1.0, parent_id=parent.span_id,
                      attrs=(("req", 3),))
    assert child.parent_id == parent.span_id != child.span_id
    assert tr.spans[0].t0_s == 10.0 and tr.spans[0].dur_s == 2.5
    assert tr.next_id() == 3
    tr.clear()
    assert len(tr) == 0


def test_spans_carry_thread_ids():
    with tobs.tracing() as tr:
        with ttrace.span("main-side"):
            pass
        t = threading.Thread(target=lambda: ttrace.span("worker")
                             .__enter__().__exit__(None, None, None))
        t.start()
        t.join()
    tids = {s.name: s.thread_id for s in tr.spans}
    assert tids["main-side"] == threading.get_ident() != tids["worker"]


def test_stopwatch_measures_and_spans_when_named():
    with tobs.Stopwatch() as sw:
        pass
    assert sw.s >= 0.0
    assert sw.us == sw.s * 1e6 and sw.ms == sw.s * 1e3
    with tobs.tracing() as tr:
        with tobs.Stopwatch("timed.step", cat="c") as named:
            with ttrace.span("inside"):
                pass
        with tobs.Stopwatch() as anon:
            pass
    assert anon.s >= 0.0 and named.s >= 0.0
    assert [(s.name, s.cat) for s in tr.spans] == [("inside", "repro"),
                                                  ("timed.step", "c")]
    assert tr.spans[0].parent_id == tr.spans[1].span_id
    assert tr.spans[1].dur_s >= named.s


def test_trace_api_names_match_reference():
    assert tobs.__all__ == jobs.__all__
    assert ttrace.__all__ == jobs.trace.__all__
    assert tmetrics.__all__ == jmetrics.__all__
    assert tmetrics.HIST_BUCKET_RATIO == jmetrics.HIST_BUCKET_RATIO == 1.005


# ----------------------------------------------------------------- metrics
def test_counter_semantics():
    reg = tmetrics.Registry()
    c = reg.counter("c", "help text")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    c.reset()
    assert c.value == 0.0
    assert reg.counter("c") is c


def test_gauge_and_callback_gauge():
    reg = tmetrics.Registry()
    g = reg.gauge("g")
    g.set(4.0)
    g.inc()
    g.dec(2.0)
    assert g.value == 3.0
    box = {"v": 7.0}
    cb = reg.gauge("cb", fn=lambda: box["v"])
    assert cb.value == 7.0
    box["v"] = 9.0
    assert cb.value == 9.0
    with pytest.raises(ValueError):
        cb.set(1.0)
    with pytest.raises(ValueError):
        cb.inc()


def test_registry_kind_conflict_families_unregister():
    reg = tmetrics.Registry()
    reg.counter("m", labels={"k": "a"})
    reg.counter("m", labels={"k": "b"})
    reg.gauge("other")
    with pytest.raises(ValueError):
        reg.histogram("m", labels={"k": "a"})
    assert len(reg.family("m")) == 2 and len(reg) == 3
    assert reg.families() == ["m", "other"]
    assert reg.get("m", {"k": "a"}) is not None
    assert reg.get("m", {"k": "zz"}) is None
    assert reg.unregister("m") == 2
    assert reg.families() == ["other"]


def _registry_ops(mod):
    """The same sequence of operations on a fresh registry of ``mod``."""
    reg = mod.Registry()
    reg.counter("hits", "cache hits", labels={"cache": "plan"}).inc(5)
    reg.counter("hits", "cache hits", labels={"cache": "graph"}).inc(0.25)
    reg.gauge("depth", "queue depth").set(3.5)
    reg.gauge("cb", "sampled", labels={"field": "x"}, fn=lambda: 17)
    h = reg.histogram("lat", "latency")
    for v in (0.0, 1.0, 2.0, 1e-3, 123.456):
        h.observe(v)
    reg.histogram("empty", "no samples")
    reg.counter("bare")
    rng = np.random.default_rng(3)
    h2 = reg.histogram("lat", "latency", labels={"route": "b"})
    for v in rng.lognormal(-5.0, 2.0, size=300):
        h2.observe(float(v))
    return reg


def test_registry_snapshot_and_prometheus_equal_reference():
    got, want = _registry_ops(tmetrics), _registry_ops(jmetrics)
    assert got.snapshot() == want.snapshot()
    assert got.render_prometheus() == want.render_prometheus()
    assert got.families() == want.families()
    text = got.render_prometheus()
    assert "# HELP hits cache hits" in text
    assert 'hits{cache="plan"} 5' in text
    assert 'lat_bucket{le="0.0"} 1' in text
    assert 'lat_bucket{route="b",le="+Inf"} 300' in text
    assert json.dumps(got.snapshot())
    assert tmetrics.Registry().render_prometheus() == ""


@pytest.mark.parametrize("seed", [0, 7])
def test_histogram_quantiles_equal_reference(seed):
    rng = np.random.default_rng(seed)
    samples = np.concatenate([rng.lognormal(0.0, 1.5, size=400),
                              rng.uniform(1e-4, 1e3, size=400),
                              np.zeros(5)])
    got, want = tmetrics.Histogram("h"), jmetrics.Histogram("h")
    for v in samples:
        got.observe(float(v))
        want.observe(float(v))
    for q in (0.0, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0):
        assert got.quantile(q) == want.quantile(q), q
    for p in (1, 10, 50, 90, 99):
        assert got.percentile(p) == pytest.approx(
            float(np.percentile(samples, p)), rel=0.01, abs=1e-12)
    assert got.snapshot_value() == want.snapshot_value()
    assert math.isnan(tmetrics.Histogram("e").quantile(0.5))
    with pytest.raises(ValueError):
        got.quantile(1.5)


def test_stats_counter_mirrors_positive_deltas():
    name = "test_torch_stats_counter_mirror"
    tobs.REGISTRY.unregister(name)
    sc = tmetrics.StatsCounter(metric=name)
    sc["grid_hits"] += 3
    sc["grid_hits"] += 2
    sc["evals"] += 1
    sc["evals"] -= 1
    assert sc["grid_hits"] == 5 and sc["evals"] == 0
    assert tobs.REGISTRY.get(name, {"key": "grid_hits"}).value == 5.0
    assert tobs.REGISTRY.get(name, {"key": "evals"}).value == 1.0
    assert sc.most_common(1) == [("grid_hits", 5)]
    tobs.REGISTRY.unregister(name)


def test_plan_caches_read_through_registry_as_ints():
    info0 = tplan.plan_graph_cache_info()
    assert info0.hits == 0 and info0.misses == 0
    tplan.plan_graph("alexnet", 2048, "paper_opt", "passive")
    tplan.plan_graph("alexnet", 2048, "paper_opt", "passive")
    info = tplan.plan_graph_cache_info()
    assert isinstance(info.hits, int) and isinstance(info.misses, int)
    assert (info.hits, info.misses, info.currsize) == (1, 1, 1)
    reg = tobs.REGISTRY
    assert reg.get("plan_graph_cache", {"event": "hits"}).value == 1.0
    assert reg.get("plan_graph_cache", {"event": "misses"}).value == 1.0
    assert reg.get("plan_graph_cache_size").value == 1.0
    lru = tplan.plan_cache_info()
    for field in ("hits", "misses", "currsize"):
        assert reg.get("plan_cache", {"field": field}).value == \
            float(getattr(lru, field))
    ctx = tplan.PlanContext()
    assert isinstance(ctx.stats, tmetrics.StatsCounter)
    tplan.plan_graphs(["alexnet", "squeezenet"], 2048, "exact_opt", "active",
                      context=ctx)
    grid = reg.get("plan_context_stats", {"key": "grid_misses"})
    assert ctx.stats["grid_misses"] > 0 and grid.value >= ctx.stats["grid_misses"]
    tplan.clear_plan_graph_cache()
    info1 = tplan.plan_graph_cache_info()
    assert info1.hits == 0 and info1.misses == 0 and info1.currsize == 0


# ------------------------------------------------------------------ export
def _fill(mod, tr):
    a = tr.record("outer", 5.0, 2.0, cat="t", attrs=(("k", 1),))
    tr.record("inner", 5.5, 0.25, cat="t", parent_id=a.span_id,
              attrs=(("grid", (2, 3)), ("device", "cpu")))
    tr.record("later", 8.0, 0.0, cat="serve")
    tr.record("first", 4.0, 0.5)
    return tr


def test_spans_to_trace_equals_reference():
    got = _fill(tobs, ttrace.Tracer())
    want = _fill(jobs, jobs.trace.Tracer())
    assert texport.spans_to_trace(got) == jexport.spans_to_trace(want)
    assert texport.spans_to_trace(got, pid=3, process_name="unit") == \
        jexport.spans_to_trace(want, pid=3, process_name="unit")
    assert texport.spans_to_trace(ttrace.Tracer()) == \
        jexport.spans_to_trace(jobs.trace.Tracer())
    events = texport.spans_to_trace(got)
    assert texport.trace_json(events) == jexport.trace_json(events)
    xs = [e for e in events if e["ph"] == "X"]
    assert xs[0]["name"] == "first" and xs[0]["ts"] == 0.0
    assert all(e["ts"] >= 0.0 and e["dur"] >= 0.0 for e in xs)


def test_write_trace_equals_reference(tmp_path):
    events = texport.spans_to_trace(_fill(tobs, ttrace.Tracer()))
    a, b = tmp_path / "t.json", tmp_path / "j.json"
    with open(a, "w") as fp:
        texport.write_trace(events, fp)
    with open(b, "w") as fp:
        jexport.write_trace(events, fp)
    assert a.read_text() == b.read_text()
    doc = json.loads(a.read_text())
    assert doc["displayTimeUnit"] == "ms"
    assert doc["traceEvents"] == json.loads(json.dumps(events))


def test_sim_exporters_wait_for_a10():
    for fn, args in ((texport.simreport_to_trace, (None,)),
                     (texport.verify_sim_trace, (None, []))):
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            fn(*args)


# ------------------------------------------- instrumented paths, span parity
def _structure(tracer):
    """(name, cat, parent's name, attributes) of every span, in order."""
    by_id = {s.span_id: s for s in tracer.spans}
    return [(s.name, s.cat,
             by_id[s.parent_id].name if s.parent_id is not None else None,
             s.attrs) for s in tracer.spans]


def _preflight(mod_plan, mod_graph, mod_kernels):
    g = mod_graph.from_cnn("resnet18").shrink(8, 8)
    scheds = {p.workload.name: p.schedule
              for p in mod_plan.plan_many(list(g.workloads), 2048,
                                          "exact_opt", "active")}
    return lambda: mod_kernels.preflight_network_kernels(g, scheds)


def _one_layer(mod_plan):
    wl = mod_plan.conv_workloads("resnet18")[3]
    return lambda: mod_plan.plan(wl, 2048, "paper_opt", "active")


CALLS = {
    "plan_graphs": lambda p, a, d, k, g: lambda: p.plan_graphs(
        ["mobilenet", "mnasnet"], 2048, "exact_opt", "active"),
    "plan_graph": lambda p, a, d, k, g: lambda: (
        p.plan_graph("resnet18", 2048, "exact_opt", "passive"),
        p.plan_graph("resnet18", 2048, "exact_opt", "passive")),
    "plan": lambda p, a, d, k, g: _one_layer(p),
    "check_plans": lambda p, a, d, k, g: lambda: a.check_plans(
        ("alexnet", "resnet18")),
    "check_dataflow": lambda p, a, d, k, g: lambda: d.check_dataflow(),
    "preflight": lambda p, a, d, k, g: _preflight(p, g, k),
}


@pytest.mark.parametrize("case", sorted(CALLS))
def test_instrumented_spans_equal_reference(case):
    want_fn = CALLS[case](jplan, japi, jdataflow, jkernels, JGraph)
    got_fn = CALLS[case](tplan, tapi, tdataflow, tkernels, TGraph)
    with jobs.tracing() as want:
        want_fn()
    with tobs.tracing() as got:
        got_fn()
    assert len(got) > 0
    assert _structure(got) == _structure(want)


def test_check_stopwatch_timings_come_from_their_spans():
    with tobs.tracing() as tr:
        _, timings = tapi.check_plans(("alexnet",), ("active",))
    (sw,) = [s for s in tr.spans if s.name == "check.plans/alexnet/active"]
    assert sw.cat == "check" and sw.dur_s >= timings["alexnet/active"] > 0.0
    with tobs.tracing() as tr:
        _, timings = tdataflow.check_dataflow()
    spans = {s.name: s for s in tr.spans}
    for key in ("kernels", "space/resnet18", "space/gemm"):
        assert spans[f"check.dataflow/{key}"].dur_s >= timings[key] > 0.0


def test_sweep_rows_time_plan_many():
    rows = tplan.dse.sweep(["resnet18"], (512, 2048), ("exact_opt",),
                           ("passive", "active"))
    assert len(rows) == 4
    assert all(isinstance(r["us_per_call"], float) and r["us_per_call"] >= 0.0
               for r in rows)


# -------------------------------------------- kernel.launch, the CPU route
def _conv_call():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(20, 10, 10, generator=g)
    w = torch.randn(12, 20, 3, 3, generator=g)
    return lambda: conv2d_psum.conv2d_psum(x, w, block_m=8, block_n=8)


def _matmul_call(controller):
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn(40, 72, generator=g), torch.randn(72, 24, generator=g)
    return lambda: psum_matmul.psum_matmul(x, w, bm=16, bn=16, bk=32,
                                           controller=controller)


def _flash_call(decode):
    g = torch.Generator().manual_seed(2)
    sq = 1 if decode else 24
    q = torch.randn(4, sq, 32, generator=g)
    k, v = torch.randn(2, 2, 40, 32, generator=g)
    if decode:
        return lambda: flash_attention.flash_attention(
            q, k, v, q_offset=torch.tensor(30), kv_valid_len=torch.tensor(31))
    return lambda: flash_attention.flash_attention(q, k, v, bq=16, bk=16)


LAUNCH_CALLS = {
    "conv2d_psum": _conv_call,
    "psum_matmul/active": lambda: _matmul_call("active"),
    "psum_matmul/passive": lambda: _matmul_call("passive"),
    "flash_attention": lambda: _flash_call(False),
    "flash_attention/split_kv": lambda: _flash_call(True),
    "ops.matmul": lambda: (lambda: ops.matmul(torch.ones(8, 16),
                                              torch.ones(16, 8))),
}


@pytest.mark.parametrize("case", sorted(LAUNCH_CALLS))
def test_kernel_launch_span_per_run_call_on_cpu(case, monkeypatch):
    fn = LAUNCH_CALLS[case]()
    plans = []
    real_run = launch.run

    def counting_run(plan, *operands, **extra):
        plans.append(plan)
        return real_run(plan, *operands, **extra)

    monkeypatch.setattr(launch, "run", counting_run)
    with tobs.tracing() as tr:
        fn()
        fn()
    spans = [s for s in tr.spans if s.name == "kernel.launch"]
    assert len(plans) == 2 and len(spans) == 2
    for s, p in zip(spans, plans):
        assert s.cat == "kernel"
        assert dict(s.attrs) == {"plan": p.name, "grid": p.grid,
                                 "device": "cpu", "body": p.body,
                                 "launches": p.launches}
    # the same calls with tracing off record nothing and leave no tracer
    fn()
    assert len(plans) == 3 and tobs.get_tracer() is None


def test_kernel_launch_span_records_a_refused_launch():
    plan = launch.LaunchPlan(
        name="unit", grid=(1,), threads=1, smem_bytes=0, launches=1,
        loops=(), inputs=(launch.OperandPlan("x", (2,), (2,)),), outputs=(),
        scratch=(), cuda=None, plain=lambda x: 1 / 0, body="plain")
    with tobs.tracing() as tr:
        with pytest.raises(ZeroDivisionError):
            launch.run(plan, torch.zeros(2))
        with pytest.raises(ValueError):
            launch.run(plan, torch.zeros(3))       # refused before the span
    (s,) = tr.spans
    assert dict(s.attrs)["error"] == "ZeroDivisionError"
