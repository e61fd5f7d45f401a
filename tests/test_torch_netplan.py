"""The port's fused-residency network planner (`repro_torch.plan.netplan`,
`repro_torch.plan.fleet`) against the live reference (`repro.plan`): the
same schedules, residency sets, edges, word totals and peak bytes, compared
with ``==`` (the planner runs no kernel, so no tolerance), and the port's
runner fed a `NetPlan` against the reference's runner fed the reference's
(fp32 conv tolerance, 1e-4)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import plan as jplan
from repro.configs.registry import get_config as jget_config
from repro.core.cnn_zoo import PAPER_CNNS
from repro.core.cnn_zoo import get_cnn as jget_cnn
from repro.errors import BudgetError as JBudgetError
from repro.errors import PlanError as JPlanError
from repro.kernels import conv_network as jnet
from repro.plan import dse as jdse
from repro.plan import fleet as jfleet
from repro.plan import netplan as jnetplan
from repro.plan.graph import NetworkGraph as JGraph
from repro_torch import errors as terrors
from repro_torch import plan as tplan
from repro_torch.configs import get_config as tget_config
from repro_torch.core.cnn_zoo import get_cnn as tget_cnn
from repro_torch.kernels import conv_network as tnet
from repro_torch.plan import dse as tdse
from repro_torch.plan import fleet as tfleet
from repro_torch.plan import netplan as tnetplan

P = 2048
ZOO4 = ("alexnet", "squeezenet", "resnet18", "mobilenet")
WORD_FIELDS = ("interconnect_words", "input_words", "output_words",
               "sram_reads", "sram_writes")
REPORT_FIELDS = WORD_FIELDS + ("bytes",)
TOL = 1e-4


@pytest.fixture(autouse=True)
def _clear_graph_caches():
    tplan.clear_plan_graph_cache()
    jplan.clear_plan_graph_cache()
    yield
    tplan.clear_plan_graph_cache()
    jplan.clear_plan_graph_cache()


def _sched(s):
    return None if s is None else (s.kind, s.bm, s.bn, s.bk, s.controller.value)


def _words(rep):
    """A traffic report's word fields and its bytes."""
    return None if rep is None else tuple(getattr(rep, f) for f in REPORT_FIELDS)


def _wl(wl):
    if wl is None:
        return None
    if isinstance(wl, (tplan.ConvWorkload, jplan.ConvWorkload)):
        return ("conv", dataclasses.asdict(wl))
    if isinstance(wl, tplan.MatmulWorkload):
        return ("matmul", wl.name, wl.m, wl.n, wl.k, wl.in_dtype.itemsize,
                wl.acc_dtype.itemsize)
    return ("matmul", wl.name, wl.m, wl.n, wl.k, wl.in_bytes, wl.acc_bytes)


def _view(p):
    """Everything a NetPlan says, in a form both packages share."""
    return {
        "graph": p.graph.name, "budget": p.budget, "strategy": p.strategy,
        "controller": p.controller.value,
        "residency_bytes": p.residency_bytes, "beam_width": p.beam_width,
        "nodes": [(n.name, n.op, _wl(n.workload), _sched(n.schedule),
                   _words(n.traffic)) for n in p.nodes],
        "edges": [dataclasses.astuple(e) for e in p.edges],
        "traffic": _words(p.traffic),
        "baseline": [(_wl(b.workload), b.budget, _sched(b.schedule),
                      _words(b.traffic)) for b in p.baseline],
        "peak_resident_bytes": p.peak_resident_bytes,
        "resident": p.resident_tensors,
        "schedules": {k: _sched(v) for k, v in p.schedules.items()},
        "totals": (p.total_words, p.baseline_words, p.saving_pct),
    }


def _assert_python_ints(p):
    assert type(p.peak_resident_bytes) is int
    for e in p.edges:
        assert type(e.words) is int and type(e.nbytes) is int


# ------------------------------------------------------- the zoo, == parity
@pytest.mark.parametrize("net", PAPER_CNNS)
@pytest.mark.parametrize("strategy", ["exact_opt", "paper_opt"])
@pytest.mark.parametrize("controller", ["passive", "active"])
def test_plan_graph_matches_reference(net, strategy, controller):
    got = tplan.plan_graph(net, P, strategy, controller)
    want = jplan.plan_graph(net, P, strategy, controller)
    assert _view(got) == _view(want)
    _assert_python_ints(got)
    # tests/test_netplan.py's claims hold for the port's plan
    assert got.resident_tensors
    assert got.total_words < got.baseline_words
    assert got.peak_resident_bytes <= got.residency_bytes
    # the baseline is the per-layer pipeline's answer
    direct = tplan.plan_many(net, P, strategy, controller, exact_iters=True)
    assert [b.schedule for b in got.baseline] == [d.schedule for d in direct]
    # residency moves words off the bus and keeps the local accesses; the
    # resident edges' saved words are the difference
    spilled = tplan.network_report(got.graph, got.schedules)
    fused = tplan.network_report(got.graph, got.schedules,
                                 got.resident_tensors)
    assert _words(fused) == _words(got.traffic)
    assert (fused.sram_reads, fused.sram_writes) == (spilled.sram_reads,
                                                     spilled.sram_writes)
    saved = sum(e.saved_words for e in got.edges if e.resident)
    assert spilled.interconnect_words - fused.interconnect_words == saved


@pytest.mark.parametrize("net", PAPER_CNNS)
def test_zero_residency_gives_the_baseline(net):
    got = tplan.plan_graph(net, P, "exact_opt", "active", residency_bytes=0)
    assert not got.resident_tensors and got.saving_pct == 0.0
    assert got.total_words == got.baseline_words
    assert got.schedules == {n.name: b.schedule for n, b in
                             zip(got.graph.workload_nodes, got.baseline)}
    assert _view(got) == _view(jplan.plan_graph(net, P, "exact_opt", "active",
                                                residency_bytes=0))
    rep = tplan.network_report(got.graph, got.schedules)
    for field in WORD_FIELDS:
        assert getattr(rep, field) == sum(getattr(b.traffic, field)
                                          for b in got.baseline), field


@pytest.mark.parametrize("controller", ["passive", "active"])
def test_external_tensors_are_never_resident(controller):
    got = tplan.plan_graph("resnet18", P, "exact_opt", controller,
                           residency_bytes=1 << 62)
    for t in got.graph.inputs + got.graph.outputs:
        assert t not in got.resident_tensors
    out = got.graph.outputs[0]            # the final add ships its inputs
    prod = got.graph.nodes[got.graph.producer[out]]
    assert prod.op == "add"
    assert not set(prod.ins) & got.resident_tensors
    assert _view(got) == _view(jplan.plan_graph(
        "resnet18", P, "exact_opt", controller, residency_bytes=1 << 62))


def test_output_ships_through_a_virtual_chain():
    def toy(pkg):
        wl = pkg.ConvWorkload(name="c1", cin=4, cout=4, k=1, wi=8, hi=8,
                              wo=8, ho=8)
        t = {n: pkg.Tensor(n, 4, 8, 8) for n in ("x", "y", "s", "o")}
        return pkg.NetworkGraph("toy", (
            pkg.Node("in", "input", (), "x"),
            pkg.Node("c1", "conv", ("x",), "y", wl),
            pkg.Node("a", "add", ("x", "y"), "s"),
            pkg.Node("p", "pool", ("s",), "o")), t)
    got = tplan.plan_graph(toy(tplan), P, residency_bytes=1 << 30)
    assert got.traffic.output_words > 0 and "y" not in got.resident_tensors
    assert _view(got) == _view(jplan.plan_graph(toy(jplan), P,
                                                residency_bytes=1 << 30))


@pytest.mark.parametrize("residency", [tplan.DEFAULT_RESIDENCY_BYTES,
                                       64 * 2**20])
@pytest.mark.parametrize("controller", ["passive", "active"])
def test_transformer_graph_matches_reference(residency, controller):
    tg = tplan.NetworkGraph.from_transformer(tget_config("qwen2-1.5b"),
                                             seq_len=512)
    jg = JGraph.from_transformer(jget_config("qwen2-1.5b"), seq_len=512)
    assert {t.word_bytes for t in tg.tensors.values()} == {2}    # bf16
    got = tplan.plan_graph(tg, tplan.SMEM_BUDGET, "exhaustive_vmem",
                           controller, residency_bytes=residency)
    want = jplan.plan_graph(jg, tplan.SMEM_BUDGET, "exhaustive_vmem",
                            controller, residency_bytes=residency)
    assert _view(got) == _view(want)
    _assert_python_ints(got)
    per_gemm = [tplan.plan(wl, tplan.SMEM_BUDGET, "exhaustive_vmem",
                           controller) for wl in tg.workloads]
    assert got.baseline_words == sum(q.traffic.interconnect_words
                                     for q in per_gemm)


@pytest.mark.parametrize("net", ["alexnet", "squeezenet"])
def test_report_renders_as_the_reference(net):
    got = tplan.plan_graph(net, P, "paper_opt", "passive")
    text = got.report()
    assert "no_fusion" in text and "resident" in text
    assert text == jplan.plan_graph(net, P, "paper_opt", "passive").report()


@pytest.mark.parametrize("net", PAPER_CNNS)
def test_graph_bytes_and_live_ranges_match(net):
    tg, jg = tplan.NetworkGraph.from_cnn(net), JGraph.from_cnn(net)
    assert tg.live_ranges() == jg.live_ranges()
    assert tg.edge_list() == jg.edge_list()
    for name, t in tg.tensors.items():
        assert type(t.nbytes) is int and t.nbytes == jg.tensors[name].nbytes
    assert tnetplan._residency_sets(tg) == jnetplan._residency_sets(jg)


def test_plan_graph_accepts_a_graph_a_name_and_layers():
    a = tplan.plan_graph("alexnet", P)
    b = tplan.plan_graph(tplan.NetworkGraph.from_cnn("alexnet"), P)
    c = tplan.plan_graph(tget_cnn("alexnet"), P)
    assert a.total_words == b.total_words
    assert _view(c) == _view(jplan.plan_graph(jget_cnn("alexnet"), P))


# ------------------------------------------------------------------ replan
REPLAN_PARAMS = [
    # (net, controller, (budget0, residency0), (budget1, residency1))
    ("alexnet", "passive", (None, 0), (2048, tplan.DEFAULT_RESIDENCY_BYTES)),
    ("alexnet", "active", (2048, 1 << 20), (1024, 1 << 20)),
    ("squeezenet", "passive", (4096, 8 << 20), (4096, 1 << 20)),
    ("squeezenet", "active", (1024, tplan.DEFAULT_RESIDENCY_BYTES), (1024, 0)),
    ("resnet18", "passive", (2048, tplan.DEFAULT_RESIDENCY_BYTES),
     (None, 8 << 20)),
    ("resnet18", "active", (None, 1 << 20), (4096, 1 << 20)),
]


@pytest.mark.parametrize("net,controller,before,after", REPLAN_PARAMS)
def test_replan_params_matches_fresh_and_reference(net, controller, before,
                                                   after):
    base = tplan.plan_graph(net, before[0], controller=controller,
                            residency_bytes=before[1])
    tplan.clear_plan_graph_cache()             # force the replay path
    got = base.replan(budget=after[0], residency_bytes=after[1])
    tplan.clear_plan_graph_cache()
    fresh = tplan.plan_graph(net, after[0], controller=controller,
                             residency_bytes=after[1])
    assert _view(got) == _view(fresh)
    assert got.report() == fresh.report()
    jbase = jplan.plan_graph(net, before[0], controller=controller,
                             residency_bytes=before[1])
    jplan.clear_plan_graph_cache()
    assert _view(got) == _view(jbase.replan(budget=after[0],
                                            residency_bytes=after[1]))


def test_replan_beam_width_matches_fresh():
    base = tplan.plan_graph("squeezenet", P)
    tplan.clear_plan_graph_cache()
    got = base.replan(beam_width=2)
    tplan.clear_plan_graph_cache()
    assert _view(got) == _view(tplan.plan_graph("squeezenet", P,
                                                beam_width=2))
    assert _view(got) == _view(jplan.plan_graph("squeezenet", P,
                                                beam_width=2))


REPLAN_SUBGRAPHS = [
    # (net, controller, cut, extend): a chain cut after ``cut`` layers, and
    # with its last two layers repeated when ``extend``
    ("alexnet", "passive", 3, False),
    ("alexnet", "active", 5, True),
    ("squeezenet", "passive", 10, True),
    ("squeezenet", "active", 26, False),
    ("resnet18", "passive", 2, True),
    ("resnet18", "active", 14, False),
]


@pytest.mark.parametrize("net,controller,cut,extend", REPLAN_SUBGRAPHS)
def test_replan_subgraph_matches_fresh_and_reference(net, controller, cut,
                                                     extend):
    def graphs(layers, pkg):
        layers = list(layers)
        new = layers[:cut] + (layers[max(0, cut - 2):cut] if extend else [])
        return (pkg.NetworkGraph.from_layers(layers, name=f"{net}-chain"),
                pkg.NetworkGraph.from_layers(new, name=f"{net}-chain"))

    g0, g1 = graphs(tget_cnn(net), tplan)
    base = tplan.plan_graph(g0, P, controller=controller)
    tplan.clear_plan_graph_cache()
    got = base.replan(subgraph=g1)
    tplan.clear_plan_graph_cache()
    fresh = tplan.plan_graph(g1, P, controller=controller)
    assert _view(got) == _view(fresh)
    assert got.report() == fresh.report()
    jg0, jg1 = graphs(jget_cnn(net), jplan)
    jbase = jplan.plan_graph(jg0, P, controller=controller)
    jplan.clear_plan_graph_cache()
    assert _view(got) == _view(jbase.replan(subgraph=jg1))


def test_replan_resumes_where_the_graphs_differ():
    layers = list(tget_cnn("alexnet"))
    g0 = tplan.NetworkGraph.from_layers(layers, name="chain")
    g1 = tplan.NetworkGraph.from_layers(layers[:4], name="chain")
    base = tplan.plan_graph(g0, P)
    rp = base._replay
    d = tnetplan._dirty_index(g0, g1, rp.non_residable, rp.last_use,
                              *tnetplan._residency_sets(g1))
    # the cut changes the last kept layer's residability (its output now
    # leaves the network), so the beam resumes there and not before
    assert d == len(g1.nodes) - 1
    assert base.replan() is base


# ------------------------------------------------------------------- fleet
@pytest.mark.parametrize("strategy", ["exact_opt", "paper_opt"])
@pytest.mark.parametrize("controller", ["passive", "active"])
def test_fleet_matches_sequential_and_reference(strategy, controller):
    got = tplan.plan_graphs(ZOO4, P, strategy, controller)
    want = jplan.plan_graphs(ZOO4, P, strategy, controller)
    tplan.clear_plan_graph_cache()
    for name, batched, ref in zip(ZOO4, got, want):
        assert _view(batched) == _view(tplan.plan_graph(name, P, strategy,
                                                        controller))
        assert _view(batched) == _view(ref)


@pytest.mark.parametrize("controller", ["passive", "active"])
def test_fleet_full_zoo_matches_sequential(controller):
    got = tplan.plan_graphs(PAPER_CNNS, P, "exact_opt", controller)
    tplan.clear_plan_graph_cache()
    for name, batched in zip(PAPER_CNNS, got):
        assert _view(batched) == _view(tplan.plan_graph(name, P, "exact_opt",
                                                        controller))


@pytest.mark.parametrize("net", ["alexnet", "resnet18"])
def test_loop_planner_is_the_parity_oracle(net):
    ref = tfleet.plan_graph_loop(net)
    assert _view(ref) == _view(tplan.plan_graph(net))
    assert _view(ref) == _view(jfleet.plan_graph_loop(net))


def test_fleet_dedups_duplicate_requests():
    fleet = tplan.plan_graphs(["alexnet", "alexnet", "squeezenet", "alexnet"])
    assert fleet[0] is fleet[1] is fleet[3]
    assert fleet[2] is not fleet[0]
    assert _view(fleet[0]) == _view(jplan.plan_graph("alexnet"))


def test_fleet_shares_grids_as_the_reference_does():
    def run(pkg, layers):
        g1 = pkg.NetworkGraph.from_layers(layers, name="chain-a")
        g2 = pkg.NetworkGraph.from_layers(layers, name="chain-b")
        ctx = pkg.PlanContext()
        fleet = pkg.plan_graphs([g1, g2], P, context=ctx)
        return ctx.stats, fleet

    tstats, tfl = run(tplan, tget_cnn("alexnet"))
    jstats, jfl = run(jplan, jget_cnn("alexnet"))
    assert tstats["grid_misses"] == len(tget_cnn("alexnet"))
    assert tstats["grid_hits"] > 0 and tstats["fleet_bucketed_steps"] > 0
    assert dict(tstats) == dict(jstats)
    assert [_view(p) for p in tfl] == [_view(p) for p in jfl]


@pytest.mark.parametrize("residency", [0, tplan.DEFAULT_RESIDENCY_BYTES])
def test_fleet_zero_residency_and_mixed_graphs(residency):
    nets = ["alexnet", tplan.NetworkGraph.from_cnn("squeezenet").shrink(8, 4)]
    got = tplan.plan_graphs(nets, P, "exact_opt", "active",
                            residency_bytes=residency)
    jnets = ["alexnet", JGraph.from_cnn("squeezenet").shrink(8, 4)]
    want = jplan.plan_graphs(jnets, P, "exact_opt", "active",
                             residency_bytes=residency)
    assert [_view(p) for p in got] == [_view(p) for p in want]


# ------------------------------------------------------- graph-level cache
def test_plan_graph_cache_counts_match_reference():
    def calls(pkg):
        seen = [tuple(pkg.plan_graph_cache_info())]
        p1 = pkg.plan_graph("alexnet", P)
        p2 = pkg.plan_graph("alexnet", P)
        assert p2 is p1                              # a repeat is a lookup
        seen.append(tuple(pkg.plan_graph_cache_info()))
        assert pkg.plan_graph("alexnet", 1024) is not p1    # budget keys
        pkg.plan_graphs(["alexnet", "squeezenet"], P)
        seen.append(tuple(pkg.plan_graph_cache_info()))
        p1.replan(residency_bytes=0)
        seen.append(tuple(pkg.plan_graph_cache_info()))
        pkg.clear_plan_graph_cache()
        seen.append(tuple(pkg.plan_graph_cache_info()))
        return seen

    got = calls(tplan)
    assert got[0] == (0, 0, 128, 0)
    assert got[1] == (1, 1, 128, 1)
    assert got[-1] == (0, 0, 128, 0)
    assert got == calls(jplan)


def test_fleet_fills_and_hits_the_same_cache():
    fleet = tplan.plan_graphs(["alexnet", "squeezenet"])
    assert tplan.plan_graph("alexnet") is fleet[0]
    before = tplan.plan_graph_cache_info().hits
    again = tplan.plan_graphs(["alexnet", "squeezenet"])
    assert [p is q for p, q in zip(fleet, again)] == [True, True]
    assert tplan.plan_graph_cache_info().hits == before + 2


def test_register_strategy_clears_the_graph_cache():
    tplan.plan_graph("alexnet", P)
    assert tplan.plan_graph_cache_info().currsize == 1
    spec = tdse.strategy_spec("exact_opt", "conv")
    tdse.register_strategy("netplan_test_exact", conv=spec)
    try:
        assert tplan.plan_graph_cache_info().currsize == 0
        got = tplan.plan_graph("alexnet", P, "netplan_test_exact")
        assert got.schedules == tplan.plan_graph("alexnet", P).schedules
    finally:
        tdse.unregister_strategy("netplan_test_exact")
    assert tplan.plan_graph_cache_info().currsize == 0


# ------------------------------------------------------------------ raises
@pytest.mark.parametrize("name", ["nope", "max-input", "", "sim_nothing"])
def test_coerce_strategy_raises_plan_error_as_the_reference(name):
    with pytest.raises(JPlanError):
        jplan.coerce_strategy(name)
    with pytest.raises(terrors.PlanError) as info:
        tplan.coerce_strategy(name)
    assert isinstance(info.value, ValueError)
    assert isinstance(info.value, terrors.ReproError)


def test_error_hierarchy_matches_reference():
    from repro import errors as jerrors
    for name in jerrors.__all__:
        t, j = getattr(terrors, name), getattr(jerrors, name)
        assert [b.__name__ for b in t.__mro__] == [b.__name__
                                                   for b in j.__mro__]
    assert "0.2500" in str(terrors.DeadlineExceeded(lateness_s=0.25))


def test_no_feasible_candidate_raises_as_the_reference():
    """The per-layer baseline's search raises a ValueError first; the node
    grid's own check raises `BudgetError`, in both packages."""
    def never(wl, cands, budget):
        return np.zeros(len(cands), dtype=bool)

    def spec(pkg_dse):
        space = pkg_dse.strategy_spec("paper_opt", "conv").space
        return pkg_dse.StrategySpec(space=space, constraints=(never,))

    tdse.register_strategy("netplan_test_never", conv=spec(tdse))
    jdse.register_strategy("netplan_test_never", conv=spec(jdse))
    try:
        with pytest.raises(ValueError, match="no feasible"):
            jplan.plan_graph("alexnet", P, "netplan_test_never")
        with pytest.raises(ValueError, match="no feasible"):
            tplan.plan_graph("alexnet", P, "netplan_test_never")
        twl = tplan.NetworkGraph.from_cnn("alexnet").workloads[0]
        jwl = JGraph.from_cnn("alexnet").workloads[0]
        with pytest.raises(JBudgetError):
            jnetplan._node_grid(jwl, P, "netplan_test_never", "passive")
        with pytest.raises(terrors.BudgetError, match="no feasible"):
            tnetplan._node_grid(twl, P, "netplan_test_never", "passive")
    finally:
        tdse.unregister_strategy("netplan_test_never")
        jdse.unregister_strategy("netplan_test_never")


@pytest.mark.parametrize("call", [
    lambda pk: [pk.plan_graph("alexnet", P, "sim_latency")],
    lambda pk: pk.plan_graphs(["alexnet"], P, "sim_energy"),
    lambda pk: [pk.plan_graph("alexnet", P, objective="sim_latency")],
    lambda pk: pk.plan_graphs(["alexnet"], P, objective="sim_energy"),
    lambda pk: [pk.plan_graph("alexnet", P, objective="energy_bytes")],
])
def test_sim_objectives_and_strategies_raise_naming_a10(call):
    """The calls that waited for the SoC simulator (ROADMAP A10): each now
    equals the reference's plans, or raises the reference's own error where
    the reference refuses it (``energy_bytes`` is a word objective the beam
    cannot decompose over residency states)."""
    try:
        want = call(jplan)
    except JPlanError as e:
        with pytest.raises(terrors.PlanError, match="not a sim objective"):
            call(tplan)
        assert "not a sim objective" in str(e)
        return
    got = call(tplan)
    assert [_view(p) for p in got] == [_view(p) for p in want]
    for p in got:
        assert p.simulate().interconnect_words == p.traffic.interconnect_words


@pytest.mark.parametrize("call", [
    lambda pk: [pk.plan_graph("alexnet", P, checked=True)],
    lambda pk: pk.plan_graphs(["alexnet", "resnet18", "alexnet"], P,
                              checked=True),
    lambda pk: [pk.plan_graph("alexnet", P).replan(residency_bytes=1 << 20,
                                                   checked=True)],
])
def test_checked_matches_the_reference(call):
    """``checked=True`` verifies the plan (`repro_torch.check`) and returns
    what the reference's returns, on a cache miss and on a hit."""
    for _ in range(2):
        got, want = call(tplan), call(jplan)
        assert [_view(p) for p in got] == [_view(p) for p in want]


def test_interconnect_words_objective_is_the_default():
    a = tplan.plan_graph("alexnet", P, objective="interconnect_words")
    assert _view(a) == _view(tplan.plan_graph("alexnet", P))


# ---------------------------------------------------- the runner on a plan
def test_main_path_plan_differs_from_plan_many_as_the_reference():
    """The graph the card runs: the fused plan's schedules differ from the
    per-layer ones at the same nodes in both packages."""
    tg = tplan.NetworkGraph.from_cnn("resnet18").shrink(56, 1)
    jg = JGraph.from_cnn("resnet18").shrink(56, 1)
    got = tplan.plan_graph(tg, P, "exact_opt", "active")
    want = jplan.plan_graph(jg, P, "exact_opt", "active")
    assert _view(got) == _view(want)
    per_layer = tplan.plan_many(tg.workloads, P, "exact_opt", "active")
    differ = [n.name for n, q in zip(tg.workload_nodes, per_layer)
              if got.schedules[n.name] != q.schedule]
    assert len(got.schedules) == 20
    assert len(differ) == 12 and len(got.resident_tensors) == 9
    params = tnet.init_network_params(tg, device="cpu")
    tnet.check_network(tg, got, params)      # the card's body takes them


@pytest.fixture(scope="module")
def resnet_netplan():
    jg = JGraph.from_cnn("resnet18").shrink(8, 16)
    tg = tplan.NetworkGraph.from_cnn("resnet18").shrink(8, 16)
    jnetp = jplan.plan_graph(jg, P, "exact_opt", "active")
    tnetp = tplan.plan_graph(tg, P, "exact_opt", "active")
    jparams = jnet.init_network_params(jg, rng_seed=0)
    image = tg.tensors[tg.inputs[0]]
    x = np.random.default_rng(0).standard_normal(
        (image.channels, image.h, image.w)).astype(np.float32)
    jvals = jnet.run_network_kernels(jg, jnetp, jparams,
                                     inputs={jg.inputs[0]: jnp.asarray(x)})
    tparams = tnet.params_from_jax({k: np.asarray(v)
                                    for k, v in jparams.items()},
                                   device="cpu")
    tvals = tnet.run_network_kernels(tg, tnetp, tparams,
                                     inputs={tg.inputs[0]: torch.from_numpy(x)},
                                     device="cpu")
    return dict(jnetp=jnetp, tnetp=tnetp, jvals=jvals, tvals=tvals, tg=tg)


def test_runner_takes_a_netplan(resnet_netplan):
    assert _view(resnet_netplan["tnetp"]) == _view(resnet_netplan["jnetp"])
    assert resnet_netplan["tnetp"].resident_tensors
    jvals, tvals = resnet_netplan["jvals"], resnet_netplan["tvals"]
    assert set(tvals) == set(jvals) == set(resnet_netplan["tg"].tensors)
    for name, want in jvals.items():
        got = tvals[name]
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_runner_netplan_equals_its_schedules(resnet_netplan):
    tg, netp = resnet_netplan["tg"], resnet_netplan["tnetp"]
    params = tnet.init_network_params(tg, seed=1, device="cpu")
    a = tnet.run_network_kernels(tg, netp, params, seed=2, device="cpu")
    b = tnet.run_network_kernels(tg, dict(netp.schedules), params, seed=2,
                                 device="cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
