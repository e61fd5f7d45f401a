"""The rest of the port's planner and its DSE (`repro_torch.plan`: space,
objectives, planners, dse, network_traffic, the first-order GEMM rule and
the transformer graphs) against the live reference (`repro.plan`): the same
schedules, words, sums and rows, compared with ``==``."""

import dataclasses

import numpy as np
import pytest
import torch

from repro import plan as jplan
from repro.configs.registry import get_config as jget_config
from repro.core.cnn_zoo import PAPER_CNNS, PAPER_TABLE3, get_cnn
from repro.plan import conv_model as jconv
from repro.plan import dse as jdse
from repro.plan import gemm_model as jgemm
from repro.plan.graph import NetworkGraph as JGraph
from repro_torch import plan as tplan
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.registry import ARCHS
from repro_torch.core import cnn_zoo as tzoo
from repro_torch.plan import conv_model as tconv
from repro_torch.plan import dse as tdse
from repro_torch.plan import gemm_model as tgemm

CONV_STRATEGIES = ("max_input", "max_output", "equal", "paper_opt", "exact_opt")
GEMM_STRATEGIES = ("first_order", "paper_opt", "equal", "exhaustive_vmem")
TABLE2_P = (512, 1024, 2048, 4096, 8192, 16384)
TABLE1_P = (512, 2048, 16384)
TPU_BUDGET = 96 * 1024 * 1024
MOE_ARCHS = ("qwen2-moe-a2.7b", "deepseek-v2-lite-16b", "jamba-v0.1-52b")


def _sched(s):
    return (s.kind, s.bm, s.bn, s.bk, s.controller.value)


def _words(report):
    """A traffic report's fields, its bytes included."""
    return report.as_dict()


def _jwl(wl):
    """The reference's workload for one of the port's."""
    if isinstance(wl, tplan.ConvWorkload):
        return jplan.ConvWorkload(**dataclasses.asdict(wl))
    return jplan.MatmulWorkload(m=wl.m, n=wl.n, k=wl.k, name=wl.name,
                                in_bytes=wl.in_dtype.itemsize,
                                acc_bytes=wl.acc_dtype.itemsize)


def _wl_view(wl):
    """Field view of either package's workload (matmul widths in bytes)."""
    if wl is None:
        return None
    if isinstance(wl, (tplan.ConvWorkload, jplan.ConvWorkload)):
        return ("conv", dataclasses.asdict(wl))
    if isinstance(wl, tplan.MatmulWorkload):
        return ("matmul", wl.name, wl.m, wl.n, wl.k, wl.in_dtype.itemsize,
                wl.acc_dtype.itemsize)
    return ("matmul", wl.name, wl.m, wl.n, wl.k, wl.in_bytes, wl.acc_bytes)


def _row(row):
    """A sweep row without its timing column (a host time, different in every
    run), its workload and schedule as field views."""
    out = {k: v for k, v in row.items() if k != "us_per_call"}
    if "workload" in out:
        out["workload"] = _wl_view(out["workload"])
        out["schedule"] = _sched(out["schedule"])
    return out


def _graph_view(g):
    nodes = [(n.name, n.op, n.ins, n.out, _wl_view(n.workload))
             for n in g.nodes]
    tensors = {k: dataclasses.asdict(t) for k, t in g.tensors.items()}
    return (g.name, nodes, tensors, g.inputs, g.outputs, g.producer,
            g.consumers, [t.words for t in g.tensors.values()])


def _port_config(jcfg):
    """The port's ArchConfig with every field of the reference's config
    (nested configs rebuilt as the port's data classes)."""
    nested = {"moe": tbase.MoeCfg, "mla": tbase.MlaCfg, "ssm": tbase.SsmCfg,
              "encoder": tbase.EncoderCfg}
    fields = {}
    for f in dataclasses.fields(tbase.ArchConfig):
        v = getattr(jcfg, f.name)
        if f.name in nested and v is not None:
            v = nested[f.name](**dataclasses.asdict(v))
        fields[f.name] = v
    return tbase.ArchConfig(**fields)


# ------------------------------------------------------------ network tables
@pytest.mark.parametrize("strategy", CONV_STRATEGIES)
@pytest.mark.parametrize("cnn", PAPER_CNNS)
def test_network_traffic_matches(cnn, strategy):
    """Every Table I/II cell: P 512-16384 x both controllers x the paper's
    and the groups-aware convention, plus ``exact_iters`` None/True/False at
    P = 2048."""
    for budget in TABLE2_P:
        for controller in ("passive", "active"):
            for paper in (True, False):
                iters = (None, True, False) if budget == 2048 else (None,)
                for exact in iters:
                    got = tplan.network_traffic(cnn, budget, strategy, controller,
                                                exact_iters=exact,
                                                paper_convention=paper)
                    want = jplan.network_traffic(cnn, budget, strategy, controller,
                                                 exact_iters=exact,
                                                 paper_convention=paper)
                    assert got == want, (budget, controller, paper, exact)


@pytest.mark.parametrize("cnn", PAPER_CNNS)
def test_min_network_traffic_and_realvalued_m(cnn):
    got = tplan.min_network_traffic(cnn)
    assert got == jplan.min_network_traffic(cnn)
    assert got == tplan.min_network_traffic(tplan.conv_workloads(cnn))
    # Table III's deviation from the published value, as the benchmark has it
    dev = 100 * (got / 1e6 - tzoo.PAPER_TABLE3[cnn]) / tzoo.PAPER_TABLE3[cnn]
    assert dev == 100 * (jplan.min_network_traffic(cnn) / 1e6
                         - PAPER_TABLE3[cnn]) / PAPER_TABLE3[cnn]
    for wl in tplan.conv_workloads(cnn):
        for p in (512, 2048, 16384):
            for c in ("passive", "active"):
                assert (tplan.optimal_m_realvalued(wl, p, tplan.Controller(c))
                        == jplan.optimal_m_realvalued(_jwl(wl), p,
                                                      jplan.Controller(c)))
    wl = tplan.conv_workloads(cnn)[-1]
    assert tplan.optimal_m_realvalued(wl, 2048) == jplan.optimal_m_realvalued(
        _jwl(wl), 2048)


@pytest.mark.parametrize("exact_iters", [True, False])
@pytest.mark.parametrize("cnn", PAPER_CNNS)
def test_conv_bandwidth_grid_matches_scalar(cnn, exact_iters):
    """The vectorized eqs (2)/(3) equal the scalar evaluator element by
    element, and the reference's grid."""
    for wl in tplan.conv_workloads(cnn):
        m, n = tconv.conv_exact_candidates(wl, 2048)
        g = wl.groups
        m = np.concatenate([m, [wl.cin // g, 2 * (wl.cin // g) + 1]])
        n = np.concatenate([n, [1, wl.cout // g + 3]])
        for c in (tplan.Controller.PASSIVE, tplan.Controller.ACTIVE):
            b_i, b_o = tconv.conv_bandwidth_grid(wl, m, n, c, exact_iters)
            assert b_i.dtype == b_o.dtype == np.float64
            want = jconv.conv_bandwidth_grid(_jwl(wl), m, n,
                                             jplan.Controller(c.value),
                                             exact_iters)
            assert np.array_equal(b_i, want[0]) and np.array_equal(b_o, want[1])
            scalar = [tconv.conv_bandwidth(wl, int(a), int(b), c, exact_iters)
                      for a, b in zip(m, n)]
            assert [tuple(x) for x in zip(b_i.tolist(), b_o.tolist())] == scalar


@pytest.mark.parametrize("cnn", PAPER_CNNS)
def test_exact_scalar_loop_matches_batch(cnn):
    wls = tplan.conv_workloads(cnn)
    for p in (512, 2048):
        for c in (tplan.Controller.PASSIVE, tplan.Controller.ACTIVE):
            jc = jplan.Controller(c.value)
            scalar = [tconv.plan_conv_exact_scalar(w, p, c) for w in wls]
            assert scalar == tconv.conv_exact_search_batch(wls, p, c)
            assert scalar == [jconv.plan_conv_exact_scalar(_jwl(w), p, jc)
                              for w in wls]
            for s in CONV_STRATEGIES:
                got = [_sched(tconv.plan_conv(w, p, tplan.Strategy(s), c))
                       for w in wls]
                assert got == [_sched(jconv.plan_conv(_jwl(w), p,
                                                      jplan.Strategy(s), jc))
                               for w in wls], s


def test_exact_search_below_one_mac_column():
    """P < K^2: every path degrades to (1, 1), as the reference does."""
    wl = tplan.ConvWorkload(name="c", cin=16, cout=16, k=5, wi=8, hi=8, wo=8,
                            ho=8)
    assert tconv.plan_conv_exact_scalar(wl, 16, tplan.Controller.PASSIVE) == (1, 1)
    p = tplan.plan(wl, 16, "exact_opt", "passive")
    assert (p.schedule.m, p.schedule.n) == (1, 1)
    assert tplan.plan_many([wl], 16, "exact_opt", "passive")[0].schedule \
        == p.schedule
    assert _sched(p.schedule) == _sched(
        jplan.plan(_jwl(wl), 16, "exact_opt", "passive").schedule)


# ------------------------------------------------------------------- GEMMs
@pytest.mark.parametrize("arch", ARCHS)
def test_transformer_matmuls_match(arch):
    tcfg, jcfg = tget_config(arch), jget_config(arch)
    for seq_len, batch, head in ((4096, 1, True), (1024, 2, False), (7, 3, True)):
        got = tplan.transformer_matmuls(tcfg, seq_len=seq_len, batch=batch,
                                        include_lm_head=head)
        want = jplan.transformer_matmuls(jcfg, seq_len=seq_len, batch=batch,
                                         include_lm_head=head)
        assert [_wl_view(w) for w in got] == [_wl_view(w) for w in want]
        assert all(w.in_dtype == torch.bfloat16 for w in got)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_transformer_matmuls_and_graph_moe(arch):
    """An MoE config, built from the reference's fields: the expert GEMMs at
    the top_k-scaled token count, and the routed graph."""
    jcfg = jget_config(arch)
    tcfg = _port_config(jcfg)
    got = tplan.transformer_matmuls(tcfg, seq_len=512)
    want = jplan.transformer_matmuls(jcfg, seq_len=512)
    assert [_wl_view(w) for w in got] == [_wl_view(w) for w in want]
    names = [w.name.split("/")[-1] for w in got]
    assert "expert_up" in names and "expert_down" in names
    tg = tplan.NetworkGraph.from_transformer(tcfg, seq_len=512)
    jg = JGraph.from_transformer(jcfg, seq_len=512)
    assert _graph_view(tg) == _graph_view(jg)
    assert [n.op for n in tg.nodes].count("route") == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("controller", ["active", "passive"])
@pytest.mark.parametrize("budget", [tplan.SMEM_BUDGET, TPU_BUDGET])
@pytest.mark.parametrize("arch", ARCHS)
def test_gemm_strategies_match(arch, budget, controller, dtype):
    """first_order, paper_opt, equal and exhaustive_vmem on the GEMMs of
    the port's dense configs, and the first-order rule itself."""
    for wl in tplan.transformer_matmuls(tget_config(arch)):
        wl = dataclasses.replace(wl, in_dtype=dtype)
        jwl = _jwl(wl)
        rule = tgemm.first_order_block(wl, budget)
        jb = jgemm.first_order_block(wl.m, wl.n, wl.k, in_bytes=dtype.itemsize,
                                     vmem_budget=budget)
        assert rule == (jb.bm, jb.bn, jb.bk)
        for strategy in GEMM_STRATEGIES:
            got = tgemm.plan_gemm(wl, budget, tplan.Strategy(strategy),
                                  tplan.Controller(controller))
            want = jgemm.plan_gemm(jwl, budget, jplan.Strategy(strategy),
                                   jplan.Controller(controller))
            assert _sched(got) == _sched(want), (wl.name, strategy)
            if strategy != "exhaustive_vmem":
                assert (got.bm, got.bn, got.bk) == rule
            g = tplan.plan(wl, budget, strategy, controller)
            w = jplan.plan(jwl, budget, strategy, controller)
            assert _sched(g.schedule) == _sched(w.schedule)
            assert g.traffic.as_dict() == _words(w.traffic)


@pytest.mark.parametrize("controller", ["active", "passive"])
def test_qwen2_first_order_is_the_exact_search_on_the_card(controller):
    """At one H100 block's shared memory every Qwen2-1.5B GEMM gets 128^3
    blocks from paper_opt and from exact_opt: in bf16 128^3 fits (196,608 B
    of 232,448); in fp32 nothing fits and the search falls back to it."""
    for dtype, fits in ((torch.bfloat16, True), (torch.float32, False)):
        for wl in tplan.transformer_matmuls(tget_config("qwen2-1.5b")):
            wl = dataclasses.replace(wl, in_dtype=dtype)
            for s in ("paper_opt", "exact_opt"):
                sched = tplan.plan(wl, tplan.SMEM_BUDGET, s, controller).schedule
                assert (sched.bm, sched.bn, sched.bk) == (128, 128, 128)
                assert _sched(sched) == _sched(jplan.plan(
                    _jwl(wl), tplan.SMEM_BUDGET, s, controller).schedule)
            nbytes = int(tgemm.working_set_bytes(wl, 128, 128, 128))
            assert (nbytes <= tplan.SMEM_BUDGET) == fits
            assert nbytes == (196_608 if fits else 327_680)
            res = tdse.search(wl, tplan.SMEM_BUDGET,
                              space=tplan.space.AlignedBlockSpace(),
                              constraints=(tdse.VmemBudget(),),
                              controller=controller)
            assert (res.n_feasible > 0) == fits


def test_plan_matmul_blocks_matches():
    for (m, n, k) in ((4096, 8960, 1536), (100, 130, 70), (512, 8, 8)):
        for dtype in (torch.bfloat16, torch.float32):
            for budget in (tplan.SMEM_BUDGET, TPU_BUDGET, 1000):
                for c in ("active", "passive"):
                    got = tgemm.plan_matmul_blocks(m, n, k, in_dtype=dtype,
                                                   budget=budget, controller=c)
                    want = jgemm.plan_matmul_blocks(
                        m, n, k, in_bytes=dtype.itemsize, vmem_budget=budget,
                        controller=c)
                    assert (got.bm, got.bn, got.bk) == (want.bm, want.bn, want.bk)
                    assert got.controller.value == c


# ------------------------------------------------------------------- graphs
@pytest.mark.parametrize("arch", ARCHS)
def test_from_transformer_matches(arch):
    """The port's graph equals the reference's; where the reference cannot
    build one (mamba2-1.3b: no FFN, so no ``ffn_up`` GEMM), the port raises
    the same exception."""
    tcfg, jcfg = tget_config(arch), jget_config(arch)
    if tcfg.d_ff == 0 and tcfg.moe is None:
        for build, cfg in ((JGraph.from_transformer, jcfg),
                           (tplan.NetworkGraph.from_transformer, tcfg)):
            with pytest.raises(KeyError, match="ffn_up"):
                build(cfg)
        return
    for kw in ({}, {"seq_len": 1024, "batch": 2, "include_lm_head": False}):
        tg = tplan.NetworkGraph.from_transformer(tcfg, **kw)
        jg = JGraph.from_transformer(jcfg, **kw)
        assert _graph_view(tg) == _graph_view(jg)
        assert [n.op for n in tg.workload_nodes] == ["matmul"] * len(tg.workloads)
        tg.validate()
    with pytest.raises(TypeError, match="conv graphs only"):
        tplan.NetworkGraph.from_transformer(tcfg).shrink(8)


def test_graph_validates_matmul_nodes():
    """A GEMM node whose tensors do not carry M*K in or M*N out is refused,
    with the reference's messages."""
    g = tplan.NetworkGraph.from_transformer(tget_config("qwen2-1.5b"), seq_len=64)
    node = g.workload_nodes[0]
    for field, match in (("k", "GEMM reads"), ("n", "output tensor")):
        bad = dataclasses.replace(node, workload=dataclasses.replace(
            node.workload, **{field: getattr(node.workload, field) + 1}))
        nodes = tuple(bad if n is node else n for n in g.nodes)
        with pytest.raises(ValueError, match=match):
            tplan.NetworkGraph("bad", nodes, g.tensors)


@pytest.mark.parametrize("cnn", PAPER_CNNS)
def test_from_layers_matches(cnn):
    """A layer list as a chain (fresh inputs where shapes break, ``#i`` for
    repeated names), from zoo layers and from workloads."""
    tl, jl = tzoo.get_cnn(cnn), get_cnn(cnn)
    for kw in ({}, {"name": "chain", "word_bytes": 2}):
        assert (_graph_view(tplan.NetworkGraph.from_layers(tl + tl, **kw))
                == _graph_view(JGraph.from_layers(jl + jl, **kw)))
    wls = tplan.conv_workloads(cnn)
    assert (_graph_view(tplan.NetworkGraph.from_layers(wls))
            == _graph_view(JGraph.from_layers([_jwl(w) for w in wls])))
    assert tplan.NetworkGraph.from_layers([]).name == "custom"


# ------------------------------------------------------------------- sweeps
@pytest.mark.parametrize("table", ["table1", "table2", "beyond", "dse_pareto"])
def test_paper_table_sweeps_match(table):
    """The rows of the paper's tables as `benchmarks/paper_tables.py` sweeps
    them, and Fig. 2's savings and the Pareto frontiers."""
    if table == "table1":
        args = (PAPER_CNNS, TABLE1_P, CONV_STRATEGIES[:4], ("passive",))
        kw = {"paper_convention": True}
    elif table == "table2":
        args = (PAPER_CNNS, TABLE2_P, ("paper_opt",), ("passive", "active"))
        kw = {"paper_convention": True}
    elif table == "beyond":
        args = (PAPER_CNNS, TABLE1_P, ("paper_opt", "exact_opt"), ("passive",))
        kw = {"exact_iters": True}
    else:
        args = (PAPER_CNNS, (256, 512, 1024, 2048, 4096, 8192, 16384),
                ("exact_opt",), ("active",))
        kw = {}
    got, want = tdse.sweep(*args, **kw), jdse.sweep(*args, **kw)
    assert [_row(r) for r in got] == [_row(r) for r in want]
    if table == "table2":
        def savings(rows):
            cell = {(r["network"], r["budget"], r["controller"]):
                    r["interconnect_words"] for r in rows}
            return [1 - cell[(n, p, "active")] / cell[(n, p, "passive")]
                    for n in PAPER_CNNS for p in TABLE2_P]
        assert savings(got) == savings(want)
        assert all(s > 0 for s in savings(got))
    if table == "dse_pareto":
        for net in PAPER_CNNS:
            mine = [r for r in got if r["network"] == net]
            ref = [r for r in want if r["network"] == net]
            front = tdse.pareto(mine, x="budget", y="interconnect_words")
            assert ([_row(r) for r in front]
                    == [_row(r) for r in jdse.pareto(ref, x="budget",
                                                     y="interconnect_words")])
            assert front and all(a["interconnect_words"] > b["interconnect_words"]
                                 for a, b in zip(front, front[1:]))


@pytest.mark.parametrize("cnn", PAPER_CNNS)
def test_sweep_per_layer_rows_match(cnn):
    for per_layer in (True, False):
        for objective in ("interconnect_words", "sram_accesses"):
            kw = dict(per_layer=per_layer, objective=objective)
            got = tdse.sweep(cnn, 2048, CONV_STRATEGIES, ("passive", "active"), **kw)
            want = jdse.sweep(cnn, 2048, CONV_STRATEGIES, ("passive", "active"), **kw)
            assert [_row(r) for r in got] == [_row(r) for r in want]
            assert all(isinstance(r["us_per_call"], float)
                       and r["us_per_call"] >= 0.0 for r in got)
    rows = tdse.sweep(cnn, 2048, ("exact_opt",), per_layer=True)
    assert [r["layer"] for r in rows] == [w.name for w in tplan.conv_workloads(cnn)]


def test_sweep_network_forms():
    """A name, a list of names, a {name: workloads} mapping and a workload
    list, with an integer budget and a GEMM network."""
    wls = tplan.conv_workloads("alexnet")
    jwls = jplan.conv_workloads("alexnet")
    for tnets, jnets in (("alexnet", "alexnet"), (["alexnet"], ["alexnet"]),
                         ({"a": wls[:2]}, {"a": jwls[:2]}), (wls, jwls), ([], [])):
        assert ([_row(r) for r in tdse.sweep(tnets, 1024)]
                == [_row(r) for r in jdse.sweep(jnets, 1024)])
    gemms = tplan.transformer_matmuls(tget_config("gemma-2b"), seq_len=256)
    jgemms = jplan.transformer_matmuls(jget_config("gemma-2b"), seq_len=256)
    for s in ("paper_opt", "exact_opt"):
        got = tdse.sweep({"g": gemms}, (tplan.SMEM_BUDGET,), (s,),
                         ("passive", "active"), per_layer=True)
        want = jdse.sweep({"g": jgemms}, (tplan.SMEM_BUDGET,), (s,),
                          ("passive", "active"), per_layer=True)
        assert [_row(r) for r in got] == [_row(r) for r in want]


# ------------------------------------------------------- search and spaces
def test_search_metadata_and_fallbacks():
    gemm = tplan.MatmulWorkload(m=4096, n=4096, k=4096)
    for budget in (TPU_BUDGET, tplan.SMEM_BUDGET, 1024):
        for db in (True, False):
            got = tdse.search(gemm, budget, space=tplan.space.AlignedBlockSpace(),
                              constraints=(tdse.VmemBudget(double_buffer=db),),
                              controller="active")
            want = jdse.search(_jwl(gemm), budget,
                               space=jplan.space.AlignedBlockSpace(),
                               constraints=(jdse.VmemBudget(double_buffer=db),),
                               controller="active")
            assert ((got.cost, got.n_candidates, got.n_feasible, _sched(got.schedule))
                    == (want.cost, want.n_candidates, want.n_feasible,
                        _sched(want.schedule)))
            assert got.n_feasible <= got.n_candidates
    assert got.n_feasible == 0 and _sched(got.schedule)[1:4] == (128, 128, 128)
    conv = tplan.ConvWorkload(name="c", cin=64, cout=96, k=3, wi=28, hi=28,
                              wo=28, ho=28)
    for space_t, space_j in ((tplan.space.ConvExactSpace(), jplan.space.ConvExactSpace()),
                             (tplan.space.ConvGridSpace(), jplan.space.ConvGridSpace())):
        for budget in (2048, 4):
            for c in ("passive", "active"):
                got = tdse.search(conv, budget, space=space_t,
                                  constraints=(tdse.MacBudget(), tdse.GroupDivisible()),
                                  controller=c)
                want = jdse.search(_jwl(conv), budget, space=space_j,
                                   constraints=(jdse.MacBudget(), jdse.GroupDivisible()),
                                   controller=c)
                assert ((got.cost, got.n_candidates, got.n_feasible,
                         _sched(got.schedule))
                        == (want.cost, want.n_candidates, want.n_feasible,
                            _sched(want.schedule)))
    # the full grid under eq (1) finds the exact space's optimum
    grid = tdse.search(conv, 2048, space=tplan.space.ConvGridSpace(),
                       constraints=(tdse.MacBudget(),))
    assert grid.cost <= tdse.search(conv, 2048, space=tplan.space.ConvExactSpace(),
                                    constraints=(tdse.MacBudget(),)).cost
    # a space without a fallback raises where nothing is feasible
    bare = tplan.space.ClosedFormSpace("conv", lambda w, b: (64, 96, 0))
    with pytest.raises(ValueError, match="no feasible candidate"):
        tdse.search(conv, 2048, space=bare, constraints=(tdse.MacBudget(),))
    assert tdse.search(conv, None, space=bare).n_candidates == 1


def test_constraint_masks_match():
    gemm = tplan.MatmulWorkload(m=1000, n=300, k=700, in_dtype=torch.float32)
    cands = tplan.space.AlignedBlockSpace(512)(gemm, tplan.SMEM_BUDGET)
    jc = jplan.space.Candidates("matmul", cands.bm, cands.bn, cands.bk)
    odd = tplan.Candidates("matmul", cands.bm + 8, cands.bn, cands.bk)
    for t, j in ((tdse.VmemBudget(), jdse.VmemBudget()),
                 (tdse.VmemBudget(False), jdse.VmemBudget(False)),
                 (tdse.LaneAligned(), jdse.LaneAligned()),
                 (tdse.MacBudget(), jdse.MacBudget())):
        assert np.array_equal(t(gemm, cands, tplan.SMEM_BUDGET),
                              j(_jwl(gemm), jc, tplan.SMEM_BUDGET))
    assert tdse.LaneAligned()(gemm, cands, 0).all()
    assert not tdse.LaneAligned()(gemm, odd, 0).any()
    dw = tplan.conv_workloads("mobilenet")[1]
    conv = tplan.space.ConvGridSpace()(dataclasses.replace(dw, groups=1), 2048)
    jconv_c = jplan.space.Candidates("conv", conv.bm, conv.bn, conv.bk)
    for t, j in ((tdse.GroupDivisible(), jdse.GroupDivisible()),
                 (tdse.MacBudget(), jdse.MacBudget())):
        assert np.array_equal(t(dw, conv, 2048), j(_jwl(dw), jconv_c, 2048))
    assert len(conv) == dw.cin * dw.cout


@pytest.mark.parametrize("objective", ["interconnect_words", "sram_accesses"])
def test_objectives_match(objective):
    conv = tplan.conv_workloads("resnet18")[1]
    gemm = tplan.MatmulWorkload(m=1024, n=1024, k=1024)
    for wl, cands in ((conv, tplan.space.ConvExactSpace()(conv, 2048)),
                      (gemm, tplan.space.AlignedBlockSpace()(gemm, TPU_BUDGET))):
        jc = jplan.space.Candidates(cands.kind, cands.bm, cands.bn, cands.bk)
        for c in ("passive", "active"):
            got = tplan.get_objective(objective)(wl, cands, tplan.Controller(c))
            want = jplan.get_objective(objective)(_jwl(wl), jc, jplan.Controller(c))
            assert got.shape == (len(cands),) and np.array_equal(got, want)
            assert np.all(np.isfinite(got)) and np.all(got > 0)
    with pytest.raises(TypeError, match="unsupported workload"):
        tplan.get_objective(objective)("x", cands, tplan.Controller.ACTIVE)


@pytest.mark.parametrize("name, item", [("energy_bytes", "A10"),
                                        ("roofline_latency", "A10"),
                                        ("sim_latency", "A10"),
                                        ("sim_energy", "A10")])
def test_waiting_objectives_name_their_roadmap_item(name, item, monkeypatch):
    """The four objectives that waited for ROADMAP ``item`` (the simulator,
    the energy table and the roofline constants) now equal the reference's
    through ``get_objective``, ``dse.sweep`` and ``plan`` (the sim presets
    by name, the other two through a strategy that scores by them). The
    reference's roofline is priced at the port's H100 constants by
    ``monkeypatch``."""
    from repro.plan import objectives as jobjectives
    from repro_torch.roofline import constants as tconstants
    monkeypatch.setattr(jobjectives, "PEAK_FLOPS_BF16",
                        tconstants.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jobjectives, "HBM_BW", tconstants.HBM_BW)
    conv = tplan.conv_workloads("resnet18")[3]
    gemm = tplan.MatmulWorkload(m=1024, n=768, k=1536)
    for wl, cands in ((conv, tplan.space.ConvExactSpace()(conv, 2048)),
                      (gemm, tplan.space.AlignedBlockSpace()(
                          gemm, tplan.SMEM_BUDGET))):
        jc = jplan.space.Candidates(cands.kind, cands.bm, cands.bn, cands.bk)
        for c in ("passive", "active"):
            got = tplan.get_objective(name)(wl, cands, tplan.Controller(c))
            want = jplan.get_objective(name)(_jwl(wl), jc, jplan.Controller(c))
            assert got.shape == (len(cands),) and np.array_equal(got, want)
    got, want = (
        [(r["network"], r["strategy"], r["controller"], r["cost"],
          r["interconnect_words"]) for r in pkg.sweep(
            ["alexnet", "squeezenet"], 2048, ("paper_opt", "exact_opt"),
            ("passive", "active"), objective=name)]
        for pkg in (tdse, jdse))
    assert got == want and len(got) > 0
    strategy = name
    if not name.startswith("sim_"):
        strategy = f"_port_test_min_{name}"
        for pkg in (tdse, jdse):
            pkg.register_strategy(strategy, conv=pkg.StrategySpec(
                space=pkg.ConvExactSpace(),
                constraints=(pkg.MacBudget(), pkg.GroupDivisible()),
                objective=name))
    try:
        for wl in tplan.conv_workloads("alexnet"):
            for c in ("passive", "active"):
                got = tplan.plan(wl, 2048, strategy, c)
                want = jplan.plan(_jwl(wl), 2048, strategy, c)
                assert _sched(got.schedule) == _sched(want.schedule)
                assert _words(got.traffic) == _words(want.traffic)
    finally:
        if strategy != name:
            tdse.unregister_strategy(strategy)
            jdse.unregister_strategy(strategy)
    with pytest.raises(KeyError, match="unknown objective"):
        tplan.get_objective("wall_time")


# ----------------------------------------------- strategies, planners, cache
def test_custom_objective_and_strategy_drive_plan_and_sweep():
    """The same registered objective and strategy in both packages select
    and score the same schedules through plan(), its cache and sweep()."""
    obj, strat = "_port_test_input_words", "_port_test_min_input_words"

    def input_only(conv_model):
        def fn(wl, cands, controller):
            return conv_model.conv_bandwidth_grid(wl, cands.bm, cands.bn,
                                                  controller, exact_iters=True)[0]
        return fn

    tplan.register_objective(obj)(input_only(tconv))
    jplan.register_objective(obj)(input_only(jconv))
    try:
        tdse.register_strategy(strat, conv=tdse.StrategySpec(
            space=tdse.ConvExactSpace(), constraints=(tdse.MacBudget(),),
            objective=obj))
        jdse.register_strategy(strat, conv=jdse.StrategySpec(
            space=jdse.ConvExactSpace(), constraints=(jdse.MacBudget(),),
            objective=obj))
        wl = tplan.conv_workloads("alexnet")[1]
        p = tplan.plan(wl, 2048, strat, "passive")
        assert _sched(p.schedule) == _sched(
            jplan.plan(_jwl(wl), 2048, strat, "passive").schedule)
        assert tplan.plan(wl, 2048, strat, "passive") is p
        m, n = tconv.conv_exact_candidates(wl, 2048)
        b_i, _ = tconv.conv_bandwidth_grid(wl, m, n, tplan.Controller.PASSIVE,
                                           exact_iters=True)
        assert tconv.conv_bandwidth(wl, p.schedule.m, p.schedule.n,
                                    tplan.Controller.PASSIVE, True)[0] == b_i.min()
        for per_layer in (False, True):
            got = tdse.sweep(["alexnet", "resnet18"], (512, 2048), (strat,),
                             ("passive", "active"), objective=obj,
                             per_layer=per_layer)
            want = jdse.sweep(["alexnet", "resnet18"], (512, 2048), (strat,),
                              ("passive", "active"), objective=obj,
                              per_layer=per_layer)
            assert [_row(r) for r in got] == [_row(r) for r in want]
            assert {r["strategy"] for r in got} == {strat}
        assert (tplan.network_traffic("squeezenet", 2048, strat)
                == jplan.network_traffic("squeezenet", 2048, strat))
        with pytest.raises(ValueError, match="not applicable to matmuls"):
            tplan.plan(tplan.MatmulWorkload(m=256, n=256, k=256), None, strat)
    finally:
        tdse.unregister_strategy(strat)
        jdse.unregister_strategy(strat)
        tplan.OBJECTIVES.pop(obj, None)
        jplan.OBJECTIVES.pop(obj, None)
    with pytest.raises(ValueError, match="unknown strategy"):
        tplan.plan(wl, 2048, strat, "passive")
    with pytest.raises(ValueError, match="already registered"):
        tplan.register_objective("interconnect_words")(input_only(tconv))


def test_reregistered_strategy_never_serves_a_stale_plan():
    wl = tplan.conv_workloads("alexnet")[1]
    gemm = tplan.MatmulWorkload(m=512, n=512, k=512)
    name = "_port_test_reregister"
    try:
        tdse.register_strategy(name, conv=tdse.StrategySpec(
            space=tplan.space.ClosedFormSpace("conv", lambda w, b: (2, 2, 0))))
        assert tplan.plan(wl, 2048, name).schedule.m == 2
        tdse.unregister_strategy(name)
        tdse.register_strategy(name, conv=tdse.StrategySpec(
            space=tplan.space.ClosedFormSpace("conv", lambda w, b: (4, 4, 0))),
            matmul=tdse.StrategySpec(space=tplan.space.ClosedFormSpace(
                "matmul", lambda w, b: (256, 128, 64))))
        assert tplan.plan(wl, 2048, name).schedule.m == 4
        assert _sched(tplan.plan(gemm, None, name, "active").schedule) \
            == ("matmul", 256, 128, 64, "active")
    finally:
        tdse.unregister_strategy(name)
    with pytest.raises(ValueError, match="needs a conv and/or matmul spec"):
        tdse.register_strategy(name)


def test_plan_cache_hits_and_keys():
    tplan.clear_plan_cache()
    assert tplan.plan_cache_info().currsize == 0
    wl = tplan.conv_workloads("resnet18")[3]
    p1 = tplan.plan(wl, 2048, "paper_opt", "passive")
    before = tplan.plan_cache_info()
    p2 = tplan.plan(wl, 2048, tplan.Strategy.PAPER_OPT, tplan.Controller.PASSIVE)
    after = tplan.plan_cache_info()
    assert p2 is p1 and after.hits == before.hits + 1
    assert after.misses == before.misses
    # the controller, the budget and the iteration convention are keys
    assert tplan.plan(wl, 2048, "paper_opt", "active") is not p1
    assert tplan.plan(wl, 2048, "paper_opt", "active").controller.value == "active"
    assert tplan.plan(wl, 1024, "paper_opt", "passive").budget == 1024
    assert (tplan.plan(wl, 2048, "paper_opt", "passive", exact_iters=False)
            .traffic == tplan.conv_traffic(wl, p1.schedule, exact_iters=False))
    assert tplan.plan_cache_info().currsize == 4


def test_builtin_strategies_refuse_unregistration_and_shadowing():
    wl = tplan.conv_workloads("resnet18")[1]
    before = tplan.plan(wl, 2048, "exact_opt", "passive").schedule
    for s in tplan.Strategy:
        with pytest.raises(ValueError, match="built-in"):
            tdse.unregister_strategy(s.value)
        assert s.value in tplan.PLANNERS
    with pytest.raises(ValueError, match="already registered"):
        tdse.register_strategy("exact_opt", conv=tdse.StrategySpec(
            space=tplan.space.ClosedFormSpace("conv", lambda w, b: (1, 1, 0))))
    assert tplan.plan(wl, 2048, "exact_opt", "passive").schedule == before


def test_planner_registry_and_strategy_specs():
    # one planner per built-in strategy, as in the reference, and the sim_*
    # planners that importing the simulator (`repro.sim`, `repro_torch.sim`)
    # registers in each package
    import repro.sim  # noqa: F401
    import repro_torch.sim  # noqa: F401
    assert [s.value for s in tplan.Strategy] == [s.value for s in jplan.Strategy]
    sim = {"sim_latency", "sim_energy"}
    assert sim <= set(tplan.PLANNERS) and sim <= set(jplan.PLANNERS)
    assert sorted(set(tplan.PLANNERS) - sim) == \
        sorted(s.value for s in tplan.Strategy)
    assert set(tplan.PLANNERS) <= set(jplan.PLANNERS)
    for name in sim:
        for kind in ("conv", "matmul"):
            t, j = tdse.strategy_spec(name, kind), jdse.strategy_spec(name, kind)
            assert t.objective == j.objective == name
            assert type(t.space).__name__ == type(j.space).__name__
    assert tplan.Strategy.FIRST_ORDER.value == "first_order"
    for name in tplan.PLANNERS:
        assert tplan.get_planner(name) is tplan.PLANNERS[name]
        assert isinstance(tdse.strategy_spec(name, "conv"), tdse.StrategySpec)
    for s in ("exact_opt", "exhaustive_vmem", "first_order", "paper_opt", "equal"):
        assert isinstance(tdse.strategy_spec(s, "matmul"), tdse.StrategySpec)
    for s in ("max_input", "max_output"):
        with pytest.raises(ValueError, match="not applicable to matmuls"):
            tplan.plan(tplan.MatmulWorkload(m=256, n=256, k=256), None, s)
    with pytest.raises(ValueError, match="unknown workload kind"):
        tdse.strategy_spec("paper_opt", "fft")
    with pytest.raises(KeyError, match="unknown planner"):
        tplan.get_planner("simulated_annealing")
    # conv takes the GEMM-flavoured names by alias
    conv = tplan.conv_workloads("alexnet")[0]
    assert (tplan.plan(conv, 2048, "first_order").schedule
            == tplan.plan(conv, 2048, "paper_opt").schedule)
    assert (tplan.plan(conv, 2048, "exhaustive_vmem").schedule
            == tplan.plan(conv, 2048, "exact_opt").schedule)
    with pytest.raises(ValueError, match="unknown strategy"):
        tplan.coerce_strategy("greedy")
    assert tplan.coerce_strategy("paper_opt") is tplan.Strategy.PAPER_OPT


def test_plan_exports():
    for name in ("dse", "space", "objectives", "network_traffic",
                 "min_network_traffic", "optimal_m_realvalued",
                 "transformer_matmuls", "register_strategy", "coerce_strategy",
                 "plan_cache_info", "clear_plan_cache", "PLANNERS",
                 "register_objective", "Candidates", "SearchSpace"):
        assert name in tplan.__all__ and hasattr(tplan, name), name
    wl = tplan.MatmulWorkload(m=4096, n=8960, k=1536)
    assert _sched(tplan.plan(wl, strategy="paper_opt").schedule) \
        == ("matmul", 128, 128, 128, "passive")
