"""The port's byte models, plan verifier, launch pre-flight and word-count
certificates (`repro_torch.plan` bytes, `repro_torch.check`) against the live
reference (`repro.plan`, `repro.check`) on the same inputs: byte counts,
schedules and the diagnostics' (code, subject, severity) lists with ``==``
(the verifier runs no kernel, so no tolerance). The launch pre-flight and the
certificates check the port's own `LaunchPlan`s; where they must differ from
the reference's Pallas analysis, the test says why."""

import dataclasses
import types

import numpy as np
import pytest
import torch

import repro.check as jcheck
from repro import plan as jplan
from repro.check import diagnostics as jdiag
from repro.configs.registry import get_config as jget_config
from repro.core.cnn_zoo import PAPER_CNNS
from repro.plan import gemm_model as jgemm
from repro.plan.graph import NetworkGraph as JGraph
from repro_torch import check as tcheck
from repro_torch import plan as tplan
from repro_torch.check import diagnostics as tdiag
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import _build
from repro_torch.kernels import conv2d_psum as tconv
from repro_torch.kernels import psum_matmul as tmm
from repro_torch.plan import gemm_model as tgemm

T = types.SimpleNamespace(plan=tplan, check=tcheck)
J = types.SimpleNamespace(plan=jplan, check=jcheck)
P = 2048
DENSE_ARCHS = ("qwen2-1.5b", "gemma-2b", "granite-8b", "stablelm-12b")
STRATEGIES = ("max_input", "max_output", "equal", "paper_opt", "exact_opt")


@pytest.fixture(autouse=True)
def _clear_graph_caches():
    tplan.clear_plan_graph_cache()
    jplan.clear_plan_graph_cache()
    yield
    tplan.clear_plan_graph_cache()
    jplan.clear_plan_graph_cache()


def _view(diags):
    return [(d.code, d.subject, d.severity.value) for d in diags]


def _jwl(wl):
    """The reference's workload for one of the port's."""
    if isinstance(wl, tplan.ConvWorkload):
        return jplan.ConvWorkload(**dataclasses.asdict(wl))
    return jplan.MatmulWorkload(m=wl.m, n=wl.n, k=wl.k, name=wl.name,
                                in_bytes=wl.in_dtype.itemsize,
                                out_bytes=wl.out_dtype.itemsize,
                                acc_bytes=wl.acc_dtype.itemsize)


def _jsched(s):
    return jplan.Schedule(kind=s.kind, bm=s.bm, bn=s.bn, bk=s.bk,
                          controller=jplan.Controller(s.controller.value))


def _gemms(arch, dtype):
    wls = tplan.transformer_matmuls(tget_config(arch), seq_len=4096)
    return [dataclasses.replace(w, in_dtype=dtype) for w in wls]


# ---------------------------------------------------------------- registry
def test_registry_equals_the_reference():
    assert list(tdiag.CODES) == list(jdiag.CODES)
    for code, info in tdiag.CODES.items():
        want = jdiag.CODES[code]
        assert (info.slug, info.severity.value, info.summary) == \
            (want.slug, want.severity.value, want.summary)
        assert info.hint


def test_diagnostics_render_and_raise_as_the_reference():
    got = tcheck.Diagnostic("RPC001", "conv1", "too big", file="x.py", line=3)
    want = jcheck.Diagnostic("RPC001", "conv1", "too big", file="x.py", line=3)
    assert got.render() == want.render()
    assert got.render_github() == want.render_github()
    assert issubclass(tcheck.CheckError, ValueError)
    with pytest.raises(ValueError, match="RPC001 mac-budget-exceeded"):
        tcheck.raise_on_error([got])
    tcheck.raise_on_error([tcheck.Diagnostic("RPC005", "g", "warns")])
    with pytest.raises(ValueError, match="unknown diagnostic code"):
        tcheck.Diagnostic("RPC999", "x", "no such code")


# -------------------------------------------------------------- byte models
@pytest.mark.parametrize("net", PAPER_CNNS)
def test_conv_byte_models_match(net):
    """Every zoo layer's `TrafficReport`, its bytes included, under both
    controllers and both iteration conventions."""
    for wl in tplan.conv_workloads(net):
        for strategy in ("paper_opt", "exact_opt"):
            for c in ("passive", "active"):
                for exact in (True, False):
                    got = tplan.plan(wl, P, strategy, c, exact)
                    want = jplan.plan(_jwl(wl), P, strategy, c, exact)
                    assert got.traffic.as_dict() == want.traffic.as_dict()
                    assert got.traffic.total_words == want.traffic.total_words
        with pytest.raises(ValueError, match="not a matmul schedule"):
            got.schedule.vmem_bytes()
        with pytest.raises(TypeError, match="matmul plans only"):
            got.vmem_bytes


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_gemm_byte_models_match(arch):
    """`Schedule.vmem_bytes`, `Plan.vmem_bytes`, `traffic_model_bytes`,
    `TrafficReport.bytes` and the byte grids, for every transformer GEMM of
    the arch in bf16 and fp32, at one block's shared memory and at 4 MiB."""
    for dtype in (torch.bfloat16, torch.float32):
        for wl in _gemms(arch, dtype):
            jw = _jwl(wl)
            for budget in (tplan.SMEM_BUDGET, 4 << 20):
                for c in ("passive", "active"):
                    got = tplan.plan(wl, budget, "exhaustive_vmem", c)
                    want = jplan.plan(jw, budget, "exhaustive_vmem", c)
                    assert got.traffic.as_dict() == want.traffic.as_dict()
                    assert got.vmem_bytes == want.vmem_bytes
                    s, js = got.schedule, want.schedule
                    for db in (True, False):
                        assert s.vmem_bytes(double_buffer=db) == \
                            js.vmem_bytes(double_buffer=db)
                        assert s.vmem_bytes(4, 4, db, workload=wl) == \
                            js.vmem_bytes(4, 4, db, workload=jw)
                    for widths in ({}, dict(in_bytes=4, out_bytes=4,
                                            acc_bytes=4)):
                        assert tgemm.traffic_model_bytes(
                            wl.m, wl.n, wl.k, s, c, **widths) == \
                            jgemm.traffic_model_bytes(
                                wl.m, wl.n, wl.k, js, c, **widths)
            bm, bn, bk = tgemm.aligned_block_candidates(wl.m, wl.n, wl.k)
            for w in (2, 4):
                assert np.array_equal(
                    tgemm.vmem_bytes_grid(bm, bn, bk, w, 4),
                    jgemm.vmem_bytes_grid(bm, bn, bk, w, 4))
                assert np.array_equal(
                    tgemm.working_set_bytes(wl, bm, bn, bk, False),
                    jgemm.vmem_bytes_grid(bm, bn, bk, wl.in_dtype.itemsize,
                                          4, False))
                for c in ("passive", "active"):
                    assert np.array_equal(
                        tgemm.traffic_model_bytes_grid(
                            wl.m, wl.n, wl.k, bm, bn, bk, c, in_bytes=w),
                        jgemm.traffic_model_bytes_grid(
                            wl.m, wl.n, wl.k, bm, bn, bk, c, in_bytes=w))


def test_matmul_blocks_and_partition_round_trip_as_the_reference():
    b, jb = tgemm.MatmulBlocks(128, 256, 64), jgemm.MatmulBlocks(128, 256, 64)
    assert b.vmem_bytes() == jb.vmem_bytes() == 229_376
    s = tplan.Schedule.from_blocks(b, "passive")
    assert s.as_blocks() == b and s.vmem_bytes() == b.vmem_bytes()
    p = tplan.Partition(3, 5)
    assert p.macs(3) == jplan.Partition(3, 5).macs(3) == 135
    c = tplan.Schedule.from_partition(p, "active")
    assert (c.kind, c.bm, c.bn, c.macs(3)) == ("conv", 3, 5, 135)
    assert c.as_partition() == p
    with pytest.raises(ValueError, match="not a conv schedule"):
        s.as_partition()
    assert tplan.Schedule(kind="matmul", bm=128, bn=128,
                          bk=128).vmem_bytes() == 196_608


@pytest.mark.parametrize("controller", ["passive", "active"])
def test_scalar_block_search_is_the_vectorized_one(controller):
    """`plan_matmul_blocks_scalar`, the triple loop, picks the vectorized
    search's blocks, and the reference's oracle picks them too."""
    for m, n, k in ((512, 512, 512), (300, 700, 900), (4096, 8960, 1536),
                    (128, 4096, 64), (1000, 300, 700)):
        for dtype in (torch.bfloat16, torch.float32):
            for budget in (50_000, tplan.SMEM_BUDGET, 1 << 20, 96 << 20):
                kw = dict(budget=budget, controller=controller)
                got = tgemm.plan_matmul_blocks_scalar(m, n, k, in_dtype=dtype,
                                                      **kw)
                fast = tgemm.plan_matmul_blocks(m, n, k, in_dtype=dtype, **kw)
                want = jgemm.plan_matmul_blocks_scalar(
                    m, n, k, in_bytes=dtype.itemsize, vmem_budget=budget,
                    controller=controller)
                assert (got.bm, got.bn, got.bk) == (fast.bm, fast.bn, fast.bk)
                assert dataclasses.astuple(got) == dataclasses.astuple(want)


# --------------------------------------------------------- verifier parity
@pytest.mark.parametrize("net", PAPER_CNNS)
def test_zoo_plans_and_netplans_verify_as_the_reference(net):
    for strategy in ("paper_opt", "exact_opt"):
        for c in ("passive", "active"):
            for wl in tplan.conv_workloads(net):
                got = tplan.plan(wl, P, strategy, c, checked=True)
                want = jplan.plan(_jwl(wl), P, strategy, c, checked=True)
                assert _view(tcheck.check(got)) == _view(jcheck.check(want))
            t = tplan.plan_graph(net, P, strategy, c, checked=True)
            j = jplan.plan_graph(net, P, strategy, c, checked=True)
            assert _view(tcheck.check(t)) == _view(jcheck.check(j)) == []
            assert t.traffic.bytes == j.traffic.bytes


def test_gemm_and_transformer_graph_plans_verify_as_the_reference():
    cfg, jcfg = tget_config("qwen2-1.5b"), jget_config("qwen2-1.5b")
    for budget in (tplan.SMEM_BUDGET, 96 << 20):
        for c in ("passive", "active"):
            for wl in _gemms("qwen2-1.5b", torch.bfloat16):
                got = tplan.plan(wl, budget, "exhaustive_vmem", c)
                want = jplan.plan(_jwl(wl), budget, "exhaustive_vmem", c)
                assert _view(tcheck.check(got)) == _view(jcheck.check(want))
            g = tplan.NetworkGraph.from_transformer(cfg, seq_len=512)
            jg = JGraph.from_transformer(jcfg, seq_len=512)
            got = tplan.plan_graph(g, budget, "exact_opt", c)
            want = jplan.plan_graph(jg, budget, "exact_opt", c)
            assert _view(tcheck.check(got)) == _view(jcheck.check(want))
            assert _view(tcheck.check(g)) == _view(jcheck.check(jg))


def _conv_wl(pk, mg=16, ng=32, g=1, k=3, s=28):
    return pk.plan.ConvWorkload(name="t", cin=g * mg, cout=g * ng, k=k,
                                wi=s, hi=s, wo=s, ho=s, groups=g)


def _small_netplan(pk, **kw):
    layers = [pk.plan.ConvWorkload(name=f"l{i}", cin=c, cout=c2, k=3,
                                   wi=16, hi=16, wo=16, ho=16)
              for i, (c, c2) in enumerate([(8, 16), (16, 16), (16, 8)])]
    return pk.plan.plan_graph(layers, **kw)


def _with_traffic(p, **changes):
    return dataclasses.replace(p, traffic=dataclasses.replace(p.traffic,
                                                              **changes))


def _fault_rpc004(pk):
    wl = _conv_wl(pk)
    object.__setattr__(wl, "groups", 3)
    return pk.check.check_workload(wl)


def _fault_rpc008(pk):
    wl = _conv_wl(pk)
    object.__setattr__(wl, "k", 0)
    return pk.check.check_workload(wl)


def _fault_rpc011(pk):
    g = _small_netplan(pk).graph
    t = g.workload_nodes[0].ins[0]
    g.tensors[t] = dataclasses.replace(g.tensors[t], word_bytes=8)
    return pk.check.check_graph(g)


def _fault_rpc013(pk):
    g = _small_netplan(pk).graph
    t = g.workload_nodes[0].out
    g.tensors[t] = dataclasses.replace(g.tensors[t],
                                       channels=g.tensors[t].channels + 1)
    return pk.check.check_graph(g)


def _fault_rpc021(pk):
    netp = _small_netplan(pk)
    inp = netp.graph.inputs[0]
    edges = tuple(dataclasses.replace(e, resident=True)
                  if e.tensor == inp else e for e in netp.edges)
    return pk.check.check_netplan(dataclasses.replace(netp, edges=edges))


def _gemm_plan(pk):
    return pk.plan.plan(pk.plan.MatmulWorkload(m=512, n=512, k=512), 1 << 20)


FAULTS = {
    "RPC001": lambda pk: pk.check.check_schedule(
        _conv_wl(pk), pk.plan.Schedule(kind="conv", bm=16, bn=32), budget=512),
    "RPC002-extent": lambda pk: pk.check.check_schedule(
        _conv_wl(pk, mg=8, ng=8), pk.plan.Schedule(kind="conv", bm=16, bn=4),
        budget=4096),
    "RPC002-bk": lambda pk: pk.check.check_schedule(
        _conv_wl(pk, mg=8, ng=8),
        pk.plan.Schedule(kind="conv", bm=4, bn=4, bk=2), budget=4096),
    "RPC003": lambda pk: pk.check.check_schedule(
        _conv_wl(pk), pk.plan.Schedule(kind="matmul", bm=128, bn=128, bk=128)),
    "RPC004": _fault_rpc004,
    "RPC005": lambda pk: pk.check.check_schedule(
        pk.plan.MatmulWorkload(m=512, n=512, k=512),
        pk.plan.Schedule(kind="matmul", bm=100, bn=128, bk=128),
        budget=1 << 20),
    "RPC006": lambda pk: pk.check.check_schedule(
        pk.plan.MatmulWorkload(m=4096, n=4096, k=4096),
        pk.plan.Schedule(kind="matmul", bm=4096, bn=4096, bk=4096),
        budget=2 ** 20),
    "RPC007": lambda pk: pk.check.check_plan(_with_traffic(
        pk.plan.plan(_conv_wl(pk)),
        interconnect_words=pk.plan.plan(_conv_wl(pk)).traffic.interconnect_words
        + 1.0)),
    "RPC008": _fault_rpc008,
    "RPC010-conv": lambda pk: pk.check.check_plan(_with_traffic(
        pk.plan.plan(_conv_wl(pk)),
        bytes=pk.plan.plan(_conv_wl(pk)).traffic.bytes + 1.0)),
    "RPC010-gemm": lambda pk: pk.check.check_plan(_with_traffic(
        _gemm_plan(pk), bytes=_gemm_plan(pk).traffic.bytes + 1.0)),
    "RPC011": _fault_rpc011,
    "RPC012": lambda pk: pk.check.check_netplan(_with_traffic(
        _small_netplan(pk),
        interconnect_words=_small_netplan(pk).traffic.interconnect_words + 64.0)),
    "RPC013": _fault_rpc013,
    "RPC020": lambda pk: pk.check.check_netplan(dataclasses.replace(
        _small_netplan(pk, residency_bytes=1 << 20), residency_bytes=64)),
    "RPC021": _fault_rpc021,
    "RPC022": lambda pk: pk.check.check_netplan(dataclasses.replace(
        _small_netplan(pk, residency_bytes=1 << 20),
        peak_resident_bytes=_small_netplan(
            pk, residency_bytes=1 << 20).peak_resident_bytes + 1)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_seeded_fault_gives_the_references_diagnostics(fault):
    """One corrupted input per code of RPC001-RPC022, as the reference's own
    tests seed them (tests/test_check.py), built in both packages."""
    got, want = FAULTS[fault](T), FAULTS[fault](J)
    assert _view(got) == _view(want)
    assert fault.split("-")[0] in {d.code for d in got}


def test_checked_plan_raises_where_the_reference_raises():
    wl = _conv_wl(T, k=7)            # K^2 = 49 > 16: even 1 x 1 breaks eq 1
    tplan.plan(wl, budget=16)        # unchecked: the fallback, silently
    with pytest.raises(tcheck.CheckError) as got:
        tplan.plan(wl, budget=16, checked=True)
    with pytest.raises(jcheck.CheckError) as want:
        jplan.plan(_jwl(wl), budget=16, checked=True)
    assert _view(got.value.diagnostics) == _view(want.value.diagnostics)
    assert "RPC001" in {d.code for d in got.value.diagnostics}
    bad = _small_netplan(T, residency_bytes=1 << 20)
    with pytest.raises(tcheck.CheckError, match="RPC020"):
        tcheck.verify(dataclasses.replace(bad, residency_bytes=64))
    assert tcheck.verify(dataclasses.replace(
        bad, peak_resident_bytes=bad.peak_resident_bytes + 1))[0].code == "RPC022"


def test_check_dispatch_and_summarize():
    netp = _small_netplan(T)
    assert tcheck.check(netp.graph) == []
    assert tcheck.check([netp, netp]) == []
    assert tcheck.check((_conv_wl(T), tplan.Schedule(kind="conv", bm=1,
                                                     bn=1))) == []
    lp = tconv.conv_launch_plan(cin=8, hp=10, wp=10, cout=16, kk=3)
    assert tcheck.check(lp) == []
    assert tcheck.summarize(FAULTS["RPC002-extent"](T)) == {"RPC002": 1}
    with pytest.raises(TypeError):
        tcheck.check(object())


# ------------------------------------------------------- launch pre-flight
@pytest.mark.parametrize("cnn", PAPER_CNNS)
def test_conv_checker_admits_what_conv_launch_plan_builds(cnn):
    """Over `test_torch_conv_tc.py`'s probe set (the zoo at shrink(56, 1)
    and shrink(8, 1), P 512-16384, five strategies, both controllers): the
    launch checker admits a dense "same"-padded conv node exactly when
    `conv_launch_plan` builds its launch, and refuses every grouped node."""
    for size in (56, 8):
        g = tplan.NetworkGraph.from_cnn(cnn).shrink(size, 1)
        for p_macs in (512, 2048, 16384):
            for strategy in STRATEGIES:
                for controller in ("active", "passive"):
                    for p in tplan.plan_many(g.workloads, p_macs, strategy,
                                             controller):
                        got = tcheck.check_conv_launch(p.workload, p.schedule)
                        if p.workload.groups != 1:
                            assert [d.code for d in got] == ["RPC031"]
                            continue
                        for dtype in (torch.float32, torch.bfloat16):
                            got = tcheck.check_conv_launch(
                                p.workload, p.schedule, dtype=dtype)
                            lp = tcheck.kernels.conv_plan(p.workload,
                                                          p.schedule, dtype)
                            assert got == [] and lp.launches == 2


def test_conv_checker_refuses_what_no_body_takes():
    g = tplan.NetworkGraph.from_cnn("resnet18").shrink(4000, 1)
    wl = g.workloads[0]
    sched = tplan.Schedule(kind="conv", bm=3, bn=8)
    got = tcheck.check_conv_launch(wl, sched)
    assert [d.code for d in got] == ["RPC032"]
    assert "no kernel body" in got[0].message
    with pytest.raises(ValueError, match="no kernel body"):
        tcheck.kernels.conv_plan(wl, sched)
    squeeze = tplan.NetworkGraph.from_cnn("squeezenet").workloads[0]
    assert [d.code for d in tcheck.check_conv_launch(
        squeeze, tplan.Schedule(kind="conv", bm=3, bn=8))] == ["RPC031"]
    assert [d.code for d in tcheck.check_conv_launch(
        wl, tplan.Schedule(kind="matmul", bm=128, bn=128, bk=128))] == ["RPC003"]


class _Loaded(Exception):
    """Raised where a wrapper that passed its checks would load a library."""


def _wrapper_takes(plan) -> bool:
    """Whether the plan's CUDA callable passes every check it makes before
    it loads the library (which is patched to raise `_Loaded`)."""
    x = torch.zeros(plan.inputs[0].array_shape, dtype=plan.cuda.keywords["dtype"])
    w = torch.zeros(plan.inputs[1].array_shape, dtype=x.dtype)
    try:
        plan.cuda(x, w)
    except _Loaded:
        return True
    except ValueError:
        return False
    raise AssertionError("the wrapper ran without loading a library")


def test_gemm_checker_admits_what_the_card_launches(monkeypatch):
    """The GEMM checker admits a launch exactly when `matmul_launch_plan`
    builds it and its CUDA wrapper passes the checks it makes before any
    library loads; a 128 x 256 active plan, which passes the planner's
    RPC006 at twice one block's shared memory, fails RPC032."""
    def loaded(name):
        raise _Loaded(name)
    monkeypatch.setattr(_build, "load", loaded)
    tmm._entry_point.cache_clear()
    tmm._pack_entry_point.cache_clear()
    seen = set()
    for m, k, n in ((256, 384, 512), (300, 200, 136)):
        for bm in (64, 128, 256):
            for bn in (64, 128, 256):
                for bk in (64, 128):
                    for c in ("active", "passive"):
                        for dtype in (torch.bfloat16, torch.float32):
                            s = tplan.Schedule(kind="matmul", bm=bm, bn=bn,
                                               bk=bk,
                                               controller=tplan.Controller(c))
                            got = tcheck.check_matmul_launch(m, k, n, s,
                                                             dtype=dtype)
                            lp = tmm.matmul_launch_plan(
                                m=m, k=k, n=n, bm=bm, bn=bn, bk=bk,
                                controller=c, dtype=dtype)
                            takes = _wrapper_takes(lp)
                            assert (got == []) == takes
                            seen.add(takes)
    assert seen == {True, False}
    wl = tplan.MatmulWorkload(m=4096, n=8960, k=1536)
    wide = tplan.Schedule(kind="matmul", bm=128, bn=256, bk=128,
                          controller=tplan.Controller.ACTIVE)
    assert tcheck.check_schedule(wl, wide, 2 * tplan.SMEM_BUDGET) == []
    assert wide.vmem_bytes(workload=wl) <= 2 * tplan.SMEM_BUDGET
    got = tcheck.check_matmul_launch(wl.m, wl.k, wl.n, wide,
                                     dtype=torch.bfloat16)
    assert [d.code for d in got] == ["RPC032"]
    assert "register tile 128 x 256" in got[0].message


def test_launch_geometry_codes():
    lp = tconv.conv_launch_plan(cin=8, hp=10, wp=10, cout=16, kk=3)
    assert tcheck.check_launch(lp) == []
    bad = dataclasses.replace(lp, inputs=(dataclasses.replace(
        lp.inputs[0], block_shape=(3, 10, 10)),) + lp.inputs[1:])
    assert [d.code for d in tcheck.check_launch(bad)] == ["RPC030"]
    bad = dataclasses.replace(lp, inputs=(dataclasses.replace(
        lp.inputs[0], block_shape=(8, 10)),) + lp.inputs[1:])
    assert [d.code for d in tcheck.check_launch(bad)] == ["RPC031"]
    assert [d.code for d in tcheck.check_launch(
        dataclasses.replace(lp, grid=(0, 1)))] == ["RPC031"]
    assert [d.code for d in tcheck.check_launch(
        dataclasses.replace(lp, smem_bytes=tplan.SMEM_BUDGET + 1))] == ["RPC032"]


@pytest.mark.parametrize("args,codes", [
    (dict(bh=2, sq=256, skv=256, d=64), []),
    (dict(bh=0, sq=256, skv=256, d=64), ["RPC031"]),
    (dict(bh=2, sq=100, skv=200, d=64, causal=False), ["RPC031"]),
    (dict(bh=2, sq=8, skv=64, d=64, q_offset=-1), ["RPC031"]),
    (dict(bh=12, sq=1, skv=1056, d=128, q_offset=1055, kv_group=6,
          dtype=torch.bfloat16), []),
])
def test_flash_launch_checks_as_the_reference(args, codes):
    """The reference's flash refusals, at the port's launch."""
    got = tcheck.check_flash_launch(**args)
    assert [d.code for d in got] == codes
    ref = {k: v for k, v in args.items() if k not in ("kv_group", "dtype")}
    ref["bh"] = args["bh"] // args.get("kv_group", 1) * args.get("kv_group", 1)
    assert [d.code for d in jcheck.check_flash_launch(**ref)] == codes
    if codes:
        with pytest.raises(tcheck.CheckError):
            tcheck.preflight_flash_launch(**args)


def test_network_gate_equals_the_reference_and_keeps_the_runners_messages():
    g = tplan.NetworkGraph.from_cnn("resnet18").shrink(56, 1)
    jg = JGraph.from_cnn("resnet18").shrink(56, 1)
    netp = tplan.plan_graph(g, P, "exact_opt", "active")
    jnetp = jplan.plan_graph(jg, P, "exact_opt", "active")
    params = {n.name: torch.zeros(n.workload.cout, n.workload.cin,
                                  n.workload.k, n.workload.k)
              for n in g.workload_nodes}
    assert tcheck.check_network_kernels(g, netp, params) == []
    assert jcheck.check_network_kernels(jg, jnetp) == []
    first = g.workload_nodes[0].name
    bad = dict(netp.schedules)
    bad[first] = tplan.Schedule(kind="matmul", bm=128, bn=128, bk=128)
    jbad = dict(jnetp.schedules)
    jbad[first] = jplan.Schedule(kind="matmul", bm=128, bn=128, bk=128)
    got = tcheck.check_network_kernels(g, bad, params)
    assert _view(got) == _view(jcheck.check_network_kernels(jg, jbad))
    assert got[0].message.startswith(f"{first}: needs a conv schedule")
    del bad[first], params[first]
    got = tcheck.check_network_kernels(g, bad, params)
    assert [d.code for d in got] == ["RPC033", "RPC033"]
    with pytest.raises(ValueError, match=f"{first}: conv node has no weights"):
        tcheck.preflight_network_kernels(g, bad, params)


def test_preflight_runs_the_certificates_once_per_geometry(monkeypatch):
    from repro_torch.check import dataflow as tdf
    g = tplan.NetworkGraph.from_cnn("resnet18").shrink(56, 1)
    netp = tplan.plan_graph(g, P, "exact_opt", "active")
    tcheck.clear_preflight_cache()
    tcheck.preflight_network_kernels(g, netp)
    distinct = len({(dataclasses.replace(n.workload, name=""),
                     netp.schedules[n.name]) for n in g.workload_nodes})
    assert tdf._conv_certificate.cache_info().misses == distinct
    tcheck.preflight_network_kernels(g, netp)
    assert tdf._conv_certificate.cache_info().misses == distinct
    assert tdf._conv_certificate.cache_info().hits >= len(g.workload_nodes)
    called = []
    monkeypatch.setattr(tdf, "check_network_dataflow",
                        lambda *a: called.append(1) or [])
    tcheck.preflight_network_kernels(g, netp, dataflow=False)
    assert called == []
    tcheck.preflight_network_kernels(g, netp)
    assert called == [1]


# ------------------------------------------------------ the certificates
def _shrunk_plans(strategy, controller):
    tg = tplan.NetworkGraph.from_cnn("resnet18").shrink(56, 1)
    jg = JGraph.from_cnn("resnet18").shrink(56, 1)
    return zip(tplan.plan_many(tg.workloads, P, strategy, controller),
               jplan.plan_many(jg.workloads, P, strategy, controller))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_conv_certificate_counts_equal_the_references(strategy):
    """For every ResNet-18 layer of the card's graph (`shrink(56, 1)`) under
    the five strategies and both controllers: the certificate's ``.ok`` and
    its model-level counts (x once per cout block, the accumulator chain's
    SRAM columns) equal the reference's trace-derived ones; the device's
    words sum to the model's plus their broken-out parts."""
    for c in ("passive", "active"):
        for tp, jp in _shrunk_plans(strategy, c):
            got = tcheck.conv_dataflow(tp.workload, tp.schedule)
            want = jcheck.conv_dataflow(jp.workload, jp.schedule)
            assert got.ok and want.ok and got.diagnostics == ()
            assert (got.sram_reads, got.sram_writes) == \
                (want.sram_reads, want.sram_writes)
            assert got.words["x"].model == want.words["x"].compute_reads
            assert got.words["out"].model == tp.traffic.output_words
            for w in got.words.values():
                assert w.device - w.model == sum(v for _, v in w.parts)


@pytest.mark.parametrize("controller", ["passive", "active"])
def test_gemm_certificate_counts_equal_the_references(controller):
    """Qwen2-1.5B's GEMMs at their paper_opt and exact_opt plans at one
    block's shared memory, in bf16 and in fp32 at 128^3: the model-level
    counts equal the reference's and `matmul_traffic`'s; a passive call's
    launches less its pack give (2 gk - 1) M N."""
    wls = _gemms("qwen2-1.5b", torch.bfloat16)
    wls += [dataclasses.replace(w, in_dtype=torch.float32, m=512) for w in wls]
    for wl in wls:
        for strategy in ("paper_opt", "exact_opt"):
            s = tplan.plan(wl, tplan.SMEM_BUDGET, strategy, controller).schedule
            if wl.in_dtype == torch.float32:
                s = dataclasses.replace(s, bm=128, bn=128, bk=128)
            got = tcheck.matmul_dataflow(wl, s)
            want = jcheck.matmul_dataflow(_jwl(wl), _jsched(s))
            assert got.ok and want.ok and got.diagnostics == ()
            assert (got.sram_reads, got.sram_writes) == \
                (want.sram_reads, want.sram_writes)
            for name, key in (("x", "a_reads"), ("w", "b_reads"),
                              ("out", "c_traffic")):
                t = tgemm.matmul_traffic(wl.m, wl.n, wl.k, s, controller)
                assert got.words[name].model == t[key]
            assert got.words["x"].model == want.words["x"].compute_reads
            assert got.words["w"].model == want.words["w"].compute_reads
            assert ("pack" in got.words) == (wl.in_dtype == torch.float32)


def test_a_tampered_plan_fails_its_certificate(monkeypatch):
    """A launch plan that walks the cin blocks twice, or a passive call
    that launches once, no longer moves the model's words: RPC045."""
    import repro_torch.check.kernels as tk
    wl = tplan.ConvWorkload(name="t", cin=64, cout=32, k=3, wi=16, hi=16,
                            wo=16, ho=16)
    s = tplan.Schedule(kind="conv", bm=16, bn=16,
                       controller=tplan.Controller.PASSIVE)
    real = tk.conv_plan
    monkeypatch.setattr(tcheck.dataflow, "conv_plan", lambda *a: dataclasses.replace(
        real(*a), loops=(("cin", 8),) + real(*a).loops[1:]))
    got = tcheck.conv_dataflow(wl, s)
    assert {d.code for d in got.diagnostics} == {"RPC045", "RPC043"}
    monkeypatch.setattr(tcheck.dataflow, "conv_plan", real)
    assert tcheck.conv_dataflow(wl, s).ok
    real_mm = tmm.matmul_launch_plan
    monkeypatch.setattr(tmm, "matmul_launch_plan", lambda **kw: dataclasses.replace(
        real_mm(**kw), launches=1))
    gw = tplan.MatmulWorkload(m=256, n=256, k=512)
    got = tcheck.matmul_dataflow(gw, tplan.Schedule(
        kind="matmul", bm=128, bn=128, bk=128,
        controller=tplan.Controller.PASSIVE))
    assert {"RPC043", "RPC045"} <= {d.code for d in got.diagnostics}


@pytest.mark.parametrize("c", ["passive", "active"])
def test_space_certificates_count_as_the_reference(c):
    """`certify_conv_space` over every layer of ResNet-18 (the zoo's and the
    card's graph) and a grouped layer, `certify_matmul_space` over GEMMs at
    one block's shared memory and at the reference's budget: the candidate
    counts and ``.ok`` equal the reference's."""
    layers = list(tplan.conv_workloads("resnet18"))
    layers += list(tplan.NetworkGraph.from_cnn("resnet18").shrink(56, 1).workloads)
    layers.append(tplan.conv_workloads("mobilenet")[1])        # depthwise
    for wl in layers:
        got = tcheck.certify_conv_space(wl, controller=c)
        want = jcheck.certify_conv_space(_jwl(wl), controller=c)
        assert (got.n_candidates, got.ok) == (want.n_candidates, want.ok)
        assert _view(got.diagnostics) == [
            (code, s.replace(want.subject, got.subject), sev)
            for code, s, sev in _view(want.diagnostics)]
        assert got.n_equal_hbm + got.n_bounded_hbm + got.n_exceeding \
            + got.n_unlaunchable == got.n_candidates
    for wl in _gemms("qwen2-1.5b", torch.bfloat16)[:3] + [
            tplan.MatmulWorkload(m=1024, n=1024, k=1024)]:
        for budget in (tplan.SMEM_BUDGET, jplan.DEFAULT_VMEM_BUDGET):
            got = tcheck.certify_matmul_space(wl, budget, c)
            want = jcheck.certify_matmul_space(_jwl(wl), budget, c)
            assert (got.n_candidates, got.ok) == (want.n_candidates, want.ok)
            assert got.ok
            assert tplan.certify_space(wl, budget, controller=c).n_candidates \
                == got.n_candidates


def test_flash_certificate_passes_where_the_reference_charges_kv_per_q_block():
    """At (sq 17, d 32, bq 16, bk 32) the reference's proof fails (ROADMAP
    C3): its model charges K and V once per q block (2 x 17 x 32 = 1088
    words), while its Pallas trace counts them once (544), because the kv
    block index never changes along the q axis. The port's thread blocks
    read their kv range themselves, so its certificate holds K and V to at
    most one walk of Skv a block reading keys, equal when not causal, and
    passes at that shape."""
    with pytest.raises(jcheck.CheckError, match="RPC045"):
        jcheck.preflight_flash_dataflow(1, 17, 17, 32, bq=16, bk=32)
    got = tcheck.flash_dataflow(1, 17, 17, 32, bq=16, bk=32)
    assert got.ok and got.diagnostics == ()
    assert got.words["k"].device <= got.words["k"].model
    tcheck.preflight_flash_dataflow(1, 17, 17, 32, bq=16, bk=32)


@pytest.mark.parametrize("args", [
    dict(bh=2, sq=256, skv=256, d=64),
    dict(bh=2, sq=256, skv=256, d=64, causal=False),
    dict(bh=2, sq=1, skv=256, d=64, bq=1, q_offset=255),
    dict(bh=48, sq=1024, skv=1024, d=128, kv_group=6, dtype=torch.bfloat16),
    dict(bh=48, sq=1024, skv=1024, d=128, kv_group=6, dtype=torch.float32),
    dict(bh=4, sq=300, skv=300, d=256, dtype=torch.float32),
    dict(bh=12, sq=1, skv=1056, d=128, q_offset=1055, kv_group=6,
         dtype=torch.bfloat16),
])
def test_flash_certificate_at_every_body(args):
    got = tcheck.flash_dataflow(**args)
    assert got.ok and got.diagnostics == ()
    k = got.words["k"]
    assert k.device <= k.model
    if not args.get("causal", True):
        assert k.device == k.model
    if got.words.get("partials") is None:
        assert got.sram_writes > 0


def test_dataflow_sweep_and_cli(capsys):
    diags, timings = tcheck.check_dataflow(nets=("alexnet",))
    assert diags == [] and timings["_certified"] > 0
    from repro_torch.check.__main__ import main
    assert main(["--plans", "--nets", "alexnet", "--controllers",
                 "passive", "--kernels"]) == 0
    assert "0 error(s)" in capsys.readouterr().out
    assert main(["--codes"]) == 0
    assert "RPC045" in capsys.readouterr().out
