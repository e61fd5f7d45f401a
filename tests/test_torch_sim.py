"""The port's SoC simulator (`repro_torch.sim`, `repro_torch.faults.models`)
against the live reference (`repro.sim`, `repro.faults.models`) on the same
seeded workloads, schedules and grids: every `SimReport` field, every
`simulate_batch` column, the fault windows, the network walk, the sim
objectives' schedules through ``plan``, ``dse.sweep``, ``plan_graph`` and
``plan_graphs``, and the simulator's Perfetto timeline, all compared with
``==`` (the simulator runs no kernel: its arithmetic is the same float64
operations in the same order, so no tolerance). The torch backend of
`simulate_batch` (float64 on the CPU here) is held to the numpy one with
``==`` as well."""

import dataclasses
import json

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                                   # pragma: no cover
    from _hypothesis_stub import given, settings, st

from repro import plan as jplan
from repro import sim as jsim
from repro.core.cnn_zoo import PAPER_CNNS
from repro.faults import models as jfaults
from repro.obs import export as jexport
from repro.plan import dse as jdse
from repro.plan import fleet as jfleet
from repro_torch import errors as terrors
from repro_torch import faults as tfaults
from repro_torch import plan as tplan
from repro_torch import sim as tsim
from repro_torch.obs import export as texport
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.plan import dse as tdse
from repro_torch.plan import fleet as tfleet
from repro_torch.sim import engine as tengine

P = 2048
CONTROLLERS = ("passive", "active")
ZOO3 = ("alexnet", "resnet18", "mobilenet")
# Every numeric SimReport metric the batch evaluator mirrors.
METRICS = ("cycles", "latency_s", "energy_pj", "interconnect_words",
           "input_words", "output_words", "sram_reads", "sram_writes",
           "interconnect_bytes", "dram_words", "dram_bytes", "row_hits",
           "row_misses", "bank_conflicts", "avg_bw_bytes_s",
           "peak_bw_bytes_s", "row_miss_rate")


@pytest.fixture(autouse=True)
def _clear_caches():
    for pk in (tplan, jplan):
        pk.clear_plan_graph_cache()
    yield
    for pk in (tplan, jplan):
        pk.clear_plan_graph_cache()


# ------------------------------------------------------------ conversions
def _jwl(wl):
    if isinstance(wl, tplan.ConvWorkload):
        return jplan.ConvWorkload(**dataclasses.asdict(wl))
    return jplan.MatmulWorkload(m=wl.m, n=wl.n, k=wl.k, name=wl.name,
                                in_bytes=wl.in_dtype.itemsize,
                                out_bytes=wl.out_dtype.itemsize,
                                acc_bytes=wl.acc_dtype.itemsize)


def _jsched(s):
    return jplan.Schedule(kind=s.kind, bm=s.bm, bn=s.bn, bk=s.bk,
                          controller=jplan.Controller(s.controller.value))


def _jcands(c):
    return jplan.space.Candidates(c.kind, c.bm, c.bn, c.bk)


def _jparams(p):
    return jsim.SimParams(dram=jsim.DramParams(**dataclasses.asdict(p.dram)),
                          sram=jsim.SramParams(**dataclasses.asdict(p.sram)),
                          **{f.name: getattr(p, f.name)
                             for f in dataclasses.fields(p)
                             if f.name not in ("dram", "sram")})


def _jfault(f):
    kw = {fl.name: getattr(f, fl.name) for fl in dataclasses.fields(f)
          if fl.init and not fl.name.startswith("affects_")}
    if "to" in kw:
        kw["to"] = jplan.Controller(kw["to"].value)
    return getattr(jfaults, type(f).__name__)(**kw)


def _fields(f):
    """A fault's fields, a controller as its value."""
    return {k: getattr(v, "value", v)
            for k, v in dataclasses.asdict(f).items()}


def _report(r):
    """Every field of either package's `SimReport`, its properties too."""
    out = {f.name: getattr(r, f.name) for f in dataclasses.fields(r)
           if f.name not in ("controller", "params", "phases")}
    out["controller"] = r.controller.value
    out["params"] = dataclasses.asdict(r.params)
    out["phases"] = [dataclasses.asdict(p) for p in r.phases]
    for prop in ("latency_s", "avg_bw_bytes_s", "peak_bw_bytes_s",
                 "energy_pj", "row_miss_rate"):
        out[prop] = getattr(r, prop)
    out["node_breakdown"] = r.node_breakdown()
    out["traffic"] = dataclasses.astuple(r.as_traffic_report())
    out["summary"] = r.summary()
    return out


def _schedules(netp):
    return {k: (v.kind, v.bm, v.bn, v.bk, v.controller.value)
            for k, v in netp.schedules.items()}


def _netp(netp):
    return (_schedules(netp), sorted(netp.resident_tensors),
            dataclasses.astuple(netp.traffic), netp.peak_resident_bytes,
            [(p.schedule.bm, p.schedule.bn, p.schedule.bk)
             for p in netp.baseline])


def _col(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------- tables and params
def test_params_defaults_and_energy_table_equal_reference():
    assert dataclasses.asdict(tsim.DEFAULT_PARAMS) == \
        dataclasses.asdict(jsim.DEFAULT_PARAMS)
    assert tsim.DEFAULT_PARAMS.clock_ghz == 1.0
    assert tsim.DEFAULT_PARAMS.cycle_s == jsim.DEFAULT_PARAMS.cycle_s
    for name in ("ENERGY_PJ_SRAM_BYTE", "ENERGY_PJ_INTERCONNECT_BYTE",
                 "ENERGY_PJ_DRAM_BYTE", "ENERGY_PJ_DRAM_ROW_ACT"):
        assert getattr(tsim, name) == getattr(jsim, name)
    assert tsim.energy_breakdown(3.0, 5.0, 7.0, 11) == \
        jsim.energy_breakdown(3.0, 5.0, 7.0, 11)
    assert sorted(tsim.__all__) == sorted(jsim.__all__)
    with pytest.raises(ValueError):
        tsim.DramParams(burst_bytes=64, row_bytes=32)
    with pytest.raises(ValueError):
        tsim.SimParams(clock_ghz=0)


# ----------------------------------------------------------------- simulate
@pytest.mark.parametrize("controller", CONTROLLERS)
@pytest.mark.parametrize("net", PAPER_CNNS)
def test_layer_simulate_equals_reference(net, controller):
    """Every conv layer of the zoo under its exact_opt schedule, all spilled
    and with a third of its input resident and its output resident: every
    report field and phase ``==`` the reference's, and the words ``==`` the
    port's own traffic report."""
    for wl in tplan.conv_workloads(net):
        sched = tplan.plan(wl, P, "exact_opt", controller).schedule
        for spilled, out_spilled in ((None, True),
                                     (wl.in_acts // 3, False)):
            got = tsim.simulate(wl, sched, spilled_in_words=spilled,
                                out_spilled=out_spilled)
            want = jsim.simulate(_jwl(wl), _jsched(sched),
                                 spilled_in_words=spilled,
                                 out_spilled=out_spilled)
            assert _report(got) == _report(want), (wl.name, spilled)
        tr = tplan.traffic_report(wl, sched, exact_iters=True)
        rep = tsim.simulate(wl, sched)
        assert (rep.interconnect_words, rep.sram_reads, rep.sram_writes) == \
            (tr.interconnect_words, tr.sram_reads, tr.sram_writes)


@pytest.mark.parametrize("controller", CONTROLLERS)
def test_gemm_simulate_equals_reference(controller):
    """Qwen2-1.5B's five GEMMs at 256 tokens in bf16 and fp32 under their
    exhaustive and first-order blocks, and ragged blocks."""
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-1.5b")
    for dtype in (torch.bfloat16, torch.float32):
        for wl in tplan.transformer_matmuls(cfg, seq_len=256):
            wl = dataclasses.replace(wl, in_dtype=dtype, out_dtype=dtype)
            scheds = [tplan.plan(wl, None, s, controller).schedule
                      for s in ("exhaustive_vmem", "first_order")]
            scheds.append(tplan.Schedule("matmul", 96, 200, 300,
                                         tplan.Controller(controller)))
            for sched in scheds:
                for spilled, out_spilled in ((None, True),
                                             (wl.m * wl.k // 2, False)):
                    got = tsim.simulate(wl, sched, spilled_in_words=spilled,
                                        out_spilled=out_spilled)
                    want = jsim.simulate(_jwl(wl), _jsched(sched),
                                         spilled_in_words=spilled,
                                         out_spilled=out_spilled)
                    assert _report(got) == _report(want), (wl.name, sched)


def test_nondefault_params_equal_reference():
    wl = tplan.conv_workloads("alexnet")[2]
    sched = tplan.plan(wl, P, "paper_opt", "passive").schedule
    for params in (tsim.SimParams(dma_double_buffer=False),
                   tsim.SimParams(sram=tsim.SramParams(ports_per_bank=1)),
                   tsim.SimParams(dram=tsim.DramParams(row_bytes=256,
                                                       t_row_miss=400),
                                  bus_bytes_per_cycle=4, clock_ghz=0.7)):
        got = tsim.simulate(wl, sched, params)
        want = jsim.simulate(_jwl(wl), _jsched(sched), _jparams(params))
        assert _report(got) == _report(want)


def test_simulate_guards_and_checked():
    conv = tplan.conv_workloads("alexnet")[0]
    gemm = tplan.MatmulWorkload(m=64, n=64, k=64)
    cs = tplan.Schedule("conv", 3, 16)
    ms = tplan.Schedule("matmul", 32, 32, 32)
    with pytest.raises(ValueError, match="conv schedule"):
        tsim.simulate(conv, ms)
    with pytest.raises(ValueError, match="matmul schedule"):
        tsim.simulate(gemm, cs)
    with pytest.raises(ValueError, match="outside"):
        tsim.simulate(conv, cs, spilled_in_words=conv.in_acts + 1)
    with pytest.raises(TypeError, match="unknown workload"):
        tsim.simulate("conv", cs)
    from repro_torch.check import CheckError
    with pytest.raises(CheckError, match="failed verification"):
        tsim.simulate(conv, tplan.Schedule("conv", 3, 4096), checked=True)
    ok = tplan.plan(conv, P, "exact_opt", "active").schedule
    assert tsim.simulate(conv, ok, checked=True) == tsim.simulate(conv, ok)
    assert tengine.epoch_count(conv, cs) == jsim.engine.epoch_count(
        _jwl(conv), _jsched(cs))


# ------------------------------------------------------------ fault windows
FAULTS = [
    [tfaults.DramThrottle(start_epoch=3, duration_epochs=40,
                          t_burst_factor=2.5, row_buffer_disabled=True)],
    [tfaults.EngineDegrade(start_epoch=0, duration_epochs=10,
                           surviving_frac=0.25),
     tfaults.DmaStall(start_epoch=5, duration_epochs=None)],
    [tfaults.VmemShrink(start_epoch=1), tfaults.ControllerFallback(),
     tfaults.RequestStorm(start_epoch=2)],
]


@pytest.mark.parametrize("case", range(len(FAULTS)))
def test_fault_windows_equal_reference(case):
    """Transient faults change timing and energy only: every report field
    equals the reference's, and the word totals equal the healthy run's."""
    faults = FAULTS[case]
    jf = [_jfault(f) for f in faults]
    for wl in tplan.conv_workloads("resnet18")[:6]:
        for c in CONTROLLERS:
            sched = tplan.plan(wl, P, "exact_opt", c).schedule
            got = tsim.simulate(wl, sched, faults=faults)
            want = jsim.simulate(_jwl(wl), _jsched(sched), faults=jf)
            assert _report(got) == _report(want)
            healthy = tsim.simulate(wl, sched)
            assert got.as_traffic_report() == healthy.as_traffic_report()
    gemm = tplan.MatmulWorkload(m=300, n=200, k=500)
    sched = tplan.Schedule("matmul", 64, 64, 128)
    assert _report(tsim.simulate(gemm, sched, faults=faults)) == \
        _report(jsim.simulate(_jwl(gemm), _jsched(sched), faults=jf))
    netp = tplan.plan_graph("alexnet", P, "exact_opt", "active")
    jnetp = jplan.plan_graph("alexnet", P, "exact_opt", "active")
    got = tsim.simulate_network(netp, faults=faults)
    assert _report(got) == _report(jsim.simulate_network(jnetp, faults=jf))
    assert got.as_traffic_report() == netp.simulate().as_traffic_report()


def test_fault_models_equal_reference():
    """The taxonomy: windows, shifts, both projections and the schedule's
    partitions, against the reference's."""
    p = tsim.DEFAULT_PARAMS
    for f in [x for fs in FAULTS for x in fs]:
        j = _jfault(f)
        assert (f.affects_sim, f.affects_plan, f.affects_serve) == \
            (j.affects_sim, j.affects_plan, j.affects_serve)
        for n in (0, 7, 100):
            assert f.window(n) == j.window(n)
        for d in (-5, 0, 9):
            assert _fields(f.shifted(d)) == _fields(j.shifted(d))
        assert dataclasses.asdict(f.apply_params(p)) == \
            dataclasses.asdict(j.apply_params(_jparams(p)))
        for budget in (None, 1000):
            got = f.apply_plan(tfaults.PlanArgs(budget, 2**20,
                                                tplan.Controller.ACTIVE))
            want = j.apply_plan(jfaults.PlanArgs(budget, 2**20,
                                                 jplan.Controller.ACTIVE))
            assert (got.budget, got.residency_bytes, got.controller.value) \
                == (want.budget, want.residency_bytes, want.controller.value)
    events = tuple(tfaults.FaultEvent(t, f) for t, f in
                   enumerate(x for fs in FAULTS for x in fs))
    fs = tfaults.FaultSchedule(seed=7, horizon_s=10.0, events=events)
    js = jfaults.FaultSchedule(seed=7, horizon_s=10.0, events=tuple(
        jfaults.FaultEvent(e.t_s, _jfault(e.fault)) for e in events))
    assert [type(f).__name__ for f in fs.sim_faults()] == \
        [type(f).__name__ for f in js.sim_faults()]
    assert [type(f).__name__ for f in fs.plan_faults()] == \
        [type(f).__name__ for f in js.plan_faults()]
    assert len(fs.storms()) == len(js.storms()) == 1 and len(fs) == 6
    with pytest.raises(ValueError, match="time-ordered"):
        tfaults.FaultSchedule(seed=0, horizon_s=1.0,
                              events=tuple(reversed(events)))
    for bad in (lambda: tfaults.EngineDegrade(surviving_frac=0.0),
                lambda: tfaults.DramThrottle(t_burst_factor=0.5),
                lambda: tfaults.RequestStorm(rate_factor=0.5)):
        with pytest.raises(ValueError):
            bad()


# ------------------------------------------------------------ the batch
def _assert_batch(wl, cands, controller, params=None, spilled=None,
                  out_spilled=True):
    """Every column ``==`` the reference's batch, and ``==`` the port's own
    scalar `simulate` candidate by candidate."""
    got = tsim.simulate_batch(wl, cands, controller, params,
                              spilled_in_words=spilled,
                              out_spilled=out_spilled)
    want = jsim.simulate_batch(_jwl(wl), _jcands(cands), controller,
                               None if params is None else _jparams(params),
                               spilled_in_words=spilled,
                               out_spilled=out_spilled)
    assert len(got) == len(want) == len(cands)
    for f in METRICS:
        a, b = got.metric(f), want.metric(f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for key, val in got.energy_breakdown.items():
        assert np.array_equal(val, want.energy_breakdown[key]), key
    vector = np.ndim(spilled) == 1
    for i in range(len(cands)):
        for r, s in enumerate(np.atleast_1d(spilled) if vector else [spilled]):
            rep = tsim.simulate(wl, cands.schedule_at(
                i, tplan.Controller(controller)), params,
                                spilled_in_words=None if s is None else int(s),
                                out_spilled=out_spilled)
            for f in METRICS:
                col = got.metric(f)
                assert (col[r] if col.ndim == 2 else col)[i] == \
                    getattr(rep, f), (f, i, s)


@settings(max_examples=20, deadline=None)
@given(cin=st.integers(1, 80), cout=st.integers(1, 80),
       k=st.sampled_from([1, 3, 5]), hw=st.integers(2, 20),
       g=st.sampled_from([1, 2]), budget=st.sampled_from([512, 2048]),
       controller=st.sampled_from(CONTROLLERS),
       spill_num=st.integers(0, 4), out_spilled=st.booleans())
def test_property_conv_batch_equals_reference_and_scalar(
        cin, cout, k, hw, g, budget, controller, spill_num, out_spilled):
    wl = tplan.ConvWorkload(name="prop", cin=cin * g, cout=cout * g, k=k,
                            wi=hw, hi=hw, wo=hw, ho=hw, groups=g)
    cands = tplan.space.ConvExactSpace()(wl, budget)
    _assert_batch(wl, cands, controller, spilled=(wl.in_acts * spill_num) // 4,
                  out_spilled=out_spilled)


@settings(max_examples=12, deadline=None)
@given(m=st.integers(1, 600), n=st.integers(1, 600), k=st.integers(1, 600),
       controller=st.sampled_from(CONTROLLERS),
       spill_num=st.integers(0, 4), out_spilled=st.booleans())
def test_property_gemm_batch_equals_reference_and_scalar(
        m, n, k, controller, spill_num, out_spilled):
    wl = tplan.MatmulWorkload(m=m, n=n, k=k)
    cands = tplan.space.AlignedBlockSpace(max_block=512)(wl, 1 << 22)
    ragged = [(1, 1, 1), (m, n, k), (max(1, m // 3), max(1, n // 3),
                                     max(1, k // 3))]
    cands = tplan.Candidates(
        kind="matmul",
        bm=np.concatenate([cands.bm, [b[0] for b in ragged]]),
        bn=np.concatenate([cands.bn, [b[1] for b in ragged]]),
        bk=np.concatenate([cands.bk, [b[2] for b in ragged]]))
    _assert_batch(wl, cands, controller, spilled=(m * k * spill_num) // 4,
                  out_spilled=out_spilled)


@pytest.mark.parametrize("controller", CONTROLLERS)
def test_vector_spilled_and_params_equal_reference(controller):
    """One row per beam state, conv and matmul, and the non-default
    machines, against the reference and the scalar walk."""
    conv = tplan.conv_workloads("alexnet")[1]
    conv_c = tplan.space.ConvExactSpace()(conv, P)
    gemm = tplan.MatmulWorkload(m=96, n=200, k=64)
    gemm_c = tplan.space.AlignedBlockSpace(max_block=128)(gemm, 1 << 20)
    for wl, cands, wl_in in ((conv, conv_c, conv.in_acts),
                             (gemm, gemm_c, gemm.m * gemm.k)):
        spills = np.asarray([0, wl_in // 3, wl_in // 2, wl_in], np.int64)
        for out_spilled in (True, False):
            _assert_batch(wl, cands, controller, spilled=spills,
                          out_spilled=out_spilled)
    for params in (tsim.SimParams(dma_double_buffer=False),
                   tsim.SimParams(sram=tsim.SramParams(ports_per_bank=1)),
                   tsim.SimParams(dram=tsim.DramParams(row_bytes=256,
                                                       t_row_miss=400),
                                  bus_bytes_per_cycle=4)):
        _assert_batch(conv, conv_c, controller, params)


@pytest.mark.parametrize("controller", CONTROLLERS)
@pytest.mark.parametrize("net", ZOO3)
def test_torch_backend_equals_numpy(net, controller):
    """`simulate_batch(xp=torch)` in float64 (here on the CPU): every column
    ``==`` numpy's, integer columns int64, under scalar and vector spills,
    both residency variants, and a GEMM grid."""
    work = []
    for wl in tplan.conv_workloads(net):
        work.append((wl, tplan.space.ConvExactSpace()(wl, P), wl.in_acts))
    gemm = tplan.MatmulWorkload(m=1000, n=1536, k=700)
    work.append((gemm, tplan.space.AlignedBlockSpace()(gemm, tplan.SMEM_BUDGET),
                 gemm.m * gemm.k))
    for wl, cands, wl_in in work:
        for spilled in (None, wl_in // 7,
                        np.asarray([0, wl_in // 5, wl_in], np.int64)):
            for out_spilled in (True, False):
                kw = dict(spilled_in_words=spilled, out_spilled=out_spilled)
                a = tsim.simulate_batch(wl, cands, controller, **kw)
                b = tsim.simulate_batch(wl, cands, controller, xp=torch,
                                        device="cpu", **kw)
                for f in METRICS:
                    x, y = a.metric(f), b.metric(f)
                    assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
                    y = _col(y)
                    assert x.dtype == y.dtype and np.array_equal(x, y), \
                        (wl.name, f)


def test_batch_guards_and_device():
    conv = tplan.conv_workloads("alexnet")[0]
    cands = tplan.space.ConvExactSpace()(conv, P)
    gemm = tplan.MatmulWorkload(m=64, n=64, k=64)
    gc = tplan.space.AlignedBlockSpace()(gemm, tplan.SMEM_BUDGET)
    with pytest.raises(ValueError, match="conv candidates"):
        tsim.simulate_batch(conv, gc)
    with pytest.raises(ValueError, match="matmul candidates"):
        tsim.simulate_batch(gemm, cands)
    with pytest.raises(ValueError, match="outside"):
        tsim.simulate_batch(conv, cands, spilled_in_words=-1)
    with pytest.raises(ValueError, match="entries outside"):
        tsim.simulate_batch(conv, cands, spilled_in_words=[0, conv.in_acts + 1])
    with pytest.raises(ValueError, match="1-D"):
        tsim.simulate_batch(conv, cands, spilled_in_words=[[0]])
    with pytest.raises(TypeError, match="unknown workload"):
        tsim.simulate_batch("x", cands)
    with pytest.raises(KeyError, match="unknown sim metric"):
        tsim.simulate_batch(conv, cands).metric("wall_s")
    with pytest.raises(KeyError, match="per-candidate"):
        tsim.simulate_batch(conv, cands).metric("energy_breakdown")
    with pytest.raises(ValueError, match="device= is for xp=torch"):
        tsim.simulate_batch(conv, cands, device="cpu")
    with pytest.raises(TypeError, match="xp=numpy or xp=torch"):
        tsim.simulate_batch(conv, cands, xp=dataclasses)
    if not torch.cuda.is_available():
        for dev in (None, "cuda"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tsim.simulate_batch(conv, cands, xp=torch, device=dev)


def test_torch_backend_divides_tensor_by_tensor(monkeypatch):
    """The torch backend never divides with ``/`` (on the card torch divides
    a tensor by a host scalar as a product with its reciprocal, which can
    move the last bit): every division of the evaluator is one `torch.div`
    of two tensors."""
    seen = []
    real = torch.div

    def spy(a, b, *args, **kw):
        seen.append(isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor))
        return real(a, b, *args, **kw)

    def refuse(*args):
        raise AssertionError("a tensor divided with /")

    for name in ("__truediv__", "__rtruediv__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    monkeypatch.setattr(torch, "div", spy)
    wl = tplan.conv_workloads("resnet18")[3]
    gemm = tplan.MatmulWorkload(m=300, n=200, k=500)
    for w, cands in ((wl, tplan.space.ConvExactSpace()(wl, P)),
                     (gemm, tplan.space.AlignedBlockSpace()(
                         gemm, tplan.SMEM_BUDGET))):
        for spilled in (None, np.asarray([5, 1000])):
            res = tsim.simulate_batch(w, cands, "active", xp=torch,
                                      device="cpu", spilled_in_words=spilled)
            for f in METRICS:
                res.metric(f)
    assert seen and all(seen)


# ----------------------------------------------------- the network walk
@pytest.mark.parametrize("controller", CONTROLLERS)
@pytest.mark.parametrize("net", PAPER_CNNS)
def test_simulate_network_equals_traffic_and_reference(net, controller):
    """`NetPlan.simulate` on every zoo CNN's 2 MiB exact_opt NetPlan: its
    word totals ``==`` `NetPlan.traffic`, and every field ``==`` the
    reference's report of the reference's plan."""
    netp = tplan.plan_graph(net, P, "exact_opt", controller)
    rep = netp.simulate()
    t = netp.traffic
    assert (rep.interconnect_words, rep.input_words, rep.output_words,
            rep.sram_reads, rep.sram_writes) == \
        (t.interconnect_words, t.input_words, t.output_words, t.sram_reads,
         t.sram_writes)
    assert rep.interconnect_bytes == t.bytes
    jnetp = jplan.plan_graph(net, P, "exact_opt", controller)
    assert _report(rep) == _report(jnetp.simulate())
    # the bare-graph calling convention gives the same report
    bare = tsim.simulate_network(netp.graph, netp.schedules,
                                 netp.resident_tensors)
    assert _report(bare) == _report(rep)


def test_simulate_network_guards_and_cache():
    netp = tplan.plan_graph("alexnet", P)
    with pytest.raises(TypeError, match="not both"):
        tsim.simulate_network(netp, schedules=netp.schedules)
    with pytest.raises(TypeError, match="explicit"):
        tsim.simulate_network(netp.graph)
    tsim.clear_node_report_cache()
    tsim.simulate_network(netp)
    first = tsim.node_report_cache_info()
    tsim.simulate_network(netp)
    again = tsim.node_report_cache_info()
    assert first.hits == 0 and again.hits == first.misses == \
        len(netp.graph.workload_nodes)


# ------------------------------------------------- objectives and planners
@pytest.mark.parametrize("controller", CONTROLLERS)
@pytest.mark.parametrize("strategy", ("sim_latency", "sim_energy"))
def test_sim_strategies_plan_and_sweep_equal_reference(strategy, controller):
    """``plan`` and ``dse.sweep`` under the sim presets: the same schedules
    and traffic as the reference's, per layer of two zoo CNNs and for
    Qwen2-1.5B's GEMMs at 256 tokens (at one block's shared memory)."""
    for wl in tplan.conv_workloads("resnet18") + tplan.conv_workloads("mobilenet"):
        got = tplan.plan(wl, P, strategy, controller)
        want = jplan.plan(_jwl(wl), P, strategy, controller)
        assert (got.schedule.bm, got.schedule.bn) == \
            (want.schedule.bm, want.schedule.bn)
        assert got.traffic.interconnect_words == want.traffic.interconnect_words
    from repro_torch.configs import get_config
    for wl in tplan.transformer_matmuls(get_config("qwen2-1.5b"), seq_len=256):
        got = tplan.plan(wl, tplan.SMEM_BUDGET, strategy, controller).schedule
        want = jplan.plan(_jwl(wl), tplan.SMEM_BUDGET, strategy,
                          controller).schedule
        assert (got.bm, got.bn, got.bk) == (want.bm, want.bn, want.bk)
    rows_t = tdse.sweep(["alexnet", "squeezenet"], (512, P), (strategy,),
                        (controller,), objective=strategy)
    rows_j = jdse.sweep(["alexnet", "squeezenet"], (512, P), (strategy,),
                        (controller,), objective=strategy)
    assert len(rows_t) == len(rows_j) > 0
    for a, b in zip(rows_t, rows_j):
        assert {k: v for k, v in a.items() if k != "us_per_call"} == \
            {k: v for k, v in b.items() if k != "us_per_call"}


def test_sim_objective_objects_equal_reference():
    wl = tplan.conv_workloads("alexnet")[2]
    cands = tplan.space.ConvExactSpace()(wl, P)
    jc = _jcands(cands)
    assert tplan.get_objective("sim_latency") is tsim.sim_latency
    assert tplan.get_objective("sim_energy") is tsim.sim_energy
    assert repr(tsim.sim_latency) == repr(jsim.sim_latency)
    for c in CONTROLLERS:
        for obj in ("sim_latency", "sim_energy"):
            got = tplan.get_objective(obj)(wl, cands, tplan.Controller(c))
            want = jplan.get_objective(obj)(_jwl(wl), jc, jplan.Controller(c))
            assert np.array_equal(got, want)
            scalar = tsim.scalar_sim_objective(
                tsim.sim_latency.metric if obj == "sim_latency"
                else "energy_pj")(wl, cands, tplan.Controller(c))
            assert np.array_equal(got, scalar)
    custom = tsim.make_sim_objective(
        "peak_bw_bytes_s", tsim.SimParams(bus_bytes_per_cycle=8))
    jcustom = jsim.make_sim_objective(
        "peak_bw_bytes_s", jsim.SimParams(bus_bytes_per_cycle=8))
    assert np.array_equal(custom(wl, cands, tplan.Controller.ACTIVE),
                          jcustom(_jwl(wl), jc, jplan.Controller.ACTIVE))
    tsim.register_sim_strategies()          # idempotent
    assert {"sim_latency", "sim_energy"} <= set(tplan.OBJECTIVES)
    assert {"sim_latency", "sim_energy"} <= set(tplan.PLANNERS)


# -------------------------------------------------------- the network beam
NETPLAN_CALLS = {
    "strategy": dict(strategy="sim_latency"),
    "objective": dict(strategy="exact_opt", objective="sim_latency"),
    "energy": dict(strategy="paper_opt", objective="sim_energy"),
}


@pytest.mark.parametrize("controller", CONTROLLERS)
@pytest.mark.parametrize("call", sorted(NETPLAN_CALLS))
def test_plan_graph_and_fleet_sim_equal_reference(call, controller):
    """The simulator-scored beam: ``plan_graph`` and ``plan_graphs`` over
    three zoo CNNs equal the reference's plans (schedules, residency, words,
    peak bytes, baselines), ``plan_graphs`` equals the sequential calls and
    the frozen loop planner, and the context's sim statistics equal the
    reference's."""
    kw = NETPLAN_CALLS[call]
    tctx, jctx = tplan.PlanContext(), jplan.PlanContext()
    got = [tplan.plan_graph(n, P, controller=controller, context=tctx, **kw)
           for n in ZOO3]
    want = [jplan.plan_graph(n, P, controller=controller, context=jctx, **kw)
            for n in ZOO3]
    assert [_netp(a) for a in got] == [_netp(b) for b in want]
    assert dict(tctx.stats) == dict(jctx.stats)
    assert tctx.stats["sim_batch_calls"] > 0
    tplan.clear_plan_graph_cache()
    fleet = tplan.plan_graphs(list(ZOO3) + ["alexnet"], P,
                              controller=controller, **kw)
    assert [_netp(a) for a in fleet] == [_netp(a) for a in got] + \
        [_netp(got[0])]
    loop = tfleet.plan_graph_loop("resnet18", P, controller=controller, **kw)
    jloop = jfleet.plan_graph_loop("resnet18", P, controller=controller, **kw)
    assert _netp(loop) == _netp(got[1]) == _netp(jloop)
    for a in got:
        assert a.simulate().interconnect_words == a.traffic.interconnect_words


@pytest.mark.parametrize("controller", CONTROLLERS)
@pytest.mark.parametrize("strategy", ("sim_latency", "sim_energy"))
def test_unfused_sim_netplan_is_per_layer_plan(strategy, controller):
    """At ``residency_bytes=0`` the sim NetPlan's schedules are the per-layer
    ``plan(strategy=...)`` schedules, in both packages, and a replan to the
    2 MiB budget is a fresh plan."""
    for net in ("resnet18", "squeezenet"):
        netp = tplan.plan_graph(net, P, "exact_opt", controller,
                                residency_bytes=0, objective=strategy)
        for node in netp.graph.workload_nodes:
            assert netp.schedules[node.name] == tplan.plan(
                node.workload, P, strategy, controller).schedule
        jn = jplan.plan_graph(net, P, "exact_opt", controller,
                              residency_bytes=0, objective=strategy)
        assert _netp(netp) == _netp(jn)
        fresh = tplan.plan_graph(net, P, "exact_opt", controller,
                                 objective=strategy)
        tplan.clear_plan_graph_cache()
        again = netp.replan(residency_bytes=tplan.DEFAULT_RESIDENCY_BYTES)
        assert _netp(again) == _netp(fresh)


def test_plan_graph_objective_errors_and_cache():
    with pytest.raises(terrors.PlanError, match="not a sim objective"):
        tplan.plan_graph("alexnet", P, objective="energy_bytes")
    with pytest.raises(terrors.PlanError, match="not a sim objective"):
        tplan.plan_graphs(["alexnet"], P, objective="sram_accesses")
    words = tplan.plan_graph("alexnet", P, objective="interconnect_words")
    assert _netp(words) == _netp(tplan.plan_graph("alexnet", P))
    custom = tsim.make_sim_objective("energy_pj")
    a = tplan.plan_graph("alexnet", P, objective=custom)
    b = tplan.plan_graph("alexnet", P, objective=tsim.make_sim_objective(
        "energy_pj"))
    assert a is b          # keyed on (type, metric, params), not identity
    assert _netp(a) == _netp(tplan.plan_graph("alexnet", P,
                                              objective="sim_energy"))
    with pytest.raises(terrors.PlanError, match="unknown strategy"):
        tplan.plan_graph("alexnet", P, "sim_wall")


def test_sim_eval_span_is_recorded():
    from repro_torch import obs
    with obs.tracing() as tr:
        tplan.plan_graph("alexnet", P, objective="sim_latency")
    spans = [dict(s.attrs) for s in tr.spans if s.name == "sim.eval_batch"]
    assert spans and all(a["candidates"] > 0 and a["states"] > 0
                         for a in spans)
    assert {a["out_spilled"] for a in spans} == {True, False}


# ----------------------------------------------------------- the timeline
@pytest.mark.parametrize("net", ("alexnet", "squeezenet"))
def test_simreport_timeline_equals_reference(net):
    netp = tplan.plan_graph(net, P, "exact_opt", "active")
    rep = netp.simulate()
    jrep = jplan.plan_graph(net, P, "exact_opt", "active").simulate()
    events = texport.simreport_to_trace(rep)
    assert events == jexport.simreport_to_trace(jrep)
    assert texport.verify_sim_trace(rep, events) == \
        jexport.verify_sim_trace(jrep, events)
    assert texport.RESOURCE_TRACKS == jexport.RESOURCE_TRACKS
    assert texport.BOUND_COLORS == jexport.BOUND_COLORS
    layer = tsim.simulate(netp.graph.workloads[0],
                          netp.schedules[netp.graph.workload_nodes[0].name])
    assert texport.simreport_to_trace(layer) == jexport.simreport_to_trace(
        jsim.simulate(_jwl(netp.graph.workloads[0]), _jsched(
            netp.schedules[netp.graph.workload_nodes[0].name])))
    bad = [dict(e) for e in events]
    next(e for e in bad if e["ph"] == "X")["dur"] += 1.0
    with pytest.raises(ValueError, match="track cycles"):
        texport.verify_sim_trace(rep, bad)


def test_cli_export_writes_a_verified_timeline(tmp_path, capsys):
    out = tmp_path / "trace.json"
    assert obs_main(["export", "--net", "squeezenet", "--controller",
                     "active", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["displayTimeUnit"] == "ms"
    rep = tplan.plan_graph("squeezenet", controller="active").simulate()
    assert doc["traceEvents"] == json.loads(json.dumps(
        texport.simreport_to_trace(rep)))
    assert texport.verify_sim_trace(rep, doc["traceEvents"])
    assert "== report.interconnect_words" in capsys.readouterr().out
