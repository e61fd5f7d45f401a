"""The port's active-memory-controller meter (`repro_torch.core.amc`) and
network planner wrapper (`repro_torch.core.planner`) against the live
reference (`repro.core.amc`, `repro.core.planner`): on the same seeded
inputs every meter field, access event and planner total equals the
reference's with ``==``, and the metered values are within the fp32 conv
tolerance (1e-4) of the reference's numpy ones."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import amc as jamc
from repro.core import planner as jplanner
from repro.core.cnn_zoo import PAPER_CNNS
from repro.core.cnn_zoo import ConvLayer as JLayer
from repro import plan as jplan
from repro.plan.graph import NetworkGraph as JGraph
from repro_torch import plan as tplan
from repro_torch.core import amc as tamc
from repro_torch.core import planner as tplanner
from repro_torch.core.cnn_zoo import ConvLayer as TLayer

TOL = 1e-4
DENSE_CNNS = ("alexnet", "vgg16", "squeezenet", "googlenet", "resnet18",
              "resnet50")


@pytest.fixture(autouse=True)
def _clear_graph_caches():
    tplan.clear_plan_graph_cache()
    jplan.clear_plan_graph_cache()
    yield
    tplan.clear_plan_graph_cache()
    jplan.clear_plan_graph_cache()


def _mk(layer_cls, cin, cout, k, wi, stride=1):
    pad = k // 2
    wo = (wi + 2 * pad - k) // stride + 1
    return layer_cls(name="t", cin=cin, cout=cout, k=k, wi=wi, hi=wi,
                     wo=wo, ho=wo, stride=stride)


# tests/test_amc.py's cases: (cin, cout, k, wi, stride), (m, n)
CASES = [
    ((8, 16, 3, 12, 1), (2, 4)),
    ((6, 10, 1, 9, 1), (3, 5)),
    ((16, 8, 5, 10, 2), (4, 8)),
    ((7, 9, 3, 11, 1), (3, 4)),      # blocks that divide neither count
    ((8, 16, 3, 12, 1), (8, 16)),    # one iteration: no partial sums
]


def _meter(m):
    return (m.interconnect_words, m.sram_reads, m.sram_writes)


@pytest.mark.parametrize("shape,part", CASES)
@pytest.mark.parametrize("active", [False, True])
def test_partitioned_conv_matches_the_reference(shape, part, active):
    tl, jl = _mk(TLayer, *shape), _mk(JLayer, *shape)
    rng = np.random.default_rng(42)
    x = rng.standard_normal((tl.cin, tl.hi, tl.wi)).astype(np.float32)
    w = rng.standard_normal((tl.cout, tl.cin, tl.k, tl.k)).astype(np.float32)
    for act in (False, True):
        t_events, j_events = [], []
        got, tm = tamc.run_partitioned_conv(
            tl, tplan.Partition(*part), x, w, active=active, act=act,
            trace=t_events, device="cpu")
        want, jm = jamc.run_partitioned_conv(
            jl, jplan.Partition(*part), x, w, active=active, act=act,
            trace=j_events)
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
        assert _meter(tm) == _meter(jm)
        assert [dataclasses.astuple(e) for e in t_events] == \
            [dataclasses.astuple(e) for e in j_events]
        assert all(type(v) is int for v in _meter(tm))
    # a Schedule carries the controller; access_trace replays the same stream
    sched = tplan.Schedule.from_partition(tplan.Partition(*part),
                                          "active" if active else "passive")
    jsched = jplan.Schedule.from_partition(jplan.Partition(*part),
                                           "active" if active else "passive")
    assert [dataclasses.astuple(e) for e in tamc.access_trace(
        tl, sched, rng_seed=3, device="cpu")] == \
        [dataclasses.astuple(e) for e in jamc.access_trace(jl, jsched,
                                                           rng_seed=3)]
    assert tamc.analytical_report(tl, sched).as_dict() == \
        jamc.analytical_report(jl, jsched).as_dict()
    assert tamc.analytical_interconnect_words(tl, tplan.Partition(*part),
                                              active) == \
        jamc.analytical_interconnect_words(jl, jplan.Partition(*part), active)


def test_memory_controller_normal_mode():
    mc = tamc.MemoryController((4, 4), active=True, device="cpu")
    vals = torch.ones(2, 4)
    mc.write(slice(0, 2), vals)
    assert torch.equal(mc.read(slice(0, 2)), vals)
    assert mc.meter.interconnect_words == 16
    with pytest.raises(TypeError, match="active= is required"):
        tamc.run_partitioned_conv(_mk(TLayer, 4, 4, 3, 6), tplan.Partition(2, 2),
                                  np.zeros((4, 6, 6), np.float32),
                                  np.zeros((4, 4, 3, 3), np.float32),
                                  device="cpu")


@pytest.mark.parametrize("controller", ["passive", "active"])
def test_validate_schedule_and_sweep_match_the_reference(controller):
    """`validate_schedule` on ResNet-18's layers shrunk to 8 px, and
    `validate_sweep` over a per-layer sweep of AlexNet: the same meters and
    reports, and the same rows validated."""
    for twl, jwl in zip(tplan.conv_workloads("resnet18")[:8],
                        jplan.conv_workloads("resnet18")[:8]):
        tl = dataclasses.replace(twl.to_layer(), wi=8, hi=8, wo=8, ho=8,
                                 stride=1)
        jl = dataclasses.replace(jwl.to_layer(), wi=8, hi=8, wo=8, ho=8,
                                 stride=1)
        tp = tplan.plan(twl, 2048, "exact_opt", controller)
        jp = jplan.plan(jwl, 2048, "exact_opt", controller)
        tm, tr = tamc.validate_schedule(tl, tp.schedule, device="cpu")
        jm, jr = jamc.validate_schedule(jl, jp.schedule)
        assert _meter(tm) == _meter(jm)
        assert tr.as_dict() == jr.as_dict()
    trows = tplan.dse.sweep(["alexnet"], (512, 2048), ("paper_opt",),
                            (controller,), per_layer=True)
    jrows = jplan.dse.sweep(["alexnet"], (512, 2048), ("paper_opt",),
                            (controller,), per_layer=True)
    assert tamc.validate_sweep(trows, device="cpu") == \
        jamc.validate_sweep(jrows) == len(trows)
    with pytest.raises(ValueError, match="per-layer rows"):
        tamc.validate_sweep(tplan.dse.sweep(["alexnet"], 2048), device="cpu")


@pytest.mark.parametrize("net", DENSE_CNNS)
@pytest.mark.parametrize("controller", ["passive", "active"])
def test_validate_network_matches_the_reference(net, controller):
    """`validate_network` at its default shrink(8, 8): the NetPlan, the
    meter and the model's totals equal the reference's, and every metered
    tensor is within 1e-4 of the reference's `run_network` values."""
    tn, tm, tr = tamc.validate_network(net, controller=controller,
                                       device="cpu")
    jn, jm, jr = jamc.validate_network(net, controller=controller)
    assert _meter(tm) == _meter(jm)
    assert tr.as_dict() == jr.as_dict()
    assert {k: (v.bm, v.bn, v.controller.value) for k, v in tn.schedules.items()} \
        == {k: (v.bm, v.bn, v.controller.value) for k, v in jn.schedules.items()}
    assert tn.resident_tensors == jn.resident_tensors
    tg = tplan.NetworkGraph.from_cnn(net).shrink(8, 8)
    jg = JGraph.from_cnn(net).shrink(8, 8)
    active = controller == "active"
    got, gm = tamc.run_network(tg, tn.schedules, tn.resident_tensors,
                               active=active, device="cpu")
    want, wm = jamc.run_network(jg, jn.schedules, jn.resident_tensors,
                                active=active)
    assert _meter(gm) == _meter(wm) == _meter(tm)
    assert got.keys() == want.keys()
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value, rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_drawn_inputs_and_weights_are_the_references_stream():
    """`draw_network` draws what the reference's walk draws, so the runner
    can be handed the meter's inputs and weights."""
    g = tplan.NetworkGraph.from_cnn("resnet18").shrink(8, 8)
    inputs, weights = tamc.draw_network(g, rng_seed=5, device="cpu")
    values, _ = jamc.run_network(JGraph.from_cnn("resnet18").shrink(8, 8),
                                 {n.name: jplan.Schedule(kind="conv", bm=512,
                                                         bn=512)
                                  for n in g.workload_nodes}, rng_seed=5)
    name = g.inputs[0]
    np.testing.assert_array_equal(inputs[name].numpy(), values[name])
    assert set(weights) == {n.name for n in g.workload_nodes}
    assert all(w.dtype == torch.float32 for w in weights.values())


@pytest.mark.parametrize("net", PAPER_CNNS)
def test_plan_network_matches_the_reference(net):
    for residency in (0, 2 << 20):
        got = tplanner.plan_network(net, 2048, "exact_opt",
                                    residency_bytes=residency)
        want = jplanner.plan_network(net, 2048, "exact_opt",
                                     residency_bytes=residency)
        assert [(dataclasses.astuple(lp.layer), lp.schedule.m, lp.schedule.n,
                 lp.in_iters, lp.out_iters, lp.bw_passive, lp.bw_active,
                 lp.saving_pct, dataclasses.astuple(lp.partition))
                for lp in got.layers] == \
            [(dataclasses.astuple(lp.layer), lp.schedule.m, lp.schedule.n,
              lp.in_iters, lp.out_iters, lp.bw_passive, lp.bw_active,
              lp.saving_pct, dataclasses.astuple(lp.partition))
             for lp in want.layers]
        assert (got.total_passive, got.total_active, got.saving_pct,
                got.total_fused) == (want.total_passive, want.total_active,
                                     want.saving_pct, want.total_fused)
        assert [dataclasses.astuple(e) for e in got.edges] == \
            [dataclasses.astuple(e) for e in want.edges]
        assert (got.fused is None) == (want.fused is None) == (residency == 0)
        assert got.report() == want.report()


def test_cuda_without_a_gpu_raises():
    """Asking for the card where there is none raises; nothing falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    layer = _mk(TLayer, 8, 16, 3, 12)
    g = tplan.NetworkGraph.from_cnn("resnet18").shrink(8, 8)
    sched = {n.name: tplan.Schedule(kind="conv", bm=8, bn=8)
             for n in g.workload_nodes}
    for call in (
            lambda: tamc.run_partitioned_conv(
                layer, tplan.Partition(2, 4),
                np.zeros((8, 12, 12), np.float32),
                np.zeros((16, 8, 3, 3), np.float32), active=True),
            lambda: tamc.validate_schedule(layer, tplan.Schedule(
                kind="conv", bm=2, bn=4)),
            lambda: tamc.run_network(g, sched),
            lambda: tamc.draw_network(g),
            lambda: tamc.validate_network("alexnet"),
            lambda: tamc.MemoryController((2, 2), True, device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
