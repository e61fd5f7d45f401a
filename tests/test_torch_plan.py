"""The port's planner (`repro_torch.plan`) against the live reference
(`repro.plan`): the same schedules and the same word counts, exactly."""

import dataclasses

import pytest
import torch

from repro import plan as jplan
from repro.core.cnn_zoo import PAPER_CNNS
from repro.plan import gemm_model as jgemm
from repro.plan.graph import NetworkGraph as JGraph
from repro_torch import plan as tplan
from repro_torch.core import cnn_zoo as tzoo
from repro_torch.plan import gemm_model as tgemm

CONV_STRATEGIES = ("max_input", "max_output", "equal", "paper_opt", "exact_opt")
BUDGETS = (512, 2048, 16384)
H100_SMEM = 232_448
TPU_BUDGET = 96 * 1024 * 1024


def _sched(s):
    return (s.kind, s.bm, s.bn, s.bk, s.controller.value)


def _words(report):
    """The reference report without its byte count (the port keeps words)."""
    return {k: v for k, v in report.as_dict().items() if k != "bytes"}


@pytest.mark.parametrize("controller", ["active", "passive"])
@pytest.mark.parametrize("strategy", CONV_STRATEGIES)
@pytest.mark.parametrize("cnn", PAPER_CNNS)
def test_conv_schedules_and_words_match(cnn, strategy, controller):
    for budget in BUDGETS:
        want = jplan.plan_many(cnn, budget, strategy, controller)
        got = tplan.plan_many(cnn, budget, strategy, controller)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert dataclasses.asdict(g.workload) == dataclasses.asdict(w.workload)
            assert _sched(g.schedule) == _sched(w.schedule), (budget, w.workload.name)
            assert g.traffic.as_dict() == _words(w.traffic)
            assert g.budget == w.budget


@pytest.mark.parametrize("strategy", CONV_STRATEGIES)
def test_single_layer_plan_matches(strategy):
    """``plan()`` per layer (the reference runs its DSE search here, not
    the batched argmin) and the paper's real-valued iteration convention."""
    for cnn in ("resnet18", "squeezenet", "mobilenet"):
        for wl in tplan.conv_workloads(cnn):
            jwl = jplan.ConvWorkload(**dataclasses.asdict(wl))
            for budget, exact in ((2048, True), (512, False)):
                g = tplan.plan(wl, budget, strategy, "passive", exact_iters=exact)
                w = jplan.plan(jwl, budget, strategy, "passive", exact_iters=exact)
                assert _sched(g.schedule) == _sched(w.schedule)
                assert g.traffic.as_dict() == _words(w.traffic)


def test_zoo_layers_are_the_reference_layers():
    from repro.core import cnn_zoo as jzoo
    for name in jzoo._BUILDERS:
        assert ([dataclasses.asdict(l) for l in tzoo.get_cnn(name)]
                == [dataclasses.asdict(l) for l in jzoo.get_cnn(name)])
    with pytest.raises(KeyError):
        tzoo.get_cnn("lenet")


def _graph_view(g):
    nodes = [(n.name, n.op, n.ins, n.out,
              None if n.workload is None else dataclasses.asdict(n.workload))
             for n in g.nodes]
    tensors = {k: dataclasses.asdict(t) for k, t in g.tensors.items()}
    return (g.name, nodes, tensors, g.inputs, g.outputs, g.producer,
            g.consumers, [t.words for t in g.tensors.values()])


@pytest.mark.parametrize("cnn", PAPER_CNNS)
def test_graph_from_cnn_and_shrink_match(cnn):
    jg, tg = JGraph.from_cnn(cnn), tplan.NetworkGraph.from_cnn(cnn)
    assert _graph_view(tg) == _graph_view(jg)
    for spatial, div in ((8, 1), (8, 16), (56, 1)):
        assert _graph_view(tg.shrink(spatial, div)) == _graph_view(jg.shrink(spatial, div))


def test_graph_rejects_what_the_reference_rejects():
    g = tplan.NetworkGraph.from_cnn("resnet18")
    nodes = list(g.nodes)
    with pytest.raises(ValueError, match="duplicate node name"):
        tplan.NetworkGraph("dup", tuple(nodes + [nodes[1]]), g.tensors)
    with pytest.raises(ValueError, match="not topological"):
        tplan.NetworkGraph("order", (nodes[1], nodes[0]) + tuple(nodes[2:]), g.tensors)


GEMMS = [(4096, 8960, 1536), (4096, 1536, 8960), (100, 130, 70), (8, 512, 256),
         (2048, 2048, 2048), (512, 8, 8)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("budget", [H100_SMEM, TPU_BUDGET])
@pytest.mark.parametrize("controller", ["active", "passive"])
def test_gemm_exhaustive_blocks_match(controller, budget, dtype):
    for m, n, k in GEMMS:
        twl = tplan.MatmulWorkload(m=m, n=n, k=k, in_dtype=dtype)
        jwl = jplan.MatmulWorkload(m=m, n=n, k=k, in_bytes=dtype.itemsize)
        for max_block in (512, 4096):
            for strategy in ("exhaustive_vmem", "exact_opt"):
                got = tgemm.plan_gemm(twl, budget, tplan.Strategy(strategy),
                                      tplan.Controller(controller), max_block)
                want = jgemm.plan_gemm(jwl, budget, jplan.Strategy(strategy),
                                       jplan.Controller(controller), max_block)
                assert _sched(got) == _sched(want), (m, n, k, max_block)
                assert (tgemm.matmul_traffic(m, n, k, got, controller)
                        == jgemm.matmul_traffic(m, n, k, want, controller))
        g = tplan.plan(twl, budget, "exhaustive_vmem", controller)
        w = jplan.plan(jwl, budget, "exhaustive_vmem", controller)
        assert _sched(g.schedule) == _sched(w.schedule)
        assert g.traffic.as_dict() == _words(w.traffic)


def test_gemm_blocks_on_the_card():
    """At one H100 block's shared memory the Qwen2-1.5B FFN up-projection
    gets 128^3 blocks, and a budget below the smallest tile falls back to
    it, as in the reference."""
    wl = tplan.MatmulWorkload(m=4096, n=8960, k=1536)
    assert _sched(tplan.plan(wl, None, "exhaustive_vmem", "active").schedule) \
        == ("matmul", 128, 128, 128, "active")
    tiny = tgemm.plan_gemm(wl, 1000, tplan.Strategy.EXHAUSTIVE_VMEM,
                           tplan.Controller.PASSIVE)
    want = jgemm.plan_gemm(jplan.MatmulWorkload(m=4096, n=8960, k=1536), 1000,
                           jplan.Strategy.EXHAUSTIVE_VMEM, jplan.Controller.PASSIVE)
    assert _sched(tiny) == _sched(want)
    # the first-order rule plans GEMMs too (it raised before the DSE port)
    assert _sched(tplan.plan(wl, None, "paper_opt", "active").schedule) \
        == ("matmul", 128, 128, 128, "active")


def test_schedule_and_enum_validation():
    with pytest.raises(ValueError):
        tplan.Schedule(kind="matmul", bm=128, bn=128, bk=0)
    with pytest.raises(ValueError):
        tplan.Schedule(kind="fft", bm=1, bn=1)
    with pytest.raises(ValueError):
        tplan.Strategy.coerce("greedy")
    with pytest.raises(ValueError):
        tplan.Controller.coerce("lazy")
    s = tplan.Schedule(kind="conv", bm=13, bn=17)
    assert (s.m, s.n) == (13, 17)
