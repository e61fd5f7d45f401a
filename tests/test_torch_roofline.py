"""The port's roofline constants (`repro_torch.roofline.constants`) and the
two objectives that rest on them, `energy_bytes` and `roofline_latency`,
against the live reference (`repro.plan.objectives`).

`energy_bytes` prices bytes from the shared per-access energy table, whose
values the port keeps (relative weights of the paper's SoC), so it equals
the reference's with ``==``. `roofline_latency` prices them at the card's
numbers, the H100's, where the reference prices them at TPU v5e's: with the
reference's module constants set to the port's by ``monkeypatch`` (which
edits no file), the two are equal with ``==``."""

import dataclasses

import numpy as np
import pytest
import torch

from repro import plan as jplan
from repro.plan import objectives as jobjectives
from repro.roofline import constants as jconstants
from repro_torch import plan as tplan
from repro_torch.configs import get_config
from repro_torch.plan import dse as tdse
from repro_torch.plan import objectives as tobjectives
from repro_torch.roofline import constants as tconstants

P = 2048
OBJECTIVES = ("energy_bytes", "roofline_latency")


def _jwl(wl):
    if isinstance(wl, tplan.ConvWorkload):
        return jplan.ConvWorkload(**dataclasses.asdict(wl))
    return jplan.MatmulWorkload(m=wl.m, n=wl.n, k=wl.k, name=wl.name,
                                in_bytes=wl.in_dtype.itemsize,
                                out_bytes=wl.out_dtype.itemsize,
                                acc_bytes=wl.acc_dtype.itemsize)


@pytest.fixture
def h100_reference(monkeypatch):
    """The reference's objectives module priced at the port's machine."""
    monkeypatch.setattr(jobjectives, "PEAK_FLOPS_BF16",
                        tconstants.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jobjectives, "HBM_BW", tconstants.HBM_BW)


def _workloads():
    convs = [w for net in ("alexnet", "mobilenet", "resnet50")
             for w in tplan.conv_workloads(net)]
    gemms = []
    for dtype in (torch.bfloat16, torch.float32):
        for wl in tplan.transformer_matmuls(get_config("qwen2-1.5b"),
                                            seq_len=512):
            gemms.append(dataclasses.replace(wl, in_dtype=dtype,
                                             out_dtype=dtype))
    return convs, gemms


def test_constants_are_the_h100s():
    assert tconstants.PEAK_FLOPS_BF16 == 989e12
    assert tconstants.HBM_BW == 3.35e12
    assert not hasattr(tconstants, "ICI_BW")
    assert not hasattr(tconstants, "DTYPE_BYTES")
    # the energy table keeps the reference's relative weights
    for name in ("SRAM_BYTE", "INTERCONNECT_BYTE", "DRAM_BYTE",
                 "DRAM_ROW_ACT"):
        assert getattr(tconstants, f"PJ_{name}") == \
            getattr(jconstants, f"ENERGY_PJ_{name}")
    assert tconstants.PJ_INTERCONNECT_BYTE == 8 * tconstants.PJ_SRAM_BYTE
    # the card's numbers are not the reference's TPU's
    assert tconstants.PEAK_FLOPS_BF16 != jconstants.PEAK_FLOPS_BF16
    assert tconstants.HBM_BW != jconstants.HBM_BW


@pytest.mark.parametrize("controller", ("passive", "active"))
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_objective_equals_reference_over_grids(objective, controller,
                                               h100_reference):
    """Every conv layer of three zoo CNNs over its exact grid and Qwen2-1.5B's
    GEMMs in bf16 and fp32 over the aligned grid: ``==`` the reference."""
    convs, gemms = _workloads()
    work = [(w, tplan.space.ConvExactSpace()(w, P)) for w in convs]
    work += [(w, tplan.space.AlignedBlockSpace()(w, tplan.SMEM_BUDGET))
             for w in gemms]
    fn_t = tplan.get_objective(objective)
    fn_j = jplan.get_objective(objective)
    for wl, cands in work:
        jc = jplan.space.Candidates(cands.kind, cands.bm, cands.bn, cands.bk)
        got = fn_t(wl, cands, tplan.Controller(controller))
        want = fn_j(_jwl(wl), jc, jplan.Controller(controller))
        assert got.dtype == np.float64 and got.shape == (len(cands),)
        assert np.array_equal(got, want), (wl.name, objective)


def test_roofline_latency_is_the_larger_of_two_times():
    """At the card's numbers: compute time where the layer is compute-bound,
    its bytes over the HBM rate where it is bandwidth-bound."""
    wl = tplan.conv_workloads("vgg16")[5]
    cands = tplan.space.ConvExactSpace()(wl, P)
    got = tobjectives.roofline_latency(wl, cands, tplan.Controller.PASSIVE)
    words = tobjectives.interconnect_words(wl, cands,
                                           tplan.Controller.PASSIVE)
    compute = 2.0 * wl.macs / tconstants.PEAK_FLOPS_BF16
    memory = words * wl.word_bytes / tconstants.HBM_BW
    assert np.array_equal(got, np.maximum(compute, memory))
    assert (got >= compute).all() and (got >= memory).all()


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_objective_drives_search_plan_and_sweep(objective, h100_reference):
    """The objective as a DSE target: ``dse.search``, ``plan_with_strategy``
    and ``dse.sweep``'s cost column equal the reference's."""
    for wl in tplan.conv_workloads("alexnet"):
        got = tdse.search(wl, P, space=tplan.space.ConvExactSpace(),
                          objective=objective, controller="passive").schedule
        want = jplan.dse.search(_jwl(wl), P,
                                space=jplan.space.ConvExactSpace(),
                                objective=objective,
                                controller="passive").schedule
        assert (got.bm, got.bn) == (want.bm, want.bn)
        got = tdse.plan_with_strategy(wl, P, "exact_opt", "active",
                                      objective=objective)
        want = jplan.dse.plan_with_strategy(_jwl(wl), P, "exact_opt",
                                            "active", objective=objective)
        assert (got.bm, got.bn) == (want.bm, want.bn)
    rows_t = tdse.sweep(["alexnet", "squeezenet"], P,
                        ("paper_opt", "exact_opt"), ("passive", "active"),
                        objective=objective)
    rows_j = jplan.dse.sweep(["alexnet", "squeezenet"], P,
                             ("paper_opt", "exact_opt"),
                             ("passive", "active"), objective=objective)
    assert [r["cost"] for r in rows_t] == [r["cost"] for r in rows_j]
    assert {r["objective"] for r in rows_t} == {objective}
