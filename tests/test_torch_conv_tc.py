"""`conv2d_psum`'s two Hopper bodies, from the CPU: which body each launch
takes, that every geometry fits the card (including output blocks wider
than one thread block), that a plan no body takes is refused before the
first launch, that the CUDA wrapper checks before it loads a library, and
the plain version against the reference package's Pallas kernel (interpret
mode) at a block of more than 1024 output channels. Tolerances are the
reference's own (tests/test_kernels.py): fp32 1e-4, bf16 5e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import conv2d_psum as jconv
from repro_torch import plan as tplan
from repro_torch.core import cnn_zoo
from repro_torch.kernels import _build, conv_network as tnet
from repro_torch.kernels import conv2d_psum as tconv
from repro_torch.kernels import launch

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
STRATEGIES = ("max_input", "max_output", "equal", "paper_opt", "exact_opt")
P_MACS = (512, 1024, 2048, 4096, 8192, 16384)


def _resnet18_plans():
    g = tplan.NetworkGraph.from_cnn("resnet18").shrink(56, 1)
    return tplan.plan_many(g.workloads, 2048, "exact_opt", "active")


def _launch_plan(p, dtype):
    wl, pad = p.workload, p.workload.k // 2
    return tconv.conv_launch_plan(cin=wl.cin, hp=wl.hi + 2 * pad,
                                  wp=wl.wi + 2 * pad, cout=wl.cout, kk=wl.k,
                                  stride=wl.stride, block_m=p.schedule.m,
                                  block_n=p.schedule.n, dtype=dtype)


def _check_fits(lp, p):
    """The launch fits an H100 block and covers the layer: whole warps, no
    32-thread blocks, shared memory within the card's limit, the spatial
    tiles over every output position and the thread blocks along N over
    every channel of the cout block, without splitting the cin walk."""
    wl = p.workload
    bn = max(1, min(p.schedule.n, wl.cout))
    n_co = lp.outputs[0].array_shape[0] // bn
    assert lp.threads % 32 == 0 and 64 <= lp.threads <= 256
    assert lp.smem_bytes <= tconv.SMEM_LIMIT
    assert lp.grid[1] <= 65535
    acc = next(s for s in lp.scratch if s.name == "acc")
    assert acc.where == "registers"
    if lp.body == "tc_bf16":
        # rows of N per thread block x thread blocks along N cover every
        # channel of every cout block
        assert acc.shape[1] in tconv.TC_WIDTHS
        assert lp.grid[1] * acc.shape[1] >= n_co * bn
        assert acc.shape[0] * lp.grid[0] >= wl.ho * wl.wo
    else:
        assert lp.grid[1] % n_co == 0
        assert lp.grid[1] // n_co * acc.shape[0] >= bn
        assert acc.shape[1] * lp.grid[0] >= wl.ho * -(-wl.wo // tconv.CORE_R) * tconv.CORE_R
    # the schedule's cin blocks are walked inside the block, in order
    assert lp.loops[0] == ("cin", lp.inputs[0].array_shape[0] //
                           max(1, min(p.schedule.m, wl.cin)))


@pytest.mark.parametrize("dtype,body", [(torch.float32, "cuda_core"),
                                        (torch.bfloat16, "tc_bf16")])
@pytest.mark.parametrize("layer", range(20))
def test_body_and_geometry_at_every_resnet18_layer(layer, dtype, body):
    """Every ResNet-18 layer (56 px, exact_opt at P = 2048) takes tc_bf16 in
    bf16 and cuda_core in fp32, at a geometry that fits the card."""
    p = _resnet18_plans()[layer]
    lp = _launch_plan(p, dtype)
    assert lp.body == body
    _check_fits(lp, p)


def test_the_512_layer_fills_the_card():
    """The widest layer puts a thread block of 128 threads or more on every
    SM in tc_bf16, holding all eight of a thread block's cout blocks of 16
    (wgmma n128), and two on every SM in cuda_core."""
    p = next(p for p in _resnet18_plans()
             if p.workload.cin == p.workload.cout == 512 and p.workload.k == 3)
    for dtype, least in ((torch.float32, tconv.MIN_BLOCKS),
                         (torch.bfloat16, tconv.TC_MIN_BLOCKS)):
        lp = _launch_plan(p, dtype)
        assert lp.grid[0] * lp.grid[1] >= least
        assert lp.threads >= 128
    geo = _launch_plan(p, torch.bfloat16).cuda.keywords["geo"]
    assert (geo["cpb"], geo["nw"]) == (8, 128)


@pytest.mark.parametrize("cnn", cnn_zoo.PAPER_CNNS)
def test_c1_probe_set_gets_a_geometry_the_card_takes(cnn):
    """The eight zoo CNNs at shrink(56, 1) and shrink(8, 1), P 512-16384,
    five strategies and both controllers: every conv gets a body whose
    geometry fits, in both dtypes, including the output blocks of more than
    1024 channels that max_output gives the 1x1 layers."""
    wide = 0
    for size in (56, 8):
        g = tplan.NetworkGraph.from_cnn(cnn).shrink(size, 1)
        for p_macs in P_MACS:
            for strategy in STRATEGIES:
                for controller in ("active", "passive"):
                    for p in tplan.plan_many(g.workloads, p_macs, strategy,
                                             controller):
                        wide += p.schedule.n > 1024
                        for dtype in (torch.float32, torch.bfloat16):
                            _check_fits(_launch_plan(p, dtype), p)
    assert (wide > 0) == (cnn in ("resnet50", "mobilenet", "mnasnet"))


@pytest.mark.parametrize("n", [1152, 1280, 2048])
def test_wide_blocks_split_along_n(n):
    """A 1x1 block of n > 1024 channels goes to several thread blocks along
    N, each with a share the kernel holds in registers."""
    for dtype, share in ((torch.float32, tconv.CORE_THREADS // 32 * tconv.CORE_NC),
                         (torch.bfloat16, tconv.TC_WIDTHS[-1])):
        lp = tconv.conv_launch_plan(cin=64, hp=7, wp=7, cout=n, kk=1,
                                    block_m=64, block_n=n, dtype=dtype)
        assert lp.grid[1] >= -(-n // share) > 1
        assert lp.threads <= 256


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_at_a_block_wider_than_1024(dtype):
    """conv_plain against the reference's Pallas kernel (interpret mode) at
    a 1280-channel output block, small spatial size."""
    rng = np.random.default_rng(11)
    jd, td = DTYPES[dtype]
    x = rng.standard_normal((24, 4, 4)).astype(np.float32)
    w = (rng.standard_normal((1280, 24, 1, 1)) / np.sqrt(24)).astype(np.float32)
    want = jconv.conv2d_psum(jnp.asarray(x, jd), jnp.asarray(w, jd),
                             block_m=24, block_n=1280, act="relu")
    got = tconv.conv2d_psum(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                            block_m=24, block_n=1280, act="relu")
    assert got.dtype == td and got.shape == (1280, 4, 4)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_bf16_takes_cuda_core_where_the_tc_slab_does_not_fit():
    """The one rule that sends bf16 to cuda_core: tc_bf16's two stages of
    slab and weights exceed TC_SMEM (a 7x7 kernel over 594 columns)."""
    kw = dict(cin=8, hp=600, wp=600, cout=16, kk=7, block_m=8, block_n=16)
    assert tconv.tc_geometry(hp=600, wp=600, ho=594, wo=594, kk=7,
                             stride=1, bm=8, bn=16, n_co=1) is None
    assert tconv.conv_launch_plan(**kw, dtype=torch.bfloat16).body == "cuda_core"
    assert tconv.conv_launch_plan(**kw, dtype=torch.float32).body == "cuda_core"


def test_a_plan_no_body_takes_raises():
    kw = dict(cin=8, hp=4006, wp=4006, cout=16, kk=7, block_m=8, block_n=16)
    assert "shared memory" in tconv.conv_refusal(**kw)
    with pytest.raises(ValueError, match="no kernel body"):
        tconv.conv_launch_plan(**kw)
    assert tconv.conv_refusal(cin=8, hp=10, wp=10, cout=16, kk=3) is None


def test_check_network_refuses_before_the_first_launch(monkeypatch):
    """A graph whose maps no body can stage is rejected by check_network,
    before run_network_kernels launches anything."""
    launched = []
    monkeypatch.setattr(tnet, "conv2d_psum", lambda *a, **k: launched.append(1))
    g = tplan.NetworkGraph.from_cnn("resnet18").shrink(4000, 1)
    sched = {n.name: p.schedule for n, p in
             zip(g.workload_nodes, tplan.plan_many(g.workloads, 2048,
                                                   "exact_opt", "active"))}
    params = {n.name: torch.zeros(n.workload.cout, n.workload.cin,
                                  n.workload.k, n.workload.k)
              for n in g.workload_nodes}
    with pytest.raises(ValueError, match="resnet18.conv1: no kernel body"):
        tnet.run_network_kernels(g, sched, params, device="cpu")
    assert launched == []


def test_cuda_wrapper_checks_before_loading_a_library(monkeypatch):
    """The CUDA callable refuses operands of another dtype than its plan's,
    and a tc_bf16 launch of anything but bfloat16, before any library is
    loaded or any launch counted."""
    def no_build(name):
        raise AssertionError(f"library {name} loaded")
    monkeypatch.setattr(_build, "load", no_build)
    launch.reset_launches()
    lp = tconv.conv_launch_plan(cin=16, hp=10, wp=10, cout=16, kk=3,
                                block_m=16, block_n=16, dtype=torch.bfloat16)
    assert lp.body == "tc_bf16"
    x = torch.zeros(lp.inputs[0].array_shape)
    w = torch.zeros(lp.inputs[1].array_shape)
    with pytest.raises(ValueError, match="chose its body for torch.bfloat16"):
        lp.cuda(x, w)
    with pytest.raises(ValueError, match="operands of one type"):
        lp.cuda(x.half(), w.half())
    with pytest.raises(ValueError, match="tc_bf16 takes bfloat16"):
        tconv._conv_cuda(x, w, kk=3, stride=1, bm=16, bn=16, act="none",
                         body="tc_bf16", geo={}, dtype=None)
    with pytest.raises(ValueError, match="unknown body"):
        tconv._conv_cuda(x, w, kk=3, stride=1, bm=16, bn=16, act="none",
                         body="mxu", geo={}, dtype=None)
    assert launch.LAUNCHES == {}


def test_plan_lists_the_packed_operands_as_device_scratch():
    for dtype, shapes in ((torch.float32, [(39, 11, 16), (6, 39, 9, 16)]),
                          (torch.bfloat16, [(48, 11, 11), (3, 48, 9, 24)])):
        lp = tconv.conv_launch_plan(cin=30, hp=11, wp=11, cout=40, kk=3,
                                    block_m=13, block_n=17, dtype=dtype)
        device = [s for s in lp.scratch if s.where == "device"]
        assert [s.shape for s in device] == shapes
