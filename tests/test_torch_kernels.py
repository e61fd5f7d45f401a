"""The port's kernels on CPU tensors (their plain PyTorch versions) against
the reference package's Pallas kernels in interpret mode, on the same numpy
inputs. Tolerances are the reference's own (tests/test_kernels.py): fp32
1e-3 for matmul and 1e-4 for conv, bf16 2e-2 and 5e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import conv2d_psum as jconv
from repro.kernels import ops as jops
from repro.kernels import psum_matmul as jmm
from repro.kernels import ref as jref
from repro_torch.kernels import conv2d_psum as tconv
from repro_torch.kernels import launch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import psum_matmul as tmm
from repro_torch.kernels import ref as tref

jax.config.update("jax_enable_x64", False)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
MM_TOL = {"float32": 1e-3, "bfloat16": 2e-2}
CONV_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _pair(rng, shape, dtype):
    """The same numbers as a jax array and a torch tensor of one dtype."""
    a = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, dtype=jd), torch.from_numpy(a).to(td)


def _close(got, want, tol):
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("act", ["none", "relu", "silu", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("controller", ["active", "passive"])
def test_psum_matmul_plain_matches_jax(controller, dtype, act):
    rng = np.random.default_rng(len(act) * 10 + len(dtype))
    jx, tx = _pair(rng, (50, 160), dtype)       # pads M, K and N
    jw, tw = _pair(rng, (160, 150), dtype)
    want = jmm.psum_matmul(jx, jw, bm=32, bn=64, bk=64, act=act,
                           controller=controller)
    got = tmm.psum_matmul(tx, tw, bm=32, bn=64, bk=64, act=act,
                          controller=controller)
    assert got.dtype == tx.dtype
    _close(got, want, MM_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kk", [1, 3, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_psum_plain_matches_jax(stride, kk, dtype):
    """Odd channel blocks (m=13, n=17) force the zero-channel padding:
    30 input channels become 39, 40 output channels become 51."""
    rng = np.random.default_rng(stride * 10 + kk)
    hp = 9 + 2 * (kk // 2)
    jx, tx = _pair(rng, (30, hp, hp), dtype)
    jw, tw = _pair(rng, (40, 30, kk, kk), dtype)
    act = "silu" if kk == 3 else "none"
    want = jconv.conv2d_psum(jx, jw, block_m=13, block_n=17, stride=stride, act=act)
    got = tconv.conv2d_psum(tx, tw, block_m=13, block_n=17, stride=stride, act=act)
    assert got.dtype == tx.dtype
    _close(got, want, CONV_TOL[dtype])


@pytest.mark.parametrize("controller", ["active", "passive"])
def test_ops_matmul_matches_jax(controller):
    """Planner-chosen blocks at one H100 block's shared memory, clamped to
    the problem as in the reference (bm 56, bn 128, bk 128 here)."""
    rng = np.random.default_rng(7)
    jx, tx = _pair(rng, (50, 160), "float32")
    jw, tw = _pair(rng, (160, 150), "float32")
    want = jops.matmul(jx, jw, act="gelu", controller=controller,
                       vmem_budget=232_448)
    got = tops.matmul(tx, tw, act="gelu", controller=controller,
                      vmem_budget=232_448)
    _close(got, want, MM_TOL["float32"])


@pytest.mark.parametrize("strategy", ["paper_opt", "exact_opt"])
@pytest.mark.parametrize("stride", [1, 2])
def test_ops_conv2d_matches_jax(stride, strategy):
    rng = np.random.default_rng(stride)
    jx, tx = _pair(rng, (24, 10, 10), "float32")
    jw, tw = _pair(rng, (20, 24, 3, 3), "float32")
    want = jops.conv2d(jx, jw, stride=stride, p_macs=512, strategy=strategy,
                       act="relu")
    got = tops.conv2d(tx, tw, stride=stride, p_macs=512, strategy=strategy,
                      act="relu")
    _close(got, want, CONV_TOL["float32"])


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 5), (False, 0)])
def test_refs_match_jax(causal, q_offset):
    rng = np.random.default_rng(3)
    jx, tx = _pair(rng, (12, 20), "float32")
    jw, tw = _pair(rng, (20, 9), "float32")
    _close(tref.matmul_ref(tx, tw, act="gelu"), jref.matmul_ref(jx, jw, act="gelu"), 1e-5)
    jc, tc = _pair(rng, (4, 11, 11), "float32")
    jk, tk = _pair(rng, (6, 4, 3, 3), "float32")
    _close(tref.conv2d_ref(tc, tk, 2, "silu"), jref.conv2d_ref(jc, jk, 2, "silu"), 1e-5)
    jq, tq = _pair(rng, (2, 3, 8), "float32")
    jkk, tkk = _pair(rng, (2, 9, 8), "float32")
    jv, tv = _pair(rng, (2, 9, 8), "float32")
    _close(tref.attention_ref(tq, tkk, tv, causal, q_offset),
           jref.attention_ref(jq, jkk, jv, causal, q_offset), 1e-5)


@pytest.mark.parametrize("controller", ["active", "passive"])
def test_matmul_launch_plan_matches_reference_geometry(controller):
    kw = dict(m=50, k=160, n=150, bm=32, bn=64, bk=64, controller=controller)
    got, want = tmm.matmul_launch_plan(**kw), jmm.matmul_launch_plan(**kw)
    assert [o.array_shape for o in got.inputs + got.outputs] \
        == [o.array_shape for o in want.inputs + want.outputs]
    gk = want.grid[2] if controller == "active" else want.grid[0]
    # float32 takes tc_3xtf32: its pack pass, then one launch per k-step
    # (passive) or one whose k loop runs in the block over chunks of TF_KC
    assert got.body == "tc_3xtf32"
    assert got.launches == 1 + (gk if controller == "passive" else 1)
    kc = 64 if controller == "passive" else 64 * gk
    assert got.loops == (("k", -(-kc // tmm.TF_KC)),)
    assert got.grid == (3, 2)


@pytest.mark.parametrize("kk,stride", [(1, 1), (3, 1), (3, 2), (7, 2)])
def test_conv_launch_plan_matches_reference_geometry(kk, stride):
    kw = dict(cin=30, hp=9 + 2 * (kk // 2), wp=9 + 2 * (kk // 2), cout=40,
              kk=kk, stride=stride, block_m=13, block_n=17)
    got, want = tconv.conv_launch_plan(**kw), jconv.conv_launch_plan(**kw)
    assert [o.array_shape for o in got.inputs + got.outputs] \
        == [o.array_shape for o in want.inputs + want.outputs]
    # cout blocks (each over n_split thread blocks along N where the kernel
    # splits one), and the cin blocks walked inside the block
    assert got.grid[1] == want.grid[0] * got.cuda.keywords["geo"]["n_split"]
    assert got.loops[0] == ("cin", want.grid[1])


def test_conv_tile_geometry_fits_the_card():
    """Every ResNet-18 layer at 56 px under its exact_opt schedule gets a
    launch a body accepts, in both dtypes: the thread blocks along N cover
    its n channels, a block is 64 to 256 threads in whole warps within the
    card's shared memory, and the spatial tiles cover the map."""
    from repro_torch import plan
    g = plan.NetworkGraph.from_cnn("resnet18").shrink(56, 1)
    for p in plan.plan_many(g.workloads, 2048, "exact_opt", "active"):
        wl, pad = p.workload, p.workload.k // 2
        kw = dict(hp=56 + 2 * pad, wp=56 + 2 * pad, ho=56, wo=56, kk=wl.k,
                  stride=1, bm=p.schedule.m, bn=p.schedule.n)
        for dtype in (torch.float32, torch.bfloat16):
            lp = tconv.conv_launch_plan(cin=wl.cin, hp=56 + 2 * pad,
                                        wp=56 + 2 * pad, cout=wl.cout,
                                        kk=wl.k, block_m=p.schedule.m,
                                        block_n=p.schedule.n, dtype=dtype)
            n_co = lp.outputs[0].array_shape[0] // p.schedule.n
            body, geo = tconv.conv_body(**kw, n_co=n_co, dtype=dtype)
            assert body == lp.body
            assert 64 <= lp.threads <= 256 and lp.threads % 32 == 0
            assert lp.smem_bytes <= tconv.SMEM_LIMIT
            assert lp.grid == (geo["n_tiles"], geo["n_cos"])
            assert geo["rows_in"] <= 56 + 2 * pad
            if body == "tc_bf16":
                # cpb whole cout blocks per thread block (none is split at
                # ResNet-18's widths), each of nb >= n rows
                assert geo["n_split"] == 1 and geo["nb"] >= p.schedule.n
                assert geo["cpb"] * geo["nb"] <= geo["nw"]
                assert geo["n_cos"] * geo["cpb"] >= n_co
                assert 1 <= geo["gcs"] <= geo["kg"] == -(-p.schedule.m // tconv.TC_KG)
                assert geo["n_tiles"] * tconv.TC_ROWS_M >= 56 * 56
            else:
                assert geo["n_split"] * geo["gpb"] * tconv.CORE_NC >= p.schedule.n
                assert 1 <= geo["mc"] <= p.schedule.m
                assert geo["n_tiles"] * geo["ti"] >= 56 * geo["cols"]


def test_off_device_operands_are_rejected_not_run():
    """Only CUDA tensors reach a kernel and only CPU tensors the plain
    version; any other device raises instead of being run somewhere."""
    lp = tmm.matmul_launch_plan(m=8, k=8, n=8, bm=8, bn=8, bk=8)
    x = torch.empty(8, 8, device="meta")
    with pytest.raises(ValueError, match="one CUDA device or all on the CPU"):
        launch.run(lp, x, x)
    with pytest.raises(ValueError, match="shaped"):
        launch.run(lp, torch.zeros(8, 9), torch.zeros(8, 8))
    with pytest.raises(ValueError, match="unknown activation"):
        tmm.matmul_launch_plan(m=8, k=8, n=8, bm=8, bn=8, bk=8, act="tanh")


def test_cuda_wrapper_checks_before_launching():
    """The CUDA wrappers refuse what the kernels do not take before any
    library is loaded: blocks beyond the 128 x 128 register tile, mixed or
    unsupported dtypes."""
    x = torch.zeros(256, 128)
    with pytest.raises(ValueError, match="register tile"):
        tmm._matmul_cuda(x, torch.zeros(128, 256), name="t", bm=256, bn=128,
                         bk=128, controller="active", act="none")
    with pytest.raises(ValueError, match="operands of one type"):
        tmm._matmul_cuda(x.half(), torch.zeros(128, 256).half(), name="t",
                         bm=128, bn=128, bk=128, controller="active", act="none")
    with pytest.raises(ValueError, match="must be contiguous"):
        tmm._matmul_cuda(x, torch.zeros(256, 128).t(), name="t",
                         bm=128, bn=128, bk=128, controller="active", act="none")
    with pytest.raises(ValueError, match="operands of one type"):
        tconv._conv_cuda(torch.zeros(4, 5, 5), torch.zeros(4, 4, 3, 3).double(),
                         kk=3, stride=1, bm=4, bn=4, act="none", geo={})
