"""The psum_matmul plan's choice of kernel body, the tc_bf16 body's checks
before launch, and the plain version at shapes that body takes, against the
reference package's Pallas kernel in interpret mode on the same numpy inputs
(bf16 tolerance 2e-2, the reference's own, tests/test_kernels.py). The
tc_bf16 kernel itself runs only on the card (chip_smoke.py)."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import psum_matmul as jmm
from repro_torch import plan
from repro_torch.kernels import _build, ops
from repro_torch.kernels import psum_matmul as tmm

MAIN = dict(m=4096, k=1536, n=8960, bm=128, bn=128, bk=128)   # Qwen2-1.5B FFN


@pytest.mark.parametrize("controller", ["active", "passive"])
def test_main_path_plans_pick_their_body(controller):
    sched = ops.matmul_schedule(MAIN["m"], MAIN["k"], MAIN["n"],
                                controller=controller)
    assert (sched.bm, sched.bn, sched.bk) == (128, 128, 128)
    bf = tmm.matmul_launch_plan(**MAIN, controller=controller,
                                dtype=torch.bfloat16)
    assert bf.body == "tc_bf16"
    assert bf.grid == (70, 32)
    assert bf.threads == 288                   # two warpgroups + producer warp
    assert bf.smem_bytes == tmm.tc_smem_bytes(128, 128) <= plan.SMEM_BUDGET
    assert bf.launches == (12 if controller == "passive" else 1)
    f32 = tmm.matmul_launch_plan(**MAIN, controller=controller,
                                 dtype=torch.float32)
    assert f32.body == "tc_3xtf32"
    assert (f32.grid, f32.threads) == ((70, 32), 288)
    assert f32.smem_bytes == tmm.tf_smem_bytes(128, 128) <= plan.SMEM_BUDGET
    assert f32.launches == bf.launches + 1     # and the pack pass
    assert tmm.matmul_launch_plan(**MAIN, controller=controller).body == "tc_3xtf32"


@pytest.mark.parametrize("blocks,body", [
    (dict(bm=64, bn=64, bk=64), "tc_bf16"),
    (dict(bm=8, bn=8, bk=8), "tc_bf16"),
    (dict(bm=256, bn=128, bk=128), "cuda_core"),   # beyond the register tile
    (dict(bm=128, bn=256, bk=128), "cuda_core"),
    (dict(bm=64, bn=13, bk=64), "cuda_core"),      # W's blocks off 16 bytes
    (dict(bm=64, bn=64, bk=36), "cuda_core"),      # X's k-steps off 16 bytes
])
def test_bf16_plans_outside_the_constraints_take_cuda_core(blocks, body):
    lp = tmm.matmul_launch_plan(m=200, k=288, n=312, **blocks,
                                dtype=torch.bfloat16)
    assert lp.body == body
    if body == "tc_bf16":
        assert lp.threads == (160 if blocks["bm"] <= 64 else 288)
        assert 0 < lp.smem_bytes <= plan.SMEM_BUDGET
    else:
        assert (lp.threads, lp.smem_bytes) == (tmm.THREADS, 0)


@pytest.mark.parametrize("controller", ["active", "passive"])
@pytest.mark.parametrize("shape", [
    dict(m=200, k=320, n=300, bm=128, bn=128, bk=128),
    dict(m=200, k=320, n=300, bm=64, bn=128, bk=64),
    dict(m=50, k=160, n=150, bm=32, bn=64, bk=64),
])
def test_tc_plan_geometry_matches_reference(controller, shape):
    got = tmm.matmul_launch_plan(**shape, controller=controller,
                                 dtype=torch.bfloat16)
    want = jmm.matmul_launch_plan(**shape, controller=controller,
                                  dtype=jnp.bfloat16)
    assert got.body == "tc_bf16"
    assert [o.array_shape for o in got.inputs + got.outputs] \
        == [o.array_shape for o in want.inputs + want.outputs]
    # the reference's grid: active (gm, gn, gk), passive (gk, gm, gn)
    gm, gn, gk = want.grid if controller == "active" else want.grid[1:] + want.grid[:1]
    assert got.launches == (gk if controller == "passive" else 1)
    assert got.grid == (gn, gm)


def _no_library(name):
    raise AssertionError(f"library {name} loaded before the checks")


def test_tc_wrapper_checks_before_loading_any_library(monkeypatch):
    """`_matmul_cuda` refuses what tc_bf16 cannot take before it loads a
    library, so this runs without nvcc."""
    monkeypatch.setattr(_build, "load", _no_library)
    kw = dict(name="t", bm=128, bn=128, bk=128, controller="active",
              act="none", body="tc_bf16")
    w = torch.zeros(128, 256, dtype=torch.bfloat16)
    buf = torch.zeros(256 * 128 + 1, dtype=torch.bfloat16)
    shifted = buf[1:].view(256, 128)                    # 2 bytes off
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundaries"):
        tmm._matmul_cuda(shifted, w, **kw)
    with pytest.raises(ValueError, match="multiples of 8"):
        tmm._matmul_cuda(torch.zeros(256, 132, dtype=torch.bfloat16),
                         torch.zeros(132, 256, dtype=torch.bfloat16),
                         **{**kw, "bk": 132})
    with pytest.raises(ValueError, match="takes bfloat16"):
        tmm._matmul_cuda(torch.zeros(256, 128), torch.zeros(128, 256), **kw)
    with pytest.raises(ValueError, match="chose its body for"):
        tmm._matmul_cuda(torch.zeros(256, 128), torch.zeros(128, 256),
                         **kw, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unknown body"):
        tmm._matmul_cuda(torch.zeros(256, 128, dtype=torch.bfloat16), w,
                         **{**kw, "body": "tensor_cores"})


@pytest.mark.parametrize("act", ["none", "gelu"])
@pytest.mark.parametrize("controller", ["active", "passive"])
@pytest.mark.parametrize("blocks", [(128, 128, 128), (64, 128, 64)])
def test_plain_matches_reference_where_tc_bf16_runs(blocks, controller, act):
    """The plain version, which chip_smoke.py holds the tc_bf16 kernel
    against, at ragged M, N and K that tc_bf16 takes."""
    bm, bn, bk = blocks
    m, k, n = 200, 320, 300
    assert tmm.matmul_launch_plan(m=m, k=k, n=n, bm=bm, bn=bn, bk=bk,
                                  controller=controller,
                                  dtype=torch.bfloat16).body == "tc_bf16"
    rng = np.random.default_rng(bm + bk + len(controller) + len(act))
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    want = jmm.psum_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                           bm=bm, bn=bn, bk=bk, act=act, controller=controller)
    got = tmm.psum_matmul(torch.from_numpy(x).bfloat16(),
                          torch.from_numpy(w).bfloat16(), bm=bm, bn=bn, bk=bk,
                          act=act, controller=controller)
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_library_path_covers_included_headers(tmp_path, monkeypatch):
    """A change to a header in csrc/ renames the library of every source
    that includes it, so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert "hopper.cuh" in _build.sources("psum_matmul")
    assert "hopper.cuh" in _build.sources("flash_attention")
    assert "hopper.cuh" in _build.sources("conv2d_psum")
    (csrc / "plain.cu").write_text("// includes no header\n")
    assert _build.sources("plain") == ["plain.cu"]
    names = (*_build.SOURCES, "plain")
    before = {name: _build.library_path(name).name for name in names}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// changed\n")
    after = {name: _build.library_path(name).name for name in names}
    assert after["psum_matmul"] != before["psum_matmul"]
    assert after["flash_attention"] != before["flash_attention"]
    assert after["conv2d_psum"] != before["conv2d_psum"]
    assert after["plain"] == before["plain"]
