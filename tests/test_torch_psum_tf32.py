"""psum_matmul's float32 tensor-core body, tc_3xtf32, on the CPU: the split
of its pack pass (`tf32_split`) against a numpy bit reference of TF32
rounding, the three-pass product built from that split against the
reference package's fp32 Pallas kernel in interpret mode (tolerance 1e-3,
the reference's own, tests/test_kernels.py), the plan at the main path's
shape and the wrapper's checks before launch. The kernels themselves run
only on the card (chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import psum_matmul as jmm
from repro_torch import plan
from repro_torch.kernels import _build
from repro_torch.kernels import psum_matmul as tmm

MAIN = dict(m=4096, k=1536, n=8960, bm=128, bn=128, bk=128)   # Qwen2-1.5B FFN
TOL = 1e-3


def _np_round_tf32(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest, ties away from zero, at the low 13 bits of each
    float32's bits (sign and magnitude), in uint64 so nothing wraps."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    out = ((bits + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF
    return out.astype(np.uint32).view(np.float32)


def _np_split(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    hi = _np_round_tf32(x)
    with np.errstate(invalid="ignore", over="ignore"):
        rest = np.where(np.isinf(hi), np.float32(0), x - hi).astype(np.float32)
    return hi, _np_round_tf32(rest)


def _bits(*words: int) -> np.ndarray:
    return np.array(words, dtype=np.uint32).view(np.float32)


def _values(kind: str) -> np.ndarray:
    rng = np.random.default_rng(len(kind))
    if kind == "normal":
        mant = rng.standard_normal(4096).astype(np.float32)
        return (mant * np.float32(2.0) ** rng.integers(-60, 60, 4096)).astype(np.float32)
    if kind == "ties":
        # low 13 bits exactly half (0x1000), one under and one over, both signs
        base = rng.integers(0x00800000, 0x7F000000, 256, dtype=np.uint64) & 0xFFFFE000
        words = np.concatenate([base + 0x1000, base + 0x0FFF, base + 0x1001,
                                base + 0x1FFF])
        words = np.concatenate([words, words | 0x80000000])
        return words.astype(np.uint32).view(np.float32)
    if kind == "zeros":
        return _bits(0x00000000, 0x80000000, 0x00000FFF, 0x80000FFF)
    if kind == "subnormal":
        words = np.concatenate([[1, 0x0FFF, 0x1000, 0x1001, 0x1FFF, 0x2000,
                                 0x007FFFFF, 0x007FF000],
                                rng.integers(1, 0x00800000, 256)]).astype(np.uint64)
        return np.concatenate([words, words | 0x80000000]).astype(np.uint32).view(np.float32)
    if kind == "inf":
        return _bits(0x7F800000, 0xFF800000, 0x7F7FFFFF, 0xFF7FFFFF, 0x7F7FE000)
    raise ValueError(kind)


KINDS = ["normal", "ties", "zeros", "subnormal", "inf"]


@pytest.mark.parametrize("kind", KINDS)
def test_tf32_split_matches_bit_reference(kind):
    x = _values(kind)
    hi, lo = tmm.tf32_split(torch.from_numpy(x))
    want_hi, want_lo = _np_split(x)
    np.testing.assert_array_equal(hi.numpy().view(np.uint32), want_hi.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32), want_lo.view(np.uint32))


@pytest.mark.parametrize("kind", KINDS)
def test_tf32_split_clears_the_low_bits(kind):
    hi, lo = tmm.tf32_split(torch.from_numpy(_values(kind)))
    for part in (hi, lo):
        assert not (part.view(torch.int32) & ((1 << tmm.TF32_DROP) - 1)).any()


def test_tf32_split_keeps_22_bits_of_a_normal_value():
    x = _values("normal")
    hi, lo = tmm.tf32_split(torch.from_numpy(x))
    err = np.abs(hi.double().numpy() + lo.double().numpy() - x.astype(np.float64))
    assert (err <= 2.0 ** -22 * np.abs(x)).all()
    assert (np.abs(hi.numpy() - x) > 2.0 ** -22 * np.abs(x)).any()   # lo is needed


def test_tf32_split_specials():
    hi, lo = tmm.tf32_split(torch.tensor([float("inf"), -float("inf"), 0.0, -0.0, 1.0]))
    assert hi.tolist()[:2] == [float("inf"), -float("inf")]
    assert lo.tolist() == [0.0, 0.0, 0.0, 0.0, 0.0]
    assert torch.signbit(hi[3])
    nan_hi, _ = tmm.tf32_split(torch.tensor([float("nan")]))
    assert torch.isnan(nan_hi).all()


def _three_pass(xp, wp, *, bk, act, passes=3):
    """The body's arithmetic on the CPU: the k-block loop of `matmul_plain`
    over the split operands, lo*hi + hi*lo + hi*hi per block in fp32 (or
    hi*hi alone with passes=1)."""
    xh, xl = tmm.tf32_split(xp)
    wh, wl = tmm.tf32_split(wp)
    acc = torch.zeros(xp.shape[0], wp.shape[1])
    for k0 in range(0, xp.shape[1], bk):
        s = slice(k0, k0 + bk)
        if passes == 3:
            acc += xl[:, s] @ wh[s]
            acc += xh[:, s] @ wl[s]
        acc += xh[:, s] @ wh[s]
    # both controllers end in act(C) in float32: active in the kernel's
    # store, passive after it
    return tmm.ACTIVATIONS[act](acc)


def _run(x, w, *, bm, bn, bk, act, passes=3):
    m, n = x.shape[0], w.shape[1]
    xp = tmm._pad_to(torch.from_numpy(x), bm, bk)
    wp = tmm._pad_to(torch.from_numpy(w), bk, bn)
    return _three_pass(xp, wp, bk=bk, act=act, passes=passes)[:m, :n]


@pytest.mark.parametrize("act", sorted(tmm.ACTIVATIONS))
@pytest.mark.parametrize("controller", ["active", "passive"])
def test_three_passes_match_reference(controller, act):
    blocks = dict(bm=32, bn=64, bk=64)
    m, k, n = 50, 160, 150
    lp = tmm.matmul_launch_plan(m=m, k=k, n=n, **blocks, controller=controller,
                                act=act, dtype=torch.float32)
    assert lp.body == "tc_3xtf32"
    rng = np.random.default_rng(len(controller) * 7 + len(act))
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    want = jmm.psum_matmul(jnp.asarray(x), jnp.asarray(w), **blocks, act=act,
                           controller=controller)
    got = _run(x, w, **blocks, act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("controller", ["active", "passive"])
def test_three_passes_hold_the_tolerance_at_main_k_and_one_does_not(controller):
    """At the main path's K = 1536 one TF32 pass (hi*hi) misses 1e-3 and the
    three passes hold it."""
    blocks = dict(bm=64, bn=128, bk=128)
    m, k, n = 64, 1536, 128
    rng = np.random.default_rng(1536)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    want = np.asarray(jmm.psum_matmul(jnp.asarray(x), jnp.asarray(w), **blocks,
                                      controller=controller))
    three = _run(x, w, **blocks, act="none").numpy()
    one = _run(x, w, **blocks, act="none", passes=1).numpy()
    np.testing.assert_allclose(three, want, rtol=TOL, atol=TOL)
    assert not np.allclose(one, want, rtol=TOL, atol=TOL)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    assert np.abs(three - exact).max() < 2e-4 < 1e-2 < np.abs(one - exact).max()


def test_cpu_pack_is_the_split_of_x_and_of_w_transposed():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((24, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((40, 56)).astype(np.float32))
    xs, wts = tmm.tf32_pack(x, w)
    assert xs.shape == (2, 24, 40) and wts.shape == (2, 56, 40)
    assert wts.is_contiguous()
    for got, want in zip((*xs, *wts), (*tmm.tf32_split(x), *tmm.tf32_split(w.t()))):
        assert torch.equal(got.view(torch.int32), want.contiguous().view(torch.int32))


@pytest.mark.parametrize("controller", ["active", "passive"])
def test_main_path_fp32_plan_takes_tc_3xtf32(controller):
    lp = tmm.matmul_launch_plan(**MAIN, controller=controller, dtype=torch.float32)
    assert lp.body == "tc_3xtf32"
    assert lp.grid == (70, 32)
    assert lp.threads == 288                   # two warpgroups + producer warp
    assert lp.smem_bytes == tmm.tf_smem_bytes(128, 128) == 197_680
    assert lp.smem_bytes <= plan.SMEM_BUDGET
    assert lp.launches == (13 if controller == "passive" else 2)
    assert lp.loops == (("k", 4 if controller == "passive" else 48),)
    device = {s.name: s.shape for s in lp.scratch if s.where == "device"}
    assert device == {"x_hi": (4096, 1536), "x_lo": (4096, 1536),
                      "wt_hi": (8960, 1536), "wt_lo": (8960, 1536)}
    core = tmm.matmul_launch_plan(**MAIN, controller=controller,
                                  dtype=torch.float32, body="cuda_core")
    assert (core.body, core.threads, core.smem_bytes) == ("cuda_core", tmm.THREADS, 0)
    assert core.launches == lp.launches - 1
    assert not [s for s in core.scratch if s.where == "device"]


@pytest.mark.parametrize("blocks,k,body", [
    (dict(bm=64, bn=64, bk=64), 288, "tc_3xtf32"),
    (dict(bm=8, bn=8, bk=8), 288, "tc_3xtf32"),
    (dict(bm=64, bn=13, bk=36), 288, "tc_3xtf32"),   # Wt rows need no alignment
    (dict(bm=50, bn=100, bk=4), 6, "tc_3xtf32"),
    (dict(bm=256, bn=128, bk=128), 288, "cuda_core"),  # beyond the register tile
    (dict(bm=128, bn=256, bk=128), 288, "cuda_core"),
    (dict(bm=64, bn=64, bk=30), 288, "cuda_core"),      # k-steps off 16 bytes
    (dict(bm=64, bn=64, bk=290), 290, "cuda_core"),     # rows of kp = 290
])
def test_fp32_plans_outside_the_constraints_take_cuda_core(blocks, k, body):
    lp = tmm.matmul_launch_plan(m=200, k=k, n=312, **blocks, dtype=torch.float32)
    assert lp.body == body
    if body == "tc_3xtf32":
        assert lp.threads == (160 if blocks["bm"] <= 64 else 288)
        assert 0 < lp.smem_bytes <= plan.SMEM_BUDGET
    else:
        assert (lp.threads, lp.smem_bytes) == (tmm.THREADS, 0)


def test_a_body_asked_for_by_name_must_take_the_launch():
    with pytest.raises(ValueError, match="does not take this launch"):
        tmm.matmul_launch_plan(**MAIN, dtype=torch.float32, body="tc_bf16")
    with pytest.raises(ValueError, match="does not take this launch"):
        tmm.matmul_launch_plan(**{**MAIN, "bk": 30}, dtype=torch.float32,
                               body="tc_3xtf32")
    assert tmm.matmul_launch_plan(**MAIN, dtype=torch.bfloat16,
                                  body="cuda_core").body == "cuda_core"


def _no_library(name):
    raise AssertionError(f"library {name} loaded before the checks")


def test_tf32_wrapper_checks_before_loading_any_library(monkeypatch):
    """`_matmul_cuda` refuses what tc_3xtf32 cannot take before it loads a
    library, so this runs without nvcc."""
    monkeypatch.setattr(_build, "load", _no_library)
    kw = dict(name="t", bm=128, bn=128, bk=128, controller="active",
              act="none", body="tc_3xtf32")
    w = torch.zeros(128, 256)
    buf = torch.zeros(256 * 128 + 1)
    shifted = buf[1:].view(256, 128)                    # 4 bytes off
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundaries"):
        tmm._matmul_cuda(shifted, w, **kw)
    with pytest.raises(ValueError, match="multiples of 4"):
        tmm._matmul_cuda(torch.zeros(256, 130), torch.zeros(130, 256),
                         **{**kw, "bk": 130})
    with pytest.raises(ValueError, match="takes float32"):
        tmm._matmul_cuda(torch.zeros(256, 128, dtype=torch.bfloat16),
                         torch.zeros(128, 256, dtype=torch.bfloat16), **kw)
    with pytest.raises(ValueError, match="chose its body for"):
        tmm._matmul_cuda(torch.zeros(256, 128, dtype=torch.bfloat16),
                         torch.zeros(128, 256, dtype=torch.bfloat16), **kw,
                         dtype=torch.float32)


def test_tf32_wrapper_raises_when_the_library_fails(monkeypatch):
    """No fallback: a build failure reaches the caller, and neither
    cuda_core nor the plain version runs in its place."""
    def broken(name):
        raise RuntimeError(f"kernel build failed: {name}")

    monkeypatch.setattr(_build, "load", broken)
    monkeypatch.setattr(tmm, "matmul_plain", _no_library)
    tmm._entry_point.cache_clear()
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tmm._matmul_cuda(torch.zeros(128, 128), torch.zeros(128, 128), name="t",
                         bm=128, bn=128, bk=128, controller="passive",
                         act="none", body="tc_3xtf32", dtype=torch.float32)
    tmm._entry_point.cache_clear()
