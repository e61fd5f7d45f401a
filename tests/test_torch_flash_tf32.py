"""flash_attention's float32 tensor-core body, tc_3xtf32, on the CPU: the
body's arithmetic emulated in plain PyTorch (the pack's split of K and of
V transposed with its keys permuted, Q and P split, three TF32 products
per tile) against the reference package's Pallas kernel in interpret mode
(tolerance 2e-4, the reference's own, tests/test_kernels.py) and against
float64 attention; the key permutation that lets P stay in registers, as an
index map over wgmma's fragment layouts; the CPU pack bit for bit; the plan;
and the wrapper's checks before launch. The kernels themselves run only on
the card (chip_smoke.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import flash_attention as jflash
from repro_torch import plan
from repro_torch.kernels import _build
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels.psum_matmul import tf32_split
from test_torch_psum_tf32 import _np_split

TOL = 2e-4
QWEN_PREFILL = dict(bh=48, sq=1024, skv=1024, d=128, kv_group=6)   # batch 4


def _tf32_body(qp, kp, vp, *, causal, q_offset, skv, passes=3):
    """tc_3xtf32's arithmetic over padded float32 operands, qp (BH, Sq_p, D)
    and kp, vp (BH / g, Skv_p, D), with exact float32 sums: the CPU pack
    (K_hi, K_lo; Vt_hi, Vt_lo padded to whole tiles, keys permuted), Q split,
    then per tile of TF_KT keys S = Q_lo K_hi + Q_hi K_lo + Q_hi K_hi (or
    Q_hi K_hi alone with passes=1) in the log2 domain, the masks on S's own
    columns, the online softmax, P split, and O += P V against V^T's permuted
    keys, P's columns taken in the same order."""
    bh, sq_p, d = qp.shape
    hkv, skv_p, _ = kp.shape
    g, kt = bh // hkv, tflash.TF_KT
    skv_t = skv_p + (-skv_p) % kt
    ks, vts = tflash.tf32_pack_kv(kp, vp, skv_t=skv_t)
    kh, kl = (F.pad(x, (0, 0, 0, skv_t - skv_p)).repeat_interleave(g, 0) for x in ks)
    vh, vl = (x.repeat_interleave(g, 0) for x in vts)
    qh, ql = tf32_split(qp)
    order = tflash.tf_key_order(skv_t)
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    q_ids = q_offset + torch.arange(sq_p)[:, None]
    m = torch.full((bh, sq_p, 1), tflash.NEG_INF)
    l = torch.zeros(bh, sq_p, 1)
    o = torch.zeros(bh, sq_p, d)
    kv_end = min(skv, q_offset + sq_p) if causal else skv
    for k0 in range(0, kv_end, kt):
        t = slice(k0, k0 + kt)
        s = qh @ kh[:, t].mT
        if passes == 3:
            s = ql @ kh[:, t].mT + qh @ kl[:, t].mT + s
        cols = k0 + torch.arange(kt)
        masked = (cols >= skv) | ((cols > q_ids) if causal else False)
        s = torch.where(masked, tflash.NEG_INF, s * scale_log2)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        ph, pl = tf32_split(p[..., order[t] - k0])
        pv = ph @ vh[..., t].mT
        if passes == 3:
            pv = pl @ vh[..., t].mT + ph @ vl[..., t].mT + pv
        o = o * alpha + pv
        m = m_new
    return o / torch.clamp_min(l, 1e-30)


def _emulate(q, k, v, *, causal, q_offset, bq=128, bk=128, passes=3):
    """`_tf32_body` on numpy q (BH, Sq, D), k and v (BH / g, Skv, D) padded
    as `flash_launch_plan` pads them, sliced back to Sq rows."""
    bh, sq, d = q.shape
    hkv, skv, _ = k.shape
    lp = tflash.flash_launch_plan(bh=bh, sq=sq, skv=skv, d=d, bq=bq, bk=bk,
                                  causal=causal, q_offset=q_offset,
                                  kv_group=bh // hkv, dtype=torch.float32)
    assert lp.body == "tc_3xtf32"
    pq = lp.inputs[0].array_shape[1] - sq
    pk = lp.inputs[1].array_shape[1] - skv
    qp, kp, vp = (F.pad(torch.from_numpy(a), (0, 0, 0, p))
                  for a, p in ((q, pq), (k, pk), (v, pk)))
    return _tf32_body(qp, kp, vp, causal=causal, q_offset=q_offset, skv=skv,
                      passes=passes)[:, :sq]


@pytest.mark.parametrize("bh,sq,skv,d,causal,group,bq,bk", [
    (2, 100, 100, 64, True, 1, 128, 128),     # odd lengths, padded q and kv
    (8, 37, 37, 32, True, 4, 128, 128),       # GQA 4:1
    (12, 70, 90, 128, True, 6, 128, 128),     # GQA 6:1, q_offset 20
    (2, 100, 96, 64, False, 1, 64, 32),       # non-causal
    (4, 80, 113, 128, True, 2, 32, 16),       # q_offset 33, kv blocks of 16
    (3, 130, 130, 32, True, 3, 128, 128),     # two q tiles, ragged keys
])
def test_three_passes_match_reference(bh, sq, skv, d, causal, group, bq, bk):
    """The body's arithmetic against the JAX kernel in interpret mode, which
    takes one kv head per q head: k and v repeated, as its caller does."""
    rng = np.random.default_rng(bh * 1000 + sq + d)
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k, v = (rng.standard_normal((bh // group, skv, d)).astype(np.float32)
            for _ in range(2))
    q_offset = skv - sq if causal else 0
    want = jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, group, 0)),
        jnp.asarray(np.repeat(v, group, 0)), causal=causal, bq=bq, bk=bk,
        q_offset=q_offset)
    got = _emulate(q, k, v, causal=causal, q_offset=q_offset, bq=bq, bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def _exact(q, k, v):
    """Causal attention in float64."""
    s = q @ k.T / math.sqrt(q.shape[-1])
    s = np.where(np.tril(np.ones(s.shape, bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


def test_three_passes_hold_the_tolerance_at_qwen2_prefill_and_one_does_not():
    """One head at Qwen2-1.5B's prefill shape (S 1024, D 128, causal), unit
    normal q, k and v: three TF32 passes hold 2e-4 against float64 attention
    by a wide margin, one pass (hi*hi) misses it."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((1, 1024, 128)).astype(np.float32)
               for _ in range(3))
    exact = _exact(*(a[0].astype(np.float64) for a in (q, k, v)))
    three, one = (_emulate(q, k, v, causal=True, q_offset=0, passes=n)[0].double().numpy()
                  for n in (3, 1))
    assert np.abs(three - exact).max() < TOL / 50
    assert np.abs(one - exact).max() > TOL
    np.testing.assert_allclose(three, exact, rtol=TOL, atol=TOL)
    assert not np.allclose(one, exact, rtol=TOL, atol=TOL)


# ------------------------------------------------------- the key permutation
def _acc_fragment(lane: int, reg: int) -> tuple[int, int]:
    """(row, column) in a warp's 16 rows and one group of 8 columns of the
    wgmma fp32 accumulator register d[reg] (reg < 4) of `lane` (PTX ISA,
    wgmma's D fragment): rows g and g + 8, columns 2t and 2t + 1."""
    g, t = lane // 4, lane % 4
    return g + 8 * (reg // 2), 2 * t + reg % 2


def _a_fragment(lane: int, reg: int) -> tuple[int, int]:
    """(row, k column) of the TF32 A register a[reg] of `lane` in a k8 step
    (PTX ISA, wgmma .tf32 A in registers, as mma.m16n8k8.tf32): a0 (g, t),
    a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)."""
    g, t = lane // 4, lane % 4
    return g + 8 * (reg % 2), t + 4 * (reg // 2)


def test_accumulator_registers_land_on_a_registers_against_permuted_keys():
    """S registers (d0, d2, d1, d3) of a group of 8 keys are the A registers
    (a0, a1, a2, a3): the same row, and the key the pack stores at A's
    column (TF_KEY_ORDER) is the key the accumulator holds."""
    for lane in range(32):
        for a_reg, d_reg in enumerate((0, 2, 1, 3)):
            row, key = _acc_fragment(lane, d_reg)
            a_row, col = _a_fragment(lane, a_reg)
            assert (row, key) == (a_row, tflash.TF_KEY_ORDER[col])
    # each lane's four A registers cover its rows and k columns once
    cells = {_a_fragment(lane, r) for lane in range(32) for r in range(4)}
    assert cells == {(r, c) for r in range(16) for c in range(8)}


@pytest.mark.parametrize("n", [8, 32, 64, 1056])
def test_permuted_columns_times_permuted_keys_is_p_v(n):
    """The key order permutes each group of 8 keys; P with its columns in
    that order times V^T with its keys in that order is P V."""
    order = tflash.tf_key_order(n)
    assert sorted(order.tolist()) == list(range(n))
    assert (order // 8 == torch.arange(n) // 8).all()
    gen = torch.Generator().manual_seed(n)
    p = torch.rand(5, n, generator=gen, dtype=torch.float64)
    v = torch.randn(n, 16, generator=gen, dtype=torch.float64)
    torch.testing.assert_close(p[:, order] @ v.T[:, order].T, p @ v, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------- the pack
@pytest.mark.parametrize("hkv,skv_p,d,skv_t", [(2, 40, 32, 64), (1, 128, 128, 128),
                                               (3, 17, 64, 32)])
def test_cpu_pack_is_the_split_of_k_and_of_v_transposed_and_permuted(hkv, skv_p, d, skv_t):
    rng = np.random.default_rng(skv_p)
    k, v = (rng.standard_normal((hkv, skv_p, d)).astype(np.float32) for _ in range(2))
    ks, vts = tflash.tf32_pack_kv(torch.from_numpy(k), torch.from_numpy(v), skv_t=skv_t)
    assert ks.shape == (2, hkv, skv_p, d) and vts.shape == (2, hkv, d, skv_t)
    assert vts.is_contiguous()
    for got, want in zip(ks, _np_split(k)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    keys = [8 * (pos // 8) + (2 * (pos % 8) if pos % 8 < 4 else 2 * (pos % 8) - 7)
            for pos in range(skv_t)]
    vt = np.zeros((hkv, d, skv_t), np.float32)
    for pos, key in enumerate(keys):
        if key < skv_p:
            vt[:, :, pos] = v[:, key, :]
    for got, want in zip(vts, _np_split(vt)):
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


# ----------------------------------------------------------------- the plan
def test_qwen2_fp32_prefill_plan_takes_tc_3xtf32():
    lp = tflash.flash_launch_plan(**QWEN_PREFILL, dtype=torch.float32)
    assert lp.body == "tc_3xtf32"
    assert lp.grid == (48, 8) and lp.threads == tflash.TC_THREADS == 288
    assert lp.smem_bytes == tflash.tf_smem_bytes(128) == 197_672
    assert lp.smem_bytes <= plan.SMEM_BUDGET
    assert lp.loops == (("kv", 32),)
    assert lp.launches == 2                     # the pack, then the body
    device = {s.name: s.shape for s in lp.scratch if s.where == "device"}
    assert device == {"k_hi": (8, 1024, 128), "k_lo": (8, 1024, 128),
                      "vt_hi": (8, 128, 1024), "vt_lo": (8, 128, 1024)}


@pytest.mark.parametrize("kw,dtype,body", [
    (dict(QWEN_PREFILL), torch.bfloat16, "tc_bf16"),
    (dict(QWEN_PREFILL, sq=1, skv=1056, q_offset=1055), torch.float32, "split_kv"),
    (dict(QWEN_PREFILL, sq=1, skv=1056, q_offset=1055), torch.bfloat16, "split_kv"),
    (dict(bh=64, sq=1024, skv=1024, d=160, kv_group=4), torch.float32, "cuda_core"),
    (dict(bh=8, sq=512, skv=512, d=256), torch.float32, "cuda_core"),
    (dict(bh=8, sq=512, skv=512, d=32), torch.float32, "tc_3xtf32"),
    (dict(bh=8, sq=512, skv=512, d=64), torch.float32, "tc_3xtf32"),
    (dict(bh=8, sq=300, skv=300, d=100), torch.float32, "tc_3xtf32"),  # padded to 128
])
def test_other_calls_keep_their_bodies(kw, dtype, body):
    """bf16 keeps tc_bf16, decode keeps split_kv in both dtypes, and fp32
    at head dims past TF_MAX_D (StableLM-12B's 160, padded to 256) stays on
    cuda_core."""
    assert tflash.flash_launch_plan(**kw, dtype=dtype).body == body


@pytest.mark.parametrize("d", [32, 64, 128])
def test_plan_shared_memory_is_tf_smem_bytes(d):
    lp = tflash.flash_launch_plan(bh=4, sq=256, skv=256, d=d, dtype=torch.float32)
    stages = 1 if d == 128 else 2
    assert tflash.tf_stages(d) == stages
    assert lp.smem_bytes == tflash.tf_smem_bytes(d) == (
        1024 + 2 * 4 * 128 * d + stages * 4 * 4 * 32 * d + 8 * (1 + 4 * stages))
    assert lp.smem_bytes <= plan.SMEM_BUDGET
    ring = next(s for s in lp.scratch if s.name == "kv_ring")
    assert ring.shape == (stages, 4, tflash.TF_KT, d) and ring.where == "shared"


def test_body_asked_for_by_name():
    core = tflash.flash_launch_plan(**QWEN_PREFILL, dtype=torch.float32, body="cuda_core")
    assert (core.body, core.grid, core.threads, core.launches) == (
        "cuda_core", (32, 48), tflash.THREADS, 1)
    assert core.smem_bytes == 4 * tflash.smem_floats(128)
    assert not [s for s in core.scratch if s.where == "device"]
    same = tflash.flash_launch_plan(**QWEN_PREFILL, dtype=torch.float32, body="tc_3xtf32")
    assert same.body == "tc_3xtf32"
    with pytest.raises(ValueError, match="does not take this launch"):
        tflash.flash_launch_plan(**QWEN_PREFILL, dtype=torch.float32, body="tc_bf16")
    with pytest.raises(ValueError, match="does not take this launch"):
        tflash.flash_launch_plan(**QWEN_PREFILL, dtype=torch.bfloat16, body="cuda_core")
    with pytest.raises(ValueError, match="does not take this launch"):
        tflash.flash_launch_plan(bh=8, sq=64, skv=64, d=256, dtype=torch.float32,
                                 body="tc_3xtf32")


def test_cpu_call_on_either_fp32_body_runs_the_plain_version():
    """On the CPU both fp32 plans run `flash_plain`: the same numbers."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn(6, 40, 64, generator=gen)
    k, v = (torch.randn(2, 40, 64, generator=gen) for _ in range(2))
    plans = [tflash.flash_launch_plan(bh=6, sq=40, skv=40, d=64, kv_group=3, body=b)
             for b in ("tc_3xtf32", "cuda_core")]
    outs = [p.plain(q, k, v) for p in plans]
    assert torch.equal(outs[0], outs[1])


# -------------------------------------------------------------- the wrapper
def _no_library(name):
    raise AssertionError(f"library {name} loaded before the checks")


def test_tf32_wrapper_checks_before_loading_any_library(monkeypatch):
    """`_flash_cuda` refuses what tc_3xtf32 cannot take before it loads a
    library, so this runs without nvcc."""
    monkeypatch.setattr(_build, "load", _no_library)
    kw = dict(causal=True, q_offset=0, skv=64, body="tc_3xtf32")
    x = torch.zeros(4, 64, 64)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="takes torch.float32"):
        tflash._flash_cuda(xb, xb, xb, **kw)
    with pytest.raises(ValueError, match="chose its body for"):
        tflash._flash_cuda(xb, xb, xb, **kw, dtype=torch.float32)
    with pytest.raises(ValueError, match="head dims up to 128"):
        y = torch.zeros(4, 64, 256)
        tflash._flash_cuda(y, y, y, **kw)
    buf = torch.zeros(4 * 64 * 64 + 1)
    shifted = buf[1:].view(4, 64, 64)                   # 4 bytes off
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundaries"):
        tflash._flash_cuda(shifted, x, x, **kw)
    with pytest.raises(ValueError, match="splits"):
        tflash._flash_cuda(x, x, x, **kw, splits=2)


def test_tf32_wrapper_raises_when_the_library_fails(monkeypatch):
    """No fallback: a build failure reaches the caller, and neither
    cuda_core nor the plain version runs in its place."""
    def broken(name):
        raise RuntimeError(f"kernel build failed: {name}")

    monkeypatch.setattr(_build, "load", broken)
    monkeypatch.setattr(tflash, "flash_plain", _no_library)
    tflash._entry_points.cache_clear()
    x = torch.zeros(4, 64, 64)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tflash._flash_cuda(x, x, x, causal=True, q_offset=0, skv=64,
                           dtype=torch.float32, body="tc_3xtf32")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        tflash._flash_cuda(x, x, x, causal=True, q_offset=0, skv=64)  # default body
    tflash._entry_points.cache_clear()
