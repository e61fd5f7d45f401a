"""The port's flash attention on CPU tensors (its plain version) against the
reference package: JAX `flash_attention` and `gqa_flash_attention` in
interpret mode, `chunked_attention` at the serving call's shapes, and the
oracle `attention_ref`, on the same numpy inputs. Tolerances are the
reference's own (tests/test_kernels.py): fp32 2e-4, bf16 3e-2."""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import launch
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-4, "bfloat16": 3e-2}

ATTN_CASES = [
    # (bh, sq, skv, d, causal, bq, bk), as tests/test_kernels.py
    (2, 128, 128, 64, True, 64, 64),
    (1, 64, 64, 32, False, 32, 32),
    (3, 100, 100, 64, True, 32, 32),     # padded q
    (2, 1, 256, 64, True, 1, 64),        # decode: q_len=1
    (2, 8, 384, 128, True, 8, 128),      # speculative block decode
]


def _pair(rng, shape, dtype):
    """The same numbers as a jax array and a torch tensor of one dtype."""
    a = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, dtype=jd), torch.from_numpy(a).to(td)


def _close(got, want, tol):
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("bh,sq,skv,d,causal,bq,bk", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax(bh, sq, skv, d, causal, bq, bk, dtype):
    rng = np.random.default_rng(bh + sq + d)
    jq, tq = _pair(rng, (bh, sq, d), dtype)
    jk, tk = _pair(rng, (bh, skv, d), dtype)
    jv, tv = _pair(rng, (bh, skv, d), dtype)
    q_off = skv - sq if causal else 0
    want = jflash.flash_attention(jq, jk, jv, causal=causal, bq=bq, bk=bk,
                                  q_offset=q_off)
    got = tflash.flash_attention(tq, tk, tv, causal=causal, bq=bq, bk=bk,
                                 q_offset=q_off)
    assert got.dtype == tq.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("b,hq,hkv,sq,skv,q_offset", [
    (2, 4, 2, 24, 24, 0), (1, 6, 1, 1, 40, 39), (2, 4, 4, 5, 33, 28)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_flash_attention_matches_jax(b, hq, hkv, sq, skv, q_offset, dtype):
    """The port indexes kv head h // (Hq / Hkv) where the reference repeats
    the kv heads; padded q and kv tails, decode and MQA included."""
    rng = np.random.default_rng(hq * 10 + skv)
    jq, tq = _pair(rng, (b, hq, sq, 32), dtype)
    jk, tk = _pair(rng, (b, hkv, skv, 32), dtype)
    jv, tv = _pair(rng, (b, hkv, skv, 32), dtype)
    kw = dict(causal=True, q_offset=q_offset, bq=16, bk=16)
    want = jops.gqa_flash_attention(jq, jk, jv, **kw)
    got = tops.gqa_flash_attention(tq, tk, tv, **kw)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_odd_blocks_match_the_oracle(dtype):
    """sq = 17, d = 32, bq = 16, bk = 32: the case whose dataflow proof the
    reference rejects (ROADMAP D), held against `attention_ref`."""
    rng = np.random.default_rng(17)
    _, q = _pair(rng, (1, 17, 32), dtype)
    _, k = _pair(rng, (1, 17, 32), dtype)
    _, v = _pair(rng, (1, 17, 32), dtype)
    got = tflash.flash_attention(q, k, v, causal=True, bq=16, bk=32)
    want = tref.attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("pos,s", [(0, 16), (20, 1), (20, 5), (47, 1)])
def test_serving_call_matches_chunked_attention(pos, s):
    """What `attn_apply` calls (GQA, q_offset = pos, keys sliced to pos + s)
    against the reference's `chunked_attention` over the full cache with
    kv_valid_len = pos + s; a stale, non-zero cache tail must not leak in."""
    b, hq, hkv, d, max_len = 2, 4, 2, 64, 48
    rng = np.random.default_rng(pos * 7 + s)
    jq, tq = _pair(rng, (b, hq, s, d), "float32")
    jk, tk = _pair(rng, (b, hkv, max_len, d), "float32")
    jv, tv = _pair(rng, (b, hkv, max_len, d), "float32")
    want = jlayers.chunked_attention(jq, jk, jv, causal=True, q_offset=pos,
                                     kv_valid_len=jnp.int32(pos + s), chunk=16)
    got = tops.gqa_flash_attention(tq, tk[:, :, :pos + s], tv[:, :, :pos + s],
                                   causal=True, q_offset=pos)
    _close(got, want, TOL["float32"])


@pytest.mark.parametrize("kw,match", [
    (dict(bh=2, sq=0, skv=8, d=32), "degenerate"),
    (dict(bh=2, sq=8, skv=100, d=32, bk=32, causal=False), "not a multiple"),
    (dict(bh=2, sq=8, skv=8, d=32, q_offset=-1), "negative q_offset"),
])
def test_launch_check_rejects_before_planning(kw, match):
    """The three cases the reference's launch check rejects raise
    ValueError from the entry point; the reference rejects them too."""
    shape = dict(bh=2, sq=8, skv=8, d=32)
    shape.update({k: kw[k] for k in shape})
    opts = {k: v for k, v in kw.items() if k not in shape}
    q = torch.zeros(shape["bh"], shape["sq"], shape["d"])
    k = torch.zeros(shape["bh"], shape["skv"], shape["d"])
    with pytest.raises(ValueError, match=match):
        tflash.flash_attention(q, k, k, **opts)
    with pytest.raises(Exception):
        jflash.flash_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                               jnp.asarray(k.numpy()), **opts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,sq,skv,d,bq,bk,q_offset", [
    (48, 1024, 1024, 128, 128, 128, 0), (48, 1, 1056, 128, 128, 128, 1055),
    (3, 100, 100, 64, 32, 32, 0), (1, 17, 17, 32, 16, 32, 0),
    (2, 8, 384, 128, 8, 128, 376)])
def test_launch_plan_matches_reference_geometry(bh, sq, skv, d, bq, bk, q_offset,
                                                dtype):
    """Operand shapes are the reference's; the grid and loops are the body's
    own: one block per 32 (cuda_core) or 128 (tc_bf16, tc_3xtf32) padded q
    rows of a head, or one per (split, kv head) for split_kv."""
    kw = dict(bh=bh, sq=sq, skv=skv, d=d, bq=bq, bk=bk, q_offset=q_offset)
    got = tflash.flash_launch_plan(**kw, dtype=DTYPES[dtype][1])
    want = jflash.flash_launch_plan(**kw)
    assert [o.array_shape for o in got.inputs + got.outputs] \
        == [o.array_shape for o in want.inputs + want.outputs]
    sq_p = want.inputs[0].array_shape[1]
    if got.body == "cuda_core":
        assert got.loops == (("kv", want.grid[2]),)
        assert got.grid == (-(-sq_p // tflash.QT), bh)
    elif got.body == "tc_bf16":
        assert got.loops == (("kv", -(-min(skv, q_offset + sq_p)
                                      // tflash.tc_keys(d))),)
        assert got.grid == (bh, -(-sq_p // tflash.TC_QT))
    elif got.body == "tc_3xtf32":
        assert got.loops == (("kv", -(-min(skv, q_offset + sq_p)
                                      // tflash.TF_KT)),)
        assert got.grid == (bh, -(-sq_p // tflash.TC_QT)) and got.launches == 2
    else:
        splits, split_len = tflash.split_keys(hkv=bh, rows=sq_p, skv=skv, d=d)
        assert got.loops == (("kv", -(-split_len // tflash.SPLIT_KT)),
                             ("splits", splits))
        assert got.grid == (splits, bh) and got.launches == 2
    assert got.smem_bytes <= 232_448           # one H100 block's shared memory
    gqa = tflash.flash_launch_plan(**kw, kv_group=bh if bh % 2 else 2)
    assert gqa.inputs[1].array_shape[0] == (1 if bh % 2 else bh // 2)


def test_cpu_tensors_run_the_plain_version_uncounted():
    launch.reset_launches()
    q = torch.randn(2, 4, 8, 32)
    out = tops.gqa_flash_attention(q, q[:, :2], q[:, :2])
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert launch.LAUNCHES == {}


def test_cuda_wrapper_checks_before_launching():
    """The CUDA wrapper refuses what the kernel does not take before any
    library is loaded: head dims wider than the widest it is built for
    (narrower ones are padded up to a built one), mixed or unsupported
    dtypes, kv heads that do not divide the q heads."""
    x = torch.zeros(4, 8, 320)
    with pytest.raises(ValueError, match="head dim 320"):
        tflash._flash_cuda(x, x, x, causal=True, q_offset=0, skv=8)
    y = torch.zeros(4, 8, 64)
    with pytest.raises(ValueError, match="operands of one type"):
        tflash._flash_cuda(y, y.double(), y, causal=True, q_offset=0, skv=8)
    with pytest.raises(ValueError, match="q heads 4"):
        tflash._flash_cuda(y, y[:3].contiguous(), y[:3].contiguous(),
                           causal=True, q_offset=0, skv=8)
    with pytest.raises(ValueError, match="2 kv heads"):
        tops.gqa_flash_attention(torch.zeros(1, 3, 4, 32), torch.zeros(1, 2, 4, 32),
                                 torch.zeros(1, 2, 4, 32))


# ------------------------------------------------------------ split_kv decode
_DECODE = dict(b=1, hq=6, hkv=1, d=32)     # GQA 6:1, as Qwen2-1.5B's 12:2


@functools.lru_cache(maxsize=None)
def _decode_case(sq, skv, dtype):
    """Decode-shaped inputs (q at positions skv - sq ..) as torch tensors
    and the JAX `gqa_flash_attention` output on the same numbers."""
    b, hq, hkv, d = (_DECODE[n] for n in ("b", "hq", "hkv", "d"))
    rng = np.random.default_rng(sq * 10_000 + skv)
    jq, tq = _pair(rng, (b, hq, sq, d), dtype)
    jk, tk = _pair(rng, (b, hkv, skv, d), dtype)
    jv, tv = _pair(rng, (b, hkv, skv, d), dtype)
    want = jops.gqa_flash_attention(jq, jk, jv, causal=True, q_offset=skv - sq)
    return tq, tk, tv, np.asarray(want, np.float32)


def _plain_padded(q, k, v, *, splits, causal=True, q_offset, bq=128, bk=128):
    """`flash_plain` on operands padded as the launch plan pads them.
    q: (BH, Sq, D); k/v: (BH / g, Skv, D)."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    plan = tflash.flash_launch_plan(bh=bh, sq=sq, skv=skv, d=d, bq=bq, bk=bk,
                                    causal=causal, q_offset=q_offset,
                                    kv_group=bh // k.shape[0])
    pq = plan.inputs[0].array_shape[1] - sq
    pk = plan.inputs[1].array_shape[1] - skv
    qp, kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, p))
                  for t, p in ((q, pq), (k, pk), (v, pk)))
    bq, bk = plan.inputs[0].block_shape[1], plan.inputs[1].block_shape[1]
    out = tflash.flash_plain(qp, kp, vp, bq=bq, bk=bk, causal=causal,
                             q_offset=q_offset, skv=skv, splits=splits)
    return out[:, :sq]


@pytest.mark.parametrize("splits", [1, 2, 3, 17])
@pytest.mark.parametrize("sq,skv", [(1, 1056), (8, 1056), (1, 1001), (8, 1001)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_splits_match_jax(splits, sq, skv, dtype):
    """Each key range from its own (m, l, acc), combined as split_kv's second
    pass combines them, against the reference's single walk."""
    tq, tk, tv, want = _decode_case(sq, skv, dtype)
    b, hq, hkv, d = (_DECODE[n] for n in ("b", "hq", "hkv", "d"))
    got = _plain_padded(tq.reshape(b * hq, sq, d), tk.reshape(b * hkv, skv, d),
                        tv.reshape(b * hkv, skv, d), splits=splits,
                        q_offset=skv - sq)
    assert got.dtype == tq.dtype
    _close(got.reshape(b, hq, sq, d), want, TOL[dtype])


@pytest.mark.parametrize("sq,skv,q_offset,splits", [
    (8, 64, 0, 3),       # rows 0..7 see keys 0..7: splits 2 and 3 see none
    (2, 10, 8, 6),       # ranges of 2 keys: the sixth range is empty
    (1, 40, 3, 17)])     # one row, 4 visible keys, in the first two ranges
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_that_sees_no_key_has_weight_zero(sq, skv, q_offset, splits, dtype):
    rng = np.random.default_rng(sq + skv + splits)
    jq, tq = _pair(rng, (2, sq, 32), dtype)
    jk, tk = _pair(rng, (2, skv, 32), dtype)
    jv, tv = _pair(rng, (2, skv, 32), dtype)
    want = jflash.flash_attention(jq, jk, jv, causal=True, bq=8, bk=16,
                                  q_offset=q_offset)
    got = _plain_padded(tq, tk, tv, splits=splits, q_offset=q_offset, bq=8,
                        bk=16)
    _close(got, want, TOL[dtype])
    assert torch.isfinite(got.float()).all()


def _one_pass_loop(qp, kp, vp, *, bq, bk, causal, q_offset, skv):
    """The one-pass plain loop as the port had it before split_kv."""
    bh, sq_p, d = qp.shape
    hkv, skv_p, _ = kp.shape
    g, gq = bh // hkv, sq_p // bq
    scale = 1.0 / math.sqrt(d)
    q = qp.float().reshape(hkv, g, gq, bq, d)
    acc = torch.zeros(hkv, g, gq, bq, d, dtype=torch.float32)
    m = torch.full((hkv, g, gq, bq, 1), tflash.NEG_INF, dtype=torch.float32)
    l = torch.zeros_like(m)
    q_ids = (torch.arange(gq)[:, None] * bq + torch.arange(bq)[None, :]
             + q_offset)[..., None]
    for k0 in range(0, skv_p, bk):
        kb = kp[:, k0:k0 + bk].float()
        vb = vp[:, k0:k0 + bk].float()
        s = torch.einsum("hgiqd,hkd->hgiqk", q, kb) * scale
        if causal:
            k_ids = k0 + torch.arange(kb.shape[1])
            s = torch.where((q_ids >= k_ids) & (k_ids < skv), s, tflash.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("hgiqk,hkd->hgiqd", p, vb)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).reshape(bh, sq_p, d).to(qp.dtype)


@pytest.mark.parametrize("causal,skv,skv_p", [(True, 100, 128), (False, 96, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_split_is_bit_identical_to_the_one_pass_loop(causal, skv, skv_p, dtype):
    gen = torch.Generator().manual_seed(skv)
    td = DTYPES[dtype][1]
    qp = torch.randn(6, 32, 64, generator=gen).to(td)
    kp, vp = (torch.randn(2, skv_p, 64, generator=gen).to(td) for _ in range(2))
    kw = dict(bq=16, bk=32, causal=causal, q_offset=skv - 32 if causal else 0,
              skv=skv)
    assert torch.equal(tflash.flash_plain(qp, kp, vp, splits=1, **kw),
                       _one_pass_loop(qp, kp, vp, **kw))


QWEN_PREFILL = dict(bh=48, sq=1024, skv=1024, d=128, q_offset=0, kv_group=6)
QWEN_DECODE = dict(bh=48, sq=1, skv=1056, d=128, q_offset=1055, kv_group=6)


@pytest.mark.parametrize("kw,dtype,body,grid,loops", [
    (QWEN_PREFILL, "float32", "tc_3xtf32", (48, 8), (("kv", 32),)),
    (QWEN_PREFILL, "bfloat16", "tc_bf16", (48, 8), (("kv", 8),)),
    (QWEN_DECODE, "float32", "split_kv", (17, 8), (("kv", 2), ("splits", 17))),
    (QWEN_DECODE, "bfloat16", "split_kv", (17, 8), (("kv", 2), ("splits", 17))),
])
def test_plan_body_at_qwen2_serving_shapes(kw, dtype, body, grid, loops):
    """Qwen2-1.5B at batch 4 (12 q heads over 2 kv heads, D 128): prefill of
    1024 tokens takes the one-pass body of its dtype (tc_3xtf32 adds its
    pack pass, one launch more); decode against 1056
    keys splits the keys of 8 kv heads 17 ways (136 blocks on 132 SMs) and
    reads each kv head once for its 6 q heads."""
    plan = tflash.flash_launch_plan(**kw, dtype=DTYPES[dtype][1])
    assert (plan.body, plan.grid, plan.loops) == (body, grid, loops)
    if body == "split_kv":
        assert plan.launches == 2 and plan.threads == tflash.SPLIT_THREADS
        scratch = {s.name: s for s in plan.scratch}
        assert scratch["part_acc"].shape == (8, 17, 6, 128)
        assert scratch["part_ml"].shape == (8, 17, 6, 2)
        assert scratch["part_acc"].where == "device"
    else:
        assert plan.launches == (2 if body == "tc_3xtf32" else 1)
        assert plan.threads == tflash.TC_THREADS


@pytest.mark.parametrize("case,bodies", zip(ATTN_CASES, [
    ("tc_3xtf32", "tc_bf16"), ("split_kv", "split_kv"), ("tc_3xtf32", "tc_bf16"),
    ("split_kv", "split_kv"), ("split_kv", "split_kv")]))
def test_plan_body_at_reference_cases(case, bodies):
    """The reference's five cases: two are one-pass, three split (at most 64
    rows of a kv head, and too few one-pass blocks to fill the card)."""
    bh, sq, skv, d, causal, bq, bk = case
    for dtype, body in zip((torch.float32, torch.bfloat16), bodies):
        plan = tflash.flash_launch_plan(bh=bh, sq=sq, skv=skv, d=d, bq=bq,
                                        bk=bk, causal=causal, dtype=dtype)
        assert plan.body == body
        if body == "split_kv":
            assert plan.loops[1] == ("splits", tflash.split_keys(
                hkv=bh, rows=plan.inputs[0].array_shape[1], skv=skv, d=d)[0])


@pytest.mark.parametrize("hkv,rows,skv,d", [
    (8, 6, 1056, 128), (8, 6, 1025, 128), (8, 48, 1056, 128), (1, 64, 8400, 256),
    (2, 1, 256, 64), (1, 1, 10, 32), (132, 1, 4096, 64), (3, 20, 70, 32)])
def test_split_keys_cover_the_keys_with_bounded_partials(hkv, rows, skv, d):
    """Non-empty ranges that cover [0, skv); about a wave of blocks unless a
    split would hold fewer than SPLIT_UNIT keys or its fp32 partials (rows x
    (d + 2) words, written and read) would cost more than half the bytes of
    the bf16 K and V it reads."""
    splits, split_len = tflash.split_keys(hkv=hkv, rows=rows, skv=skv, d=d)
    assert (splits - 1) * split_len < skv <= splits * split_len
    units = -(-skv // tflash.SPLIT_UNIT)
    assert 1 <= splits <= max(1, units)
    assert splits == 1 or 2 * 4 * rows * (d + 2) * splits <= (2 * 2 * skv * d) // 2
    if min(units, skv * d // (4 * rows * (d + 2))) * hkv >= tflash.SMS:
        assert hkv * (splits + 1) >= tflash.SMS


def test_split_kv_serving_path_matches_jax_decode():
    """The public entry point at a decode shape takes split_kv on the CPU too
    (its plain version with the plan's key ranges) and matches the JAX
    reference."""
    tq, tk, tv, want = _decode_case(1, 1056, "float32")
    plan = tflash.flash_launch_plan(bh=6, sq=1, skv=1056, d=32, q_offset=1055,
                                    kv_group=6)
    assert plan.body == "split_kv" and plan.loops[1][1] > 1
    got = tops.gqa_flash_attention(tq, tk, tv, causal=True, q_offset=1055)
    _close(got, want, TOL["float32"])


def test_split_wrapper_checks_rows_before_launching():
    """A split launch holds every row of a kv head in one block: more than
    SPLIT_ROWS raises before any library is loaded."""
    q = torch.zeros(8, 16, 64)
    kv = torch.zeros(1, 32, 64)
    with pytest.raises(ValueError, match="at most 64 rows"):
        tflash._flash_cuda(q, kv, kv, causal=True, q_offset=16, skv=32, splits=2)


def test_plan_refuses_operands_of_another_dtype():
    """The body is chosen for the plan's dtype; the CUDA callable refuses
    operands of another dtype before any library is loaded."""
    plan = tflash.flash_launch_plan(bh=4, sq=256, skv=256, d=64,
                                    dtype=torch.bfloat16)
    assert plan.body == "tc_bf16"
    x = torch.zeros(plan.inputs[0].array_shape)
    with pytest.raises(ValueError, match="chose its body for torch.bfloat16"):
        plan.cuda(x, x, x)


# ------------------------------------------------- head dims not built (C2)
def test_plan_pads_stablelm_head_dim_160():
    """StableLM-12B's head dim 160 (5120 / 32) runs at the built dim 256 in
    every body: the plan sizes the body for 256 and lists the zero-padded
    copies of q, k and v as device scratch; 32 q heads over 8 kv heads."""
    assert tflash.built_head_dim(160) == 256
    assert [tflash.built_head_dim(d) for d in (32, 48, 64, 100, 128, 256, 320)] \
        == [32, 64, 64, 128, 128, 256, 320]
    kw = dict(bh=2 * 32, d=160, kv_group=4)
    cases = {"tc_bf16": dict(sq=1024, skv=1024, dtype=torch.bfloat16),
             "cuda_core": dict(sq=1024, skv=1024, dtype=torch.float32),
             "split_kv": dict(sq=1, skv=1056, q_offset=1055, dtype=torch.bfloat16)}
    for body, case in cases.items():
        plan = tflash.flash_launch_plan(**kw, **case)
        assert plan.body == body
        assert plan.inputs[0].array_shape[-1] == 160
        padded = {s.name: s.shape for s in plan.scratch if s.name.endswith("_padded")}
        assert padded == {"q_padded": (64, plan.inputs[0].array_shape[1], 256),
                          "k_padded": (16, plan.inputs[1].array_shape[1], 256),
                          "v_padded": (16, plan.inputs[1].array_shape[1], 256)}
        assert all(s.where == "device" for s in plan.scratch if s.name.endswith("_padded"))
    assert tflash.flash_launch_plan(**kw, **cases["tc_bf16"]).smem_bytes \
        == tflash.tc_smem_bytes(256)
    assert tflash.flash_launch_plan(**kw, **cases["cuda_core"]).smem_bytes \
        == 4 * tflash.smem_floats(256)
    no_pad = tflash.flash_launch_plan(bh=64, sq=1024, skv=1024, d=128, kv_group=4)
    assert not any(s.name.endswith("_padded") for s in no_pad.scratch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_jax_at_head_dim_160(dtype):
    """The plain version against the JAX kernel in interpret mode at d = 160
    (scale 1/sqrt(160)), GQA 4:1 through the ops wrapper."""
    rng = np.random.default_rng(160)
    b, hq, hkv, sq, skv = 1, 4, 1, 24, 24
    jq, tq = _pair(rng, (b, hq, sq, 160), dtype)
    jk, tk = _pair(rng, (b, hkv, skv, 160), dtype)
    jv, tv = _pair(rng, (b, hkv, skv, 160), dtype)
    want = jops.gqa_flash_attention(jq, jk, jv, causal=True, q_offset=0)
    got = tops.gqa_flash_attention(tq, tk, tv, causal=True, q_offset=0)
    _close(got, want, TOL[dtype])


def test_cuda_wrapper_pads_head_dim_and_keeps_the_scale(monkeypatch):
    """The CUDA wrapper hands the launch q, k and v zero-padded to the
    built dim with the logical d for the scale, and slices the output
    back: with the launch replaced by exact attention over what it is
    given, scaled by 1/sqrt(d), the result is the oracle's at d = 160."""
    seen = []

    def exact(qp, kp, vp, *, causal, q_offset, skv, splits, d, body):
        seen.append((tuple(qp.shape), tuple(kp.shape), d, body))
        g = qp.shape[0] // kp.shape[0]
        k, v = (t.repeat_interleave(g, dim=0).float() for t in (kp, vp))
        s = torch.einsum("bqd,bkd->bqk", qp.float(), k) / math.sqrt(d)
        qi = torch.arange(qp.shape[1])[:, None] + q_offset
        s = torch.where(qi >= torch.arange(k.shape[1])[None, :], s, -torch.inf)
        return torch.einsum("bqk,bkd->bqd", torch.softmax(s, -1), v).to(qp.dtype)

    monkeypatch.setattr(tflash, "_flash_launch", exact)
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((8, 16, 160), (2, 16, 160), (2, 16, 160)))
    got = tflash._flash_cuda(q, k, v, causal=True, q_offset=0, skv=16)
    assert seen == [((8, 16, 256), (2, 16, 256), 160, "cuda_core")]
    want = tref.attention_ref(q, k.repeat_interleave(4, 0), v.repeat_interleave(4, 0))
    assert got.shape == (8, 16, 160)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
