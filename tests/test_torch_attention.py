"""The port's flash attention on CPU tensors (its plain version) against the
reference package: JAX `flash_attention` and `gqa_flash_attention` in
interpret mode, `chunked_attention` at the serving call's shapes, and the
oracle `attention_ref`, on the same numpy inputs. Tolerances are the
reference's own (tests/test_kernels.py): fp32 2e-4, bf16 3e-2."""

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


@pytest.mark.parametrize("bh,sq,skv,d,bq,bk,q_offset", [
    (48, 1024, 1024, 128, 128, 128, 0), (48, 1, 1056, 128, 128, 128, 1055),
    (3, 100, 100, 64, 32, 32, 0), (1, 17, 17, 32, 16, 32, 0),
    (2, 8, 384, 128, 8, 128, 376)])
def test_launch_plan_matches_reference_geometry(bh, sq, skv, d, bq, bk, q_offset):
    kw = dict(bh=bh, sq=sq, skv=skv, d=d, bq=bq, bk=bk, q_offset=q_offset)
    got, want = tflash.flash_launch_plan(**kw), jflash.flash_launch_plan(**kw)
    assert [o.array_shape for o in got.inputs + got.outputs] \
        == [o.array_shape for o in want.inputs + want.outputs]
    assert got.loops == (("kv", want.grid[2]),)
    sq_p = want.inputs[0].array_shape[1]
    assert got.grid == (-(-sq_p // tflash.QT), bh)
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
    library is loaded: head dims it is not built for, mixed or unsupported
    dtypes, kv heads that do not divide the q heads."""
    x = torch.zeros(4, 8, 48)
    with pytest.raises(ValueError, match="head dim 48"):
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
