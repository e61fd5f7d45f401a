"""The gradient of the port's attention (`repro_torch.models.layers`:
`FlashAttention`, `attention`) against the live reference on the CPU.

The reference differentiates its plain-XLA ``chunked_attention``; the port
runs the flash kernel (its plain version here) as the forward and
recomputes `layers.chunked_attention` as the backward, under the call's own
arguments. Output, dq, dk and dv are held against ``jax.vjp`` of the
reference's function with the same upstream gradient, in fp32 at 2e-4 (the
reference's attention tolerance, tests/test_kernels.py): causal, a
non-causal ragged call that the flash wrapper runs as a causal one at
q_offset = Skv, GQA, v narrower than q and k (MLA), and queries at an
offset. The forward launches the flash kernel once and the backward not at
all; where no gradient is wanted `attention` is the flash wrapper itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops
from repro_torch.models import layers as tlayers

TOL = dict(rtol=2e-4, atol=2e-4)

#: name: (B, Hq, Hkv, Sq, Skv, D, Dv, causal, q_offset, chunk)
CASES = {
    "causal": (2, 4, 2, 40, 40, 32, 32, True, 0, 16),
    "non_causal_ragged": (2, 4, 4, 20, 150, 32, 32, False, 0, 64),
    "gqa_6_to_1": (1, 6, 1, 24, 24, 16, 16, True, 0, 1024),
    "dv_narrower": (2, 4, 4, 24, 24, 48, 32, True, 0, 8),
    "q_offset": (2, 4, 2, 8, 24, 32, 32, True, 16, 16),
}


def _inputs(case, seed=0):
    b, hq, hkv, sq, skv, d, dv, *_ = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, dv)).astype(np.float32)
    g = rng.standard_normal((b, hq, sq, dv)).astype(np.float32)
    return q, k, v, g


def _spy(monkeypatch, module, name) -> list:
    calls = []
    real = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("name", list(CASES))
def test_function_matches_jax_vjp_of_chunked_attention(name, monkeypatch):
    case = CASES[name]
    *_, causal, q_offset, chunk = case
    q, k, v, g = _inputs(case)

    def jfn(q, k, v):
        return jlayers.chunked_attention(q, k, v, causal=causal,
                                         q_offset=q_offset, chunk=chunk)

    jout, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jdq, jdk, jdv = vjp(jnp.asarray(g))

    runs = _spy(monkeypatch, tflash, "flash_attention")
    recomputes = _spy(monkeypatch, tlayers, "chunked_attention")
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tlayers.attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                            chunk=chunk)
    assert out.grad_fn is not None and not recomputes
    assert len(runs) == 1                       # one flash launch: the forward
    if name == "non_causal_ragged":             # the wrapper's rewrite
        assert (runs[0]["causal"], runs[0]["q_offset"]) == (True, case[4])
    out.backward(torch.from_numpy(g))
    assert len(runs) == 1                       # none in the backward
    # the recompute takes the call's own arguments, not the rewrite's
    assert recomputes == [dict(causal=causal, q_offset=q_offset,
                               kv_valid_len=None, chunk=chunk)]
    for what, got, want in (("out", out, jout), ("dq", tq.grad, jdq),
                            ("dk", tk.grad, jdk), ("dv", tv.grad, jdv)):
        assert tuple(got.shape) == tuple(want.shape), what
        assert torch.isfinite(got).all(), what
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   err_msg=what, **TOL)


@pytest.mark.parametrize("name", ["causal", "non_causal_ragged", "dv_narrower"])
def test_backward_is_autograd_through_chunked_attention(name):
    """The Function's gradients equal autograd through the port's own
    `chunked_attention` on the same inputs bit for bit (chip_smoke.py
    holds the same on the card)."""
    case = CASES[name]
    *_, causal, q_offset, chunk = case
    q, k, v, g = _inputs(case, seed=1)
    grads = []
    for fn in (tlayers.attention, tlayers.chunked_attention):
        qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        fn(*qkv, causal=causal, q_offset=q_offset,
           chunk=chunk).backward(torch.from_numpy(g))
        grads.append([t.grad for t in qkv])
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_only_the_inputs_that_need_a_gradient_get_one():
    q, k, v, g = _inputs(CASES["causal"], seed=2)
    tq = torch.from_numpy(q).requires_grad_()
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    tlayers.attention(tq, tk, tv, causal=True, chunk=16).backward(
        torch.from_numpy(g))
    assert tq.grad is not None and tk.grad is None and tv.grad is None


def test_without_a_gradient_attention_is_the_flash_wrapper(monkeypatch):
    """Inference mode, no_grad or inputs that need no gradient: the flash
    wrapper's own result, no Function in the graph, no recompute."""
    q, k, v, _ = _inputs(CASES["causal"], seed=3)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    want = ops.gqa_flash_attention(tq, tk, tv, causal=True)
    recomputes = _spy(monkeypatch, tlayers, "chunked_attention")
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            got = tlayers.attention(tq.requires_grad_(), tk, tv, causal=True)
        assert got.grad_fn is None and torch.equal(got, want)
        tq = tq.detach()
    got = tlayers.attention(tq, tk, tv, causal=True)
    assert got.grad_fn is None and torch.equal(got, want) and not recomputes


def test_a_device_position_with_a_gradient_is_refused():
    q, k, v, _ = _inputs(CASES["q_offset"], seed=4)
    tq = torch.from_numpy(q).requires_grad_()
    pos = torch.tensor(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="device tensor"):
        tlayers.attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                          causal=True, q_offset=pos)
    with torch.no_grad():                   # a cache read needs no gradient
        out = tlayers.attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                                causal=True, q_offset=pos,
                                kv_valid_len=pos + 8)
    assert torch.isfinite(out).all()
