"""The port's multi-head latent attention (`repro_torch.models.layers`:
`chunked_attention`, `mla_init`, `init_mla_cache`, `mla_apply`), the flash
wrapper with v narrower than q and k, and DeepSeek-V2-Lite
(deepseek-v2-lite-16b: MLA, one leading dense layer, MoE) against the live
reference (`repro.models.layers`, `repro.models.transformer`) on the CPU.
Inputs come from numpy seeds; the reference's weights reach the port
through `params_from_jax`.

Tolerances are the reference's: attention fp32 2e-4 and bf16 3e-2
(tests/test_kernels.py), the layer and the model at
tests/test_torch_models.py's (fp32 2e-4, bf16 rtol 5e-2 atol 8e-2). The
port keeps an MLA layer's cache as one (B, L, kv_lora + qk_rope) buffer;
its two column ranges are held against the reference's ``latent`` and
``k_pe``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import check as tcheck
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import launch
from repro_torch.kernels import ops as tops
from repro_torch.launch import graph
from repro_torch.models import layers as tlayers
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf

ARCH = "deepseek-v2-lite-16b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATTN_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
MODEL_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
             "bfloat16": dict(rtol=5e-2, atol=8e-2)}
B, S, N_PREFILL = 2, 12, 8


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _cfgs(dtype="float32", **moe):
    """The smoke config in both packages, with ``dtype`` and MoE fields."""
    out = []
    for get in (jget_smoke, tconfigs.get_smoke):
        cfg = get(ARCH)
        out.append(dataclasses.replace(
            cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe, **moe)))
    return out


def _pair(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, dtype=jd), torch.from_numpy(a).to(td)


def _close(got, want, tol, what=""):
    assert tuple(got.shape) == tuple(np.shape(want)), what
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               err_msg=what, **tol)


def _attn_tol(dtype):
    return dict(rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape), tree.dtype)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


# ------------------------------------------------------------------- params
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_init_is_the_reference_tree(dtype):
    """Keys and shapes of the reference's `mla_init`, all in the config's
    dtype; the cache one buffer of kv_lora + qk_rope columns."""
    jcfg, tcfg = _cfgs(dtype)
    want = jax.eval_shape(lambda: jlayers.mla_init(jax.random.PRNGKey(0), jcfg))
    got = tlayers.mla_init(torch.Generator().manual_seed(0), tcfg,
                           torch.device("cpu"))
    flat = _flat(got)
    assert {k: s for k, (s, _) in flat.items()} == {
        "/" + "/".join(k.key for k in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert {d for _, d in flat.values()} == {DTYPES[dtype][1]}
    m = tcfg.mla
    cache = tlayers.init_mla_cache(tcfg, 3, 10, torch.device("cpu"))
    assert list(cache) == [tlayers.MLA_CACHE]
    buf = cache[tlayers.MLA_CACHE]
    assert buf.shape == (3, 10, m.kv_lora + m.qk_rope) and not buf.any()
    assert buf.dtype == DTYPES[dtype][1]


def test_count_params_at_full_width():
    """15,706,484,224 parameters, the reference's count, and its active
    count (top-6 of 64 routed experts)."""
    tcfg, jcfg = tconfigs.get_config(ARCH), jget_config(ARCH)
    assert ttf.count_params(tcfg) == jtf.count_params(jcfg) == 15_706_484_224
    assert ttf.count_params(tcfg, active_only=True) \
        == jtf.count_params(jcfg, active_only=True)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.n_layers == 27


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_carrier_puts_the_dense_layer_first(dtype):
    """`params_from_jax` builds `init_lm`'s flat list: the reference's
    ``first[0]`` (a dense FFN of first_dense_ff) in front of the periods,
    the MLA tree under ``attn``, ``kv_norm`` in the config's dtype and the
    router in fp32."""
    jcfg, tcfg = _cfgs(dtype)
    jparams = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    carried = ttf.params_from_jax(_np(jparams), tcfg, device="cpu")
    own = ttf.init_lm(tcfg, seed=0, device="cpu")
    assert _flat(own) == _flat(carried)
    layers = carried["layers"]
    assert len(layers) == tcfg.n_layers == 1 + tcfg.n_periods
    assert "mlp" in layers[0] and all("moe" in lp for lp in layers[1:])
    assert layers[0]["mlp"]["wi"]["w"].shape == (tcfg.d_model, tcfg.first_dense_ff)
    np.testing.assert_array_equal(
        layers[0]["attn"]["wkv_b"]["w"].float().numpy(),
        np.asarray(jparams["first"][0]["attn"]["wkv_b"]["w"], np.float32))
    for n, lp in enumerate(layers[1:]):
        assert lp["attn"]["kv_norm"]["scale"].dtype == DTYPES[dtype][1]
        assert lp["moe"]["router"]["w"].dtype == torch.float32
        np.testing.assert_array_equal(
            lp["attn"]["wq"]["w"].float().numpy(),
            np.asarray(jparams["periods"]["sub0"]["attn"]["wq"]["w"][n], np.float32))


# -------------------------------------------------------- chunked attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [7, 16, 40, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax(dtype, chunk, causal):
    """GQA 4:1, dv != d, Sq < Skv with a q offset; chunks that cut the
    keys unevenly, one chunk, and a chunk wider than the keys."""
    rng = np.random.default_rng(chunk + causal)
    jq, tq = _pair(rng, (2, 8, 9, 48), dtype)
    jk, tk = _pair(rng, (2, 2, 40, 48), dtype)
    jv, tv = _pair(rng, (2, 2, 40, 32), dtype)
    want = jlayers.chunked_attention(jq, jk, jv, causal=causal, q_offset=31,
                                     chunk=chunk)
    got = tlayers.chunked_attention(tq, tk, tv, causal=causal, q_offset=31,
                                    chunk=chunk)
    assert got.dtype == tq.dtype
    _close(got, want, _attn_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos,s", [(0, 1), (23, 1), (63, 1), (20, 4)])
def test_chunked_attention_device_position_gqa_16_to_1(dtype, pos, s):
    """The absorbed decode's shape at small width: 16 q heads over one kv
    head, keys 40 wide, values 32; ``q_offset`` and ``kv_valid_len`` 0-d
    tensors over a cache of 64 whose tail is noise."""
    rng = np.random.default_rng(pos * 7 + s)
    jq, tq = _pair(rng, (2, 16, s, 40), dtype)
    jk, tk = _pair(rng, (2, 1, 64, 40), dtype)
    jv, tv = _pair(rng, (2, 1, 64, 32), dtype)
    want = jlayers.chunked_attention(jq, jk, jv, causal=True,
                                     q_offset=jnp.int32(pos),
                                     kv_valid_len=jnp.int32(pos + s), chunk=24)
    p = torch.tensor(pos, dtype=torch.int32)
    got = tlayers.chunked_attention(tq, tk, tv, causal=True, q_offset=p,
                                    kv_valid_len=p + s, chunk=24)
    _close(got, want, _attn_tol(dtype))


def test_chunked_attention_masks_without_a_nan():
    """A row whose every key is masked (valid length 0) gives zeros, as the
    reference's guard gives, not NaN."""
    q, k, v = torch.ones(1, 2, 1, 8), torch.ones(1, 1, 5, 8), torch.ones(1, 1, 5, 4)
    out = tlayers.chunked_attention(q, k, v, causal=False,
                                    kv_valid_len=torch.tensor(0), chunk=2)
    assert torch.equal(out, torch.zeros(1, 2, 1, 4))


# ------------------------------------------------------- narrow-v flash
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 4, 10, 48, 32), (1, 16, 33, 192, 128)],
                         ids=["smoke", "full-head-dims"])
def test_flash_with_narrow_v_matches_chunked_attention(dtype, shape):
    """`ops.gqa_flash_attention` pads v to q's width and slices the output
    back: against the reference's `chunked_attention`, which takes dv != d
    as it is (on the CPU the flash kernel's plain version)."""
    b, h, s, d, dv = shape
    rng = np.random.default_rng(d)
    jq, tq = _pair(rng, (b, h, s, d), dtype)
    jk, tk = _pair(rng, (b, h, s, d), dtype)
    jv, tv = _pair(rng, (b, h, s, dv), dtype)
    want = jlayers.chunked_attention(jq, jk, jv, causal=True)
    got = tops.gqa_flash_attention(tq, tk, tv, causal=True)
    assert got.shape == (b, h, s, dv) and got.dtype == tq.dtype
    _close(got, want, _attn_tol(dtype))


def test_flash_with_narrow_v_device_position(monkeypatch):
    """With a device position over a cache: v reaches the kernel padded
    to d, the output is dv wide and equals the reference's."""
    seen = {}
    real_run = launch.run

    def spy(plan, *ops, **extra):
        seen.update(v=tuple(ops[2].shape), body=plan.body)
        return real_run(plan, *ops, **extra)

    monkeypatch.setattr(launch, "run", spy)
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng, (2, 4, 3, 48), "float32")
    jk, tk = _pair(rng, (2, 4, 50, 48), "float32")
    jv, tv = _pair(rng, (2, 4, 50, 32), "float32")
    want = jlayers.chunked_attention(jq, jk, jv, causal=True,
                                     q_offset=jnp.int32(20),
                                     kv_valid_len=jnp.int32(23))
    p = torch.tensor(20, dtype=torch.int32)
    got = tops.gqa_flash_attention(tq, tk, tv, q_offset=p, kv_valid_len=p + 3)
    assert seen == {"v": (8, 50, 48), "body": "split_kv"}
    _close(got, want, _attn_tol("float32"))


def test_flash_wrapper_refuses_a_wider_v():
    q = torch.zeros(1, 2, 4, 32)
    with pytest.raises(ValueError, match="v 48 wide"):
        tops.gqa_flash_attention(q, q, torch.zeros(1, 2, 4, 48))


def test_flash_plan_at_mla_prefill_shapes():
    """MLA's prefill at full width (B 4 x 16 heads, 1024 tokens, d 192)
    runs at the built head dim 256: tc_bf16 in bf16, cuda_core in fp32
    (tc_3xtf32 stops at 128), the padded copies as device scratch; the
    word-count certificate passes at the logical d."""
    for dtype, body in ((torch.bfloat16, "tc_bf16"), (torch.float32, "cuda_core")):
        plan = tflash.flash_launch_plan(bh=64, sq=1024, skv=1024, d=192,
                                        dtype=dtype)
        assert plan.body == body
        assert tflash.built_head_dim(192) == 256
        padded = {s.name: s.shape for s in plan.scratch if s.name.endswith("_padded")}
        assert padded == {"q_padded": (64, 1024, 256), "k_padded": (64, 1024, 256),
                          "v_padded": (64, 1024, 256)}
        tcheck.preflight_flash_dataflow(64, 1024, 1024, 192, dtype=dtype)


# ---------------------------------------------------------------- mla_apply
def _layer_params(jcfg, tcfg, seed=0):
    """The reference's `mla_init` and the same weights on the port."""
    jp = jlayers.mla_init(jax.random.PRNGKey(seed), jcfg)
    dt = DTYPES[tcfg.dtype][1]
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(dt),
                      jp)
    return jp, tp


def _close_cache(tc, jc, dtype, what):
    buf = tc[tlayers.MLA_CACHE]
    lora = jc["latent"].shape[-1]
    _close(buf[..., :lora], jc["latent"], MODEL_TOL[dtype], f"{what}: latent")
    _close(buf[..., lora:], jc["k_pe"], MODEL_TOL[dtype], f"{what}: k_pe")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_apply_expanded_without_a_cache(dtype):
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _layer_params(jcfg, tcfg)
    jx, tx = _pair(np.random.default_rng(0), (B, S, tcfg.d_model), dtype)
    want, _ = jlayers.mla_apply(jp, jx, jcfg, positions=jnp.arange(S))
    got, cache = tlayers.mla_apply(tp, tx, tcfg, positions=torch.arange(S))
    assert cache is None and got.dtype == tx.dtype
    _close(got, want, MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("where", ["host", "device"])
def test_mla_apply_prefill_then_absorbed_decode(dtype, where):
    """A prefill of N_PREFILL tokens into a cache of S at start 0
    (expanded form), then one token a step (absorbed form): outputs and
    both cache slices against the reference's. ``where`` says how the
    decode steps get their position: ``start`` on the host, or the
    cache's position as a 0-d tensor."""
    jcfg, tcfg = _cfgs(dtype)
    jp, tp = _layer_params(jcfg, tcfg, seed=1)
    jx, tx = _pair(np.random.default_rng(1), (B, S, tcfg.d_model), dtype)
    jc = jlayers.init_mla_cache(jcfg, B, S)
    tc = tlayers.init_mla_cache(tcfg, B, S, torch.device("cpu"))
    want, jc = jlayers.mla_apply(jp, jx[:, :N_PREFILL], jcfg,
                                 positions=jnp.arange(N_PREFILL), cache=jc,
                                 cache_pos=jnp.int32(0))
    got, tc = tlayers.mla_apply(tp, tx[:, :N_PREFILL], tcfg,
                                positions=torch.arange(N_PREFILL), cache=tc,
                                cache_pos=torch.tensor(0, dtype=torch.int32),
                                start=0)
    _close(got, want, MODEL_TOL[dtype], "prefill")
    _close_cache(tc, jc, dtype, "prefill")
    for i in range(N_PREFILL, S):
        want, jc = jlayers.mla_apply(jp, jx[:, i:i + 1], jcfg,
                                     positions=jnp.arange(i, i + 1), cache=jc,
                                     cache_pos=jnp.int32(i))
        pos = torch.tensor(i, dtype=torch.int32)
        got, tc = tlayers.mla_apply(
            tp, tx[:, i:i + 1], tcfg, positions=pos + torch.arange(1), cache=tc,
            cache_pos=pos, start=i if where == "host" else None)
        _close(got, want, MODEL_TOL[dtype], f"decode {i}")
    _close_cache(tc, jc, dtype, "decode")


def test_mla_decode_takes_the_absorbed_form(monkeypatch):
    """One token with a cache runs `chunked_attention` over one kv head of
    kv_lora + qk_rope with the latent as values, and never the flash
    kernel; a prefill runs the flash kernel with v of v_head."""
    _, tcfg = _cfgs()
    m = tcfg.mla
    tp = tlayers.mla_init(torch.Generator().manual_seed(2), tcfg, torch.device("cpu"))
    calls = []
    real_chunked, real_flash = tlayers.chunked_attention, tops.gqa_flash_attention

    def chunked(q, k, v, **kw):
        calls.append(("chunked", q.shape, k.shape, v.shape))
        return real_chunked(q, k, v, **kw)

    def flash(q, k, v, **kw):
        calls.append(("flash", q.shape, k.shape, v.shape))
        return real_flash(q, k, v, **kw)

    monkeypatch.setattr(tlayers, "chunked_attention", chunked)
    monkeypatch.setattr(tops, "gqa_flash_attention", flash)
    cache = tlayers.init_mla_cache(tcfg, 1, 6, torch.device("cpu"))
    x = torch.randn(1, 6, tcfg.d_model, generator=torch.Generator().manual_seed(3))
    h, dq = tcfg.n_heads, m.qk_nope + m.qk_rope
    tlayers.mla_apply(tp, x[:, :5], tcfg, positions=torch.arange(5), cache=cache,
                      cache_pos=torch.tensor(0, dtype=torch.int32), start=0)
    pos = torch.tensor(5, dtype=torch.int32)
    tlayers.mla_apply(tp, x[:, 5:], tcfg, positions=pos + torch.arange(1),
                      cache=cache, cache_pos=pos)
    assert calls == [
        ("flash", (1, h, 5, dq), (1, h, 5, dq), (1, h, 5, m.v_head)),
        ("chunked", (1, h, 1, m.kv_lora + m.qk_rope),
         (1, 1, 6, m.kv_lora + m.qk_rope), (1, 1, 6, m.kv_lora))]


def test_mla_cache_overflow_raises_before_writing():
    _, tcfg = _cfgs()
    tp = tlayers.mla_init(torch.Generator().manual_seed(4), tcfg, torch.device("cpu"))
    cache = tlayers.init_mla_cache(tcfg, 1, 4, torch.device("cpu"))
    zero = torch.tensor(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="5 tokens do not fit a cache of 4"):
        tlayers.mla_apply(tp, torch.ones(1, 5, tcfg.d_model), tcfg,
                          positions=torch.arange(5), cache=cache, cache_pos=zero)
    with pytest.raises(ValueError,
                       match="3 tokens at position 2 do not fit a cache of 4"):
        tlayers.mla_apply(tp, torch.ones(1, 3, tcfg.d_model), tcfg,
                          positions=torch.arange(2, 5), cache=cache,
                          cache_pos=zero + 2, start=2)
    assert not cache[tlayers.MLA_CACHE].any()


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_forward_logits_and_aux_match_jax(dtype, impl):
    jcfg, tcfg = _cfgs(dtype, impl=impl)
    jparams = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = ttf.params_from_jax(_np(jparams), tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S))
    want, _, jaux = jtf.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32))
    with torch.inference_mode():
        got, _, aux = ttf.forward(tparams, tcfg, torch.from_numpy(toks))
    assert got.shape == (B, S, tcfg.padded_vocab) and got.dtype == DTYPES[dtype][1]
    _close(got, want, MODEL_TOL[dtype], "logits")
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), **MODEL_TOL[dtype])


@pytest.mark.parametrize("impl", ["ragged", "capacity"])
def test_prefill_and_decode_match_a_full_forward(impl):
    """fp32, the reference's `test_prefill_decode_matches_full_forward` on
    the port alone: prefill of N_PREFILL tokens (expanded MLA), then one
    absorbed decode step a token, against one expanded forward over all
    S (capacity: no drop at T <= 64)."""
    _, tcfg = _cfgs("float32", impl=impl)
    params = ttf.init_lm(tcfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab, (B, S)))
    with torch.inference_mode():
        full, _, _ = ttf.forward(params, tcfg, toks)
        caches = ttf.init_caches(tcfg, B, S, device="cpu")
        assert ttf.cache_capacity(caches) == S
        pre, caches, _ = ttf.forward(params, tcfg, toks[:, :N_PREFILL],
                                     caches=caches, start=0)
        torch.testing.assert_close(pre[:, -1], full[:, N_PREFILL - 1],
                                   **MODEL_TOL["float32"])
        for i in range(N_PREFILL, S):
            step, caches, _ = ttf.forward(params, tcfg, toks[:, i:i + 1],
                                          caches=caches)
            torch.testing.assert_close(step[:, 0], full[:, i], **MODEL_TOL["float32"])
        assert int(caches["pos"]) == S


def test_compiled_steps_on_a_stub_graph(monkeypatch):
    """The compiled steps over the latent cache, on stub graphs that re-run
    the captured function at each replay: the static cache's buffers are
    zeroed by each prefill, listed in `graph._cache_buffers`, and every step
    equals the eager step bit for bit; the capacity check reads the latent
    buffer."""
    def capture(fn, device):
        out = fn()

        class Stub:
            def replay(self):
                with launch.recording():
                    res = fn()
                out.copy_(res)
        return Stub(), out

    monkeypatch.setattr(graph, "_captures", lambda device: True)
    monkeypatch.setattr(graph, "_warm_up", lambda fn, device: fn())
    monkeypatch.setattr(graph, "_capture", capture)
    _, tcfg = _cfgs()
    params = ttf.init_lm(tcfg, seed=5, device="cpu")
    rng = np.random.default_rng(9)
    eager_prefill = tsteps.make_prefill_step(tcfg, 8)
    eager_decode = tsteps.make_decode_step(tcfg)
    prefill = graph.compile_prefill(tsteps.make_prefill_step(tcfg, 8))
    decode = graph.compile_decode(tsteps.make_decode_step(tcfg))
    with torch.inference_mode():
        for n in (6, 4):
            prompt = torch.from_numpy(rng.integers(0, tcfg.vocab, (2, n)))
            logits, caches = prefill(params, {"tokens": prompt})
            want, want_caches = eager_prefill(params, {"tokens": prompt})
            assert torch.equal(logits, want)
            buffers = graph._cache_buffers(caches)
            assert len(buffers) == 1 + tcfg.n_layers
            assert all(tlayers.MLA_CACHE in c for c in caches["layers"])
            tok = prompt[:, :1]
            for _ in range(8 - n):
                logits, caches = decode(params, caches, tok)
                want, want_caches = eager_decode(params, want_caches, tok)
                assert torch.equal(logits, want)
                tok = torch.argmax(logits, -1)[:, None]
            for got, ref_t in zip(graph._cache_buffers(caches),
                                  graph._cache_buffers(want_caches), strict=True):
                assert torch.equal(got, ref_t)
            with pytest.raises(ValueError, match="do not fit a cache of 8"):
                decode(params, caches, tok)
