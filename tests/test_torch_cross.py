"""Cross-attention, the encoder and the modality inputs of the port against
the reference package, on the CPU at `get_smoke` size: Llama-3.2-Vision
(four self-attention layers and a ``"cross"`` layer a period, over stubbed
vision tokens) and SeamlessM4T (an encoder over stubbed frames, then
``"attn+cross"`` decoder layers).

The reference's own weights (JAX `init_lm`) are carried across with
`params_from_jax`, every cross-attention ``gate`` set first to a seeded
nonzero value in both packages: the reference initialises it to 0, and
tanh(0) = 0 would hide cross-attention from every comparison. Inputs come
from numpy seeds; the extras from `make_extra_inputs` of each package on the
same seed. Tolerances: attention fp32 2e-4 (the reference's flash
tolerance); the model fp32 rtol = atol = 2e-4, bf16 rtol 5e-2, atol 8e-2
(tests/test_torch_models.py). Caches are read in the reference's layout,
(B, L, Hkv, hd)."""

import dataclasses
import importlib.util
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.data.pipeline import make_extra_inputs as jmake_extra_inputs
from repro.models import layers as jlayers
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import check
from repro_torch import configs as tconfigs
from repro_torch.data import make_extra_inputs
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import launch
from repro_torch.kernels import ops as tops
from repro_torch.launch import graph
from repro_torch.models import layers as tlayers
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf
from test_torch_compiled_step import _no_host_reads, stub_graphs  # noqa: F401

ARCHS = ("llama-3.2-vision-90b", "seamless-m4t-large-v2")
ATTN_TOL = dict(rtol=2e-4, atol=2e-4)
MODEL_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
             "bfloat16": dict(rtol=5e-2, atol=8e-2)}
B, PROMPT, DECODES = 2, 8, 4
MAX_LEN = PROMPT + DECODES


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _with_gates(tree, seed: int):
    """The reference's tree with every cross-attention ``gate`` (stacked
    over periods: one per period) drawn from U(0.3, 1.0)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (jnp.asarray(rng.uniform(0.3, 1.0, np.shape(v)), v.dtype)
                        if k == "gate" else walk(v)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    return walk(tree)


def _configs(arch: str, dtype: str):
    return (dataclasses.replace(jget_smoke(arch), dtype=dtype),
            dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype))


def _weights(jcfg, tcfg, seed: int = 0):
    jparams = _with_gates(jtf.init_lm(jax.random.PRNGKey(seed), jcfg), seed + 1)
    return jparams, ttf.params_from_jax(_np(jparams), tcfg, device="cpu")


def _extras(jcfg, tcfg, seq_len: int, seed: int):
    return (jmake_extra_inputs(jcfg, B, seq_len, np.random.default_rng(seed)),
            make_extra_inputs(tcfg, B, seq_len, np.random.default_rng(seed),
                              device="cpu"))


def _close(got, want, tol, what=""):
    assert tuple(got.shape) == tuple(np.shape(want)), what
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               err_msg=what, **tol)


def _close_caches(tc, jc, dtype, what):
    """The port's flat list of layer caches against the reference's
    ``periods["sub{i}"]`` stacked over periods: (k, v) of self-attention,
    the cross keys and values of a cross layer, both in an "attn+cross"
    layer."""
    assert int(tc["pos"]) == int(jc["pos"]), what
    n_sub = len(jc["periods"])
    for n, layer in enumerate(tc["layers"]):
        want = jc["periods"][f"sub{n % n_sub}"]
        pairs = []
        if "self" in want:
            pairs += [(layer[name], want["self"][name]) for name in ("k", "v")]
        if "cross" in want:
            pairs += [(layer[tlayers.CROSS_K], want["cross"]["k"]),
                      (layer[tlayers.CROSS_V], want["cross"]["v"])]
        assert len(pairs) == len(layer), what
        for got, w in pairs:
            _close(got.transpose(1, 2), w[n // n_sub], MODEL_TOL[dtype],
                   f"{what}: layer {n}")


# ------------------------------------------------------------ inputs, config
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_extra_inputs_bit_for_bit(arch, dtype):
    """The same draws in the same order (frames, then vision_ctx), rounded
    from float32 to the config's dtype: the reference's bits; none for a
    dense arch, so its stream is unchanged."""
    jcfg, tcfg = _configs(arch, dtype)
    want, got = _extras(jcfg, tcfg, 40, seed=3)
    assert set(got) == set(want) == {"frames" if jcfg.encoder else "vision_ctx"}
    for name, w in want.items():
        t = got[name]
        assert t.dtype == getattr(torch, dtype) and t.device.type == "cpu"
        assert np.array_equal(t.float().numpy(), np.asarray(w, np.float32)), name
    rng = np.random.default_rng(5)
    assert make_extra_inputs(tconfigs.get_smoke("qwen2-1.5b"), B, 40, rng,
                             device="cpu") == {}
    assert rng.integers(0, 1 << 30) == np.random.default_rng(5).integers(0, 1 << 30)


def test_make_extra_inputs_on_a_missing_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_extra_inputs(tconfigs.get_smoke(ARCHS[0]), B, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_matches_jax_at_full_width(arch):
    """On the meta device: the full configs, and Llama-3.2-Vision at the 5
    of its 20 periods that the card holds."""
    cfg, jcfg = tconfigs.get_config(arch), jget_config(arch)
    assert ttf.count_params(cfg) == jtf.count_params(jcfg)
    if arch == "llama-3.2-vision-90b":
        assert ttf.count_params(cfg) == 87_666_794_516
        cut = dataclasses.replace(cfg, n_periods=5)
        assert ttf.count_params(cut) == jtf.count_params(
            dataclasses.replace(jcfg, n_periods=5)) == 23_492_714_501
    else:
        assert ttf.count_params(cfg) == 1_633_407_000


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_every_leaf(arch):
    """Every leaf of the reference's tree reaches the port's, value for
    value: each layer's ``cross`` (the 0-d gate included) and
    ``norm_cross``, the encoder's ``enc_proj``, ``enc_periods`` unstacked
    into ``enc_layers`` and ``enc_norm``; and the structure is `init_lm`'s,
    with the gate zero at init as in the reference."""
    jcfg, tcfg = _configs(arch, "float32")
    jparams, tparams = _weights(jcfg, tcfg, seed=6)
    jp = _np(jparams)
    n_sub = len(jcfg.period_layout)
    for n, layer in enumerate(tparams["layers"]):
        want = jp["periods"][f"sub{n % n_sub}"]
        assert set(layer) == set(want)
        for key in ("cross", "norm_cross", "attn"):
            for name, t in _flat(layer.get(key, {})).items():
                w = _get(want[key], name)[n // n_sub]
                assert np.array_equal(t.numpy(), w), (n, key, name)
        if "cross" in layer:
            assert layer["cross"]["gate"].shape == ()
            assert layer["cross"]["gate"].item() != 0
    if jcfg.encoder:
        assert len(tparams["enc_layers"]) == jcfg.encoder.n_layers
        for n, layer in enumerate(tparams["enc_layers"]):
            for name, t in _flat(layer).items():
                assert np.array_equal(
                    t.numpy(), _get(jp["enc_periods"]["sub0"], name)[n]), name
        for key in ("enc_proj", "enc_norm"):
            for name, t in _flat(tparams[key]).items():
                assert np.array_equal(t.numpy(), _get(jp[key], name))
    else:
        assert "enc_layers" not in tparams
    own = ttf.init_lm(tcfg, seed=0, device="cpu")
    shapes = {k: (tuple(t.shape), t.dtype) for k, t in _flat(own).items()}
    assert shapes == {k: (tuple(t.shape), t.dtype)
                      for k, t in _flat(tparams).items()}
    assert all(t.item() == 0 for k, t in _flat(own).items()
               if k.endswith("/gate"))


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _get(tree, path: str):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


# ------------------------------------------------------------------ layers
def _spy_runs(monkeypatch) -> list:
    """The plans of every `launch.run` call from now on, in order."""
    seen = []
    real_run = launch.run

    def spy(plan, *ops, **extra):
        seen.append((plan, extra))
        return real_run(plan, *ops, **extra)

    monkeypatch.setattr(launch, "run", spy)
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attn_apply_matches_jax(arch, monkeypatch):
    """A cross layer's attention, fp32: with memory (a prefill: the cross
    keys and values written in place into the cache, head-major), then
    from the cache alone (a decode step, one query: the valid length on the
    device, split_kv), each against the reference's ``attn_apply(cross=
    True)``, the gate nonzero; the port's is `cross_apply`."""
    jcfg, tcfg = _configs(arch, "float32")
    jparams, tparams = _weights(jcfg, tcfg, seed=2)
    sub = next(i for i, (m, _) in enumerate(jcfg.period_layout) if "cross" in m)
    jp = jax.tree.map(lambda a: a[0], jparams["periods"][f"sub{sub}"]["cross"])
    tp = tparams["layers"][sub]["cross"]
    rng = np.random.default_rng(4)
    sm = 144                                    # ragged: 144 % 128 != 0
    x = rng.standard_normal((B, 6, jcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, sm, jcfg.d_model)).astype(np.float32)
    pos = jnp.arange(6)
    jc = jlayers.init_cross_cache(jcfg, B, sm)
    want, jc = jlayers.attn_apply(jp, jnp.asarray(x), jcfg, positions=pos,
                                  cache=jc, memory=jnp.asarray(mem), cross=True)
    tc = tlayers.init_cross_cache(tcfg, B, sm, torch.device("cpu"))
    bufs = (tc[tlayers.CROSS_K], tc[tlayers.CROSS_V])
    with torch.inference_mode():
        got, tc = tlayers.cross_apply(tp, torch.from_numpy(x), tcfg, cache=tc,
                                      memory=torch.from_numpy(mem))
    _close(got, want, ATTN_TOL, "with memory")
    assert tc[tlayers.CROSS_K] is bufs[0] and tc[tlayers.CROSS_V] is bufs[1]
    _close(tc[tlayers.CROSS_K].transpose(1, 2), jc["k"], ATTN_TOL, "cross k")
    _close(tc[tlayers.CROSS_V].transpose(1, 2), jc["v"], ATTN_TOL, "cross v")
    assert np.abs(np.asarray(want)).max() > 1e-2   # the gate lets it through

    x1 = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    want, _ = jlayers.attn_apply(jp, jnp.asarray(x1), jcfg, positions=pos[:1],
                                 cache=jc, cross=True)
    seen = _spy_runs(monkeypatch)
    with torch.inference_mode():
        got, _ = tlayers.cross_apply(tp, torch.from_numpy(x1), tcfg, cache=tc)
    _close(got, want, ATTN_TOL, "from the cache")
    assert [(plan.body, "pos" in extra) for plan, extra in seen] \
        == [("split_kv", True)]


def test_cross_attn_apply_refusals():
    cfg = tconfigs.get_smoke(ARCHS[0])
    p = tlayers.attn_init(torch.Generator().manual_seed(0), cfg,
                           torch.device("cpu"), cross=True)
    x = torch.zeros(B, 3, cfg.d_model, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="needs the cross cache"):
        tlayers.cross_apply(p, x, cfg)
    cache = tlayers.init_cross_cache(cfg, B, 16, torch.device("cpu"))
    with pytest.raises(ValueError, match="memory of 8 keys"):
        tlayers.cross_apply(p, x, cfg, cache=cache,
                            memory=torch.zeros_like(x[:, :1]).expand(B, 8, -1))


@pytest.mark.parametrize("skv", [64, 128, 200, 256, 1000])
def test_ragged_non_causal_attention_runs_as_causal_at_offset_skv(skv, monkeypatch):
    """The launch pre-flight refuses a non-causal launch whose keys it
    would pad (the reference's RPC031, kept); `ops.gqa_flash_attention`
    serves it as a causal launch at q_offset = Skv, whose mask hides the
    pad, and matches the reference's non-causal ``chunked_attention``."""
    rng = np.random.default_rng(skv)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, 4, 40, 32), (B, 2, skv, 32), (B, 2, skv, 32)))
    want = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=False, chunk=128)
    seen = _spy_runs(monkeypatch)
    got = tops.gqa_flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=False)
    _close(got, want, ATTN_TOL, f"skv {skv}")
    assert seen[0][0].inputs[1].array_shape[1] == skv + (-skv) % min(128, skv)
    if skv > 128 and skv % 128:
        with pytest.raises(check.CheckError, match="not a multiple of bk"):
            tflash.flash_attention(torch.from_numpy(q).reshape(B * 4, 40, 32),
                                   torch.from_numpy(k).reshape(B * 2, skv, 32),
                                   torch.from_numpy(v).reshape(B * 2, skv, 32),
                                   causal=False)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _softmax_av(q, k, v, *, drop=None):
    """Attention in fp32 with P rounded to bf16 before P @ V, as tc_bf16
    rounds it; the keys ``drop`` left out; bf16 out."""
    s = q.float() @ k.float().transpose(1, 2) / math.sqrt(q.shape[-1])
    if drop is not None:
        s[:, :, drop] = -math.inf
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    return ((p.bfloat16().float() @ v.float()) / l).bfloat16()


@pytest.mark.parametrize("case", ["bf16 rounding", "unmasked pad", "dropped block"])
def test_cross_flash_limits_catch_a_pad_or_a_dropped_block(case):
    """chip_smoke.py's phase 4k limits at its ragged non-causal shape (1000
    queries over 1000 keys, d 64, fewer heads): the plain version's output
    (causal at q_offset 1000, the 24 padded keys masked) against attention
    that rounds P to bf16 as tc_bf16 does passes; the same with the 24
    padded zero keys left in the softmax, or with a block of 128 keys
    dropped, fails."""
    smoke = _chip_smoke()
    gen = torch.Generator().manual_seed(29)
    bh, skv, d = 8, 1000, 64
    q, k, v = (torch.randn(bh, skv, d, generator=gen).bfloat16() for _ in range(3))
    fp = tflash.flash_launch_plan(bh=bh, sq=skv, skv=skv, d=d, kv_group=1,
                                  dtype=torch.bfloat16, causal=True, q_offset=skv)
    qp, kp, vp = (torch.nn.functional.pad(t, (0, 0, 0, spec.array_shape[1] - skv))
                  for t, spec in zip((q, k, v), fp.inputs))
    want = fp.plain(qp, kp, vp)[:, :skv]
    if case == "bf16 rounding":
        got = _softmax_av(q, k, v)
    elif case == "unmasked pad":
        assert kp.shape[1] == 1024
        got = _softmax_av(q, kp, vp)
    else:
        got = _softmax_av(q, k, v, drop=slice(128, 256))
    why = smoke.flash_disagreement(torch, got, want)
    assert (why is None) == (case == "bf16 rounding"), why


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("s_enc", [64, 200])
def test_encode_matches_jax(s_enc):
    """SeamlessM4T's encoder, fp32: ``enc_proj``, two non-causal
    self-attention layers (rope at 0 .. S_enc - 1) and ``enc_norm``; at 200
    frames the flash path pads the keys and is not refused."""
    jcfg, tcfg = _configs(ARCHS[1], "float32")
    jparams, tparams = _weights(jcfg, tcfg, seed=7)
    jx, tx = _extras(jcfg, tcfg, s_enc, seed=8)
    want = jtf.encode(jparams, jcfg, jx["frames"])
    launch.reset_launches()
    with torch.inference_mode():
        got = ttf.encode(tparams, tcfg, tx["frames"])
    assert got.shape == (B, s_enc, tcfg.d_model)
    _close(got, want, MODEL_TOL["float32"], f"encode at {s_enc}")
    assert launch.LAUNCHES == {}        # the CPU runs the plain versions


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_memory_matches_jax(arch, dtype):
    """The whole smoke model over the memory (the encoder's output or the
    vision tokens), with no cache, logits against the reference's; the
    memory changes them (the gates are nonzero)."""
    jcfg, tcfg = _configs(arch, dtype)
    jparams, tparams = _weights(jcfg, tcfg, seed=9)
    jx, tx = _extras(jcfg, tcfg, 72, seed=10)
    toks = np.random.default_rng(11).integers(0, jcfg.vocab, (B, 10))
    jmem = jsteps._memory_from_batch(jcfg, jparams, jx, None)
    want, _, _ = jtf.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32),
                             memory=jmem)
    with torch.inference_mode():
        tmem = tsteps._memory_from_batch(tcfg, tparams, tx)
        _close(tmem, jmem, MODEL_TOL[dtype], "memory")
        got, caches, aux = ttf.forward(tparams, tcfg, torch.from_numpy(toks),
                                       memory=tmem)
        other, _, _ = ttf.forward(tparams, tcfg, torch.from_numpy(toks),
                                  memory=2 * tmem)
    assert caches is None and float(aux) == 0
    assert got.shape == (B, 10, tcfg.padded_vocab)
    assert got.dtype == tlayers.dtype_of(tcfg)
    _close(got, want, MODEL_TOL[dtype], "logits")
    assert not torch.equal(got, other)


def test_a_zero_gate_hides_cross_attention():
    """The reference's init: with every gate 0, the logits do not depend on
    the vision tokens, which is why every comparison here sets them."""
    cfg = dataclasses.replace(tconfigs.get_smoke(ARCHS[0]), dtype="float32")
    params = ttf.init_lm(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(12).integers(0, cfg.vocab, (B, 6)))
    mem = make_extra_inputs(cfg, B, 6, np.random.default_rng(13),
                            device="cpu")["vision_ctx"]
    with torch.inference_mode():
        a = ttf.forward(params, cfg, toks, memory=mem)[0]
        b = ttf.forward(params, cfg, toks, memory=2 * mem)[0]
        assert torch.equal(a, b)
        for layer in params["layers"]:
            if "cross" in layer:
                layer["cross"]["gate"].fill_(0.5)
        c = ttf.forward(params, cfg, toks, memory=mem)[0]
        d = ttf.forward(params, cfg, toks, memory=2 * mem)[0]
    assert not torch.equal(c, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_steps_and_greedy_generate_match_jax(arch, dtype):
    """The prefill step (the encoder inside it for seamless, the cross
    caches filled) and teacher-forced decode steps (no memory: the cross
    caches read) against ``jax.jit`` of the reference's, logits and caches;
    then the greedy tokens against the reference's steps' argmax, token for
    token."""
    jcfg, tcfg = _configs(arch, dtype)
    jparams, tparams = _weights(jcfg, tcfg, seed=14)
    jx, tx = _extras(jcfg, tcfg, PROMPT, seed=15)
    toks = np.random.default_rng(16).integers(0, jcfg.vocab, (B, MAX_LEN))
    jprefill = jax.jit(jsteps.make_prefill_step(jcfg, MAX_LEN))
    jdecode = jax.jit(jsteps.make_decode_step(jcfg))
    prefill = graph.compile_prefill(tsteps.make_prefill_step(tcfg, MAX_LEN))
    decode = graph.compile_decode(tsteps.make_decode_step(tcfg))
    jlogits, jc = jprefill(jparams, {"tokens": jnp.asarray(toks[:, :PROMPT],
                                                           jnp.int32), **jx})
    with torch.inference_mode():
        tlogits, tc = prefill(tparams, {"tokens": torch.from_numpy(toks[:, :PROMPT]),
                                        **tx})
        _close(tlogits, jlogits, MODEL_TOL[dtype], "prefill logits")
        _close_caches(tc, _np(jc), dtype, "prefill caches")
        for i in range(PROMPT, MAX_LEN):
            jlogits, jc = jdecode(jparams, jc, jnp.asarray(toks[:, i:i + 1], jnp.int32))
            tlogits, tc = decode(tparams, tc, torch.from_numpy(toks[:, i:i + 1]))
            _close(tlogits, jlogits, MODEL_TOL[dtype], f"decode {i} logits")
        _close_caches(tc, _np(jc), dtype, "decode caches")
        assert tc[graph.HOST_POS] == MAX_LEN
    if dtype == "bfloat16":
        return                      # near-ties make bf16 argmaxes differ
    jlogits, jc = jprefill(jparams, {"tokens": jnp.asarray(toks[:, :PROMPT],
                                                           jnp.int32), **jx})
    want = [jnp.argmax(jlogits, -1)[:, None]]
    for _ in range(DECODES - 1):
        jlogits, jc = jdecode(jparams, jc, want[-1])
        want.append(jnp.argmax(jlogits, -1)[:, None])
    with torch.inference_mode():
        got = tsteps.greedy_generate(tcfg, tparams, torch.from_numpy(toks[:, :PROMPT]),
                                     DECODES, MAX_LEN, extras=tx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.concatenate(want, 1)))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_capacity_reads_self_attention(arch):
    """The capacity is the self-attention cache's, never the memory's, and a
    cross layer's cache is one flat dict of its two buffers."""
    cfg = tconfigs.get_smoke(arch)
    caches = ttf.init_caches(cfg, B, 9, mem_len=30, device="cpu")
    assert ttf.cache_capacity(caches) == 9
    for (mixer, _), c in zip(ttf.layer_kinds(cfg), caches["layers"]):
        names = {"attn": {"k", "v"}, "cross": {tlayers.CROSS_K, tlayers.CROSS_V},
                 "attn+cross": {"k", "v", tlayers.CROSS_K, tlayers.CROSS_V}}[mixer]
        assert set(c) == names
        if tlayers.CROSS_K in c:
            assert c[tlayers.CROSS_K].shape == (B, cfg.n_kv_heads, 30, cfg.hd)
    assert len(graph._cache_buffers(caches)) == 1 + sum(len(c) for c in caches["layers"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_reads_nothing_on_the_host(arch):
    """The CPU's proxy for "capturable": a decode step that reads the cross
    caches reads no tensor value on the host."""
    cfg = tconfigs.get_smoke(arch)
    params = ttf.init_lm(cfg, seed=1, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(17).integers(0, cfg.vocab, (B, 5)))
    extras = make_extra_inputs(cfg, B, 5, np.random.default_rng(18), device="cpu")
    with torch.inference_mode():
        _, caches = tsteps.make_prefill_step(cfg, 9)(params, {"tokens": tokens,
                                                              **extras})
        with _no_host_reads():
            logits, new = tsteps.make_decode_step(cfg)(params, caches, tokens[:, :1])
    assert int(new["pos"]) == 6 and torch.isfinite(logits.float()).all()


# ------------------------------------------------------- the compiled steps
@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_prefill_follows_new_extras(arch, stub_graphs):
    """The compiled prefill copies the batch's frames or vision tokens into
    static buffers on every call: a second request with other extras gets
    its own logits and cross caches (equal to the eager step's bit for
    bit), not the captured request's; the graph is reused, and another
    memory length gets a graph and a static cache of its own. One compiled
    decode serves both memory lengths, each with its own graph, and goes
    back to the first one's."""
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype="float32")
    params = ttf.init_lm(cfg, seed=2, device="cpu")
    for layer in params["layers"]:
        if "cross" in layer:
            layer["cross"]["gate"].fill_(0.7)
    eager = tsteps.make_prefill_step(cfg, 12)
    prefill = graph.compile_prefill(tsteps.make_prefill_step(cfg, 12))
    decode = graph.compile_decode(tsteps.make_decode_step(cfg))
    rng = np.random.default_rng(19)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 8)))
    seen = []
    with torch.inference_mode():
        for seed, s_mem in ((20, 8), (21, 8), (22, 8), (23, 16), (24, 8)):
            extras = make_extra_inputs(cfg, B, s_mem, np.random.default_rng(seed),
                                       device="cpu")
            if not cfg.encoder:                 # vision tokens of the length
                extras = {"vision_ctx": extras["vision_ctx"][:, :s_mem]}
            logits, caches = prefill(params, {"tokens": tokens, **extras})
            want, want_caches = eager(params, {"tokens": tokens, **extras})
            assert torch.equal(logits, want)
            for got, w in zip(graph._cache_buffers(caches),
                              graph._cache_buffers(want_caches)):
                assert torch.equal(got, w)
            seen.append((logits, caches))
            step, _ = decode(params, caches, tokens[:, :1])
            want, _ = tsteps.make_decode_step(cfg)(params, want_caches, tokens[:, :1])
            assert torch.equal(step, want)
    assert not torch.equal(seen[0][0], seen[1][0])
    assert seen[0][1] is seen[1][1] is seen[2][1]        # one static cache
    assert seen[3][1] is not seen[0][1]                  # another memory length
    assert seen[4][1] is seen[0][1]
    assert len(prefill.graphs) == 2 and len(prefill.caches) == 2
    assert sorted(k[2] for k in decode.graphs) == [8, 16]
