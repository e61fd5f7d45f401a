"""The compiled serving step of the port on the CPU (`repro_torch.launch.graph`
and the device position it rests on), against the reference package.

- `gqa_flash_attention` with ``q_offset`` and ``kv_valid_len`` as tensors,
  over a cache larger than the valid keys, against the JAX
  `chunked_attention` with the same two values traced (fp32 2e-4, bf16
  3e-2, the reference's flash tolerances), and the cache reaching the
  kernel with no copy.
- The prefill and decode steps, logits and caches (read in the reference's
  layout), against ``jax.jit`` of the reference's `make_prefill_step` and
  `make_decode_step` (tests/test_torch_models.py's tolerances).
- A decode step reads no tensor value on the host: the CPU's proxy for
  "capturable as a CUDA graph"; the MoE smoke config's included.
- Decode past the capacity raises before anything is written.
- The graph bookkeeping (warm-up, capture, replay, launch counts, static
  caches, foreign buffers) against a stub graph that re-runs the captured
  function at each replay.

Inputs come from numpy seeds. Nothing here needs a GPU."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import layers as jlayers
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import launch
from repro_torch.kernels import ops as tops
from repro_torch.launch import graph
from repro_torch.models import layers as tlayers
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FLASH_TOL = {"float32": 2e-4, "bfloat16": 3e-2}
MODEL_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
             "bfloat16": dict(rtol=5e-2, atol=8e-2)}

# the attention case: 8 q heads over 2 kv heads, a cache of 200 keys that
# split_kv cuts into 4 ranges of 50
B, HQ, HKV, D, CAP = 2, 8, 2, 32, 200


def _pair(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, dtype=jd), torch.from_numpy(a).to(td)


def test_attention_case_cuts_the_cache_into_four_splits():
    plan = tflash.flash_launch_plan(bh=B * HQ, sq=1, skv=CAP, d=D,
                                    kv_group=HQ // HKV, device_pos=True)
    assert plan.body == "split_kv"
    assert plan.loops[1] == ("splits", 4)
    assert tflash.split_keys(hkv=B * HKV, rows=HQ // HKV, skv=CAP, d=D) == (4, 50)
    assert plan.inputs[1].array_shape == (B * HKV, CAP, D)   # not padded


@pytest.mark.parametrize("pos,s", [
    (0, 1),       # one valid key
    (10, 1),      # the valid length ends inside the first split
    (49, 1),      # ... at its end: splits 2-4 see no key
    (50, 1),      # one key in the second split
    (137, 1),
    (199, 1),     # the last slot
    (20, 4),      # four queries, GQA rows 4 x 4
    (196, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_flash_device_position_matches_chunked_attention(pos, s, dtype):
    rng = np.random.default_rng(pos * 10 + s)
    jq, tq = _pair(rng, (B, HQ, s, D), dtype)
    # keys past the valid length are noise: only the mask keeps them out
    jk, tk = _pair(rng, (B, HKV, CAP, D), dtype)
    jv, tv = _pair(rng, (B, HKV, CAP, D), dtype)
    want = jlayers.chunked_attention(jq, jk, jv, causal=True,
                                     q_offset=jnp.int32(pos),
                                     kv_valid_len=jnp.int32(pos + s), chunk=64)
    p = torch.tensor(pos, dtype=torch.int32)
    got = tops.gqa_flash_attention(tq, tk, tv, causal=True, q_offset=p,
                                   kv_valid_len=p + s)
    assert got.dtype == tq.dtype and got.shape == (B, HQ, s, D)
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_device_position_reaches_the_kernel_without_a_copy(monkeypatch):
    """The cache's (B, Hkv, cap, D) storage is what the launch gets, with
    the position as two int32 (q_offset, valid length)."""
    seen = {}
    real_run = launch.run

    def spy(plan, *ops, **extra):
        seen.update(k=ops[1], v=ops[2], body=plan.body, **extra)
        return real_run(plan, *ops, **extra)

    monkeypatch.setattr(launch, "run", spy)
    rng = np.random.default_rng(0)
    k, v = (torch.from_numpy(rng.standard_normal((B, HKV, CAP, D))
                             .astype(np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, HQ, 1, D)).astype(np.float32))
    p = torch.tensor(77, dtype=torch.int32)
    tops.gqa_flash_attention(q, k, v, q_offset=p, kv_valid_len=p + 1)
    assert seen["body"] == "split_kv"
    assert seen["k"].data_ptr() == k.data_ptr()
    assert seen["v"].data_ptr() == v.data_ptr()
    assert seen["pos"].dtype == torch.int32
    assert seen["pos"].tolist() == [77, 78]


def test_device_position_refusals():
    """More rows than split_kv serves, an integer offset with a device
    plan, and a malformed position raise before any library loads."""
    with pytest.raises(ValueError, match="integer q_offset"):
        tflash.flash_launch_plan(bh=16, sq=100, skv=CAP, d=D, kv_group=4,
                                 device_pos=True)
    with pytest.raises(ValueError, match="read on the device"):
        tflash.flash_launch_plan(bh=8, sq=1, skv=CAP, d=D, q_offset=3,
                                 device_pos=True)
    q = torch.zeros(8, 1, D)
    k = torch.zeros(2, CAP, D)
    for pos in (torch.zeros(2, dtype=torch.int64), torch.zeros(3, dtype=torch.int32)):
        with pytest.raises(ValueError, match="two int32"):
            tflash._flash_launch(q, k, k, causal=True, q_offset=0, skv=CAP,
                                 splits=4, d=D, body="split_kv", pos=pos)


# ------------------------------------------------------- steps against JAX
# qkv bias; tied embedding x sqrt(d); MoE with capacity dispatch; MLA, its
# latent cache and a leading dense layer
ARCHS = ("qwen2-1.5b", "gemma-2b", "qwen2-moe-a2.7b", "deepseek-v2-lite-16b")
PROMPT, MAX_LEN, DECODES = 7, 12, 4


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, dtype, what):
    assert tuple(got.shape) == tuple(np.shape(want)), what
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               err_msg=what, **MODEL_TOL[dtype])


def _close_caches(tc, jc, dtype, what):
    """The port's flat list of layer caches against the reference's
    ``first`` list, then ``periods["sub0"]`` stacked over periods."""
    assert int(tc["pos"]) == int(jc["pos"]), what
    jlayers = [c["self"] for c in jc.get("first", ())] + [
        {k: v[n] for k, v in jc["periods"]["sub0"]["self"].items()}
        for n in range(len(tc["layers"]) - len(jc.get("first", ())))]
    for n, (layer, want) in enumerate(zip(tc["layers"], jlayers, strict=True)):
        if tlayers.MLA_CACHE in layer:
            # one (B, L, kv_lora + rope) buffer: the latent, then k_pe
            buf = layer[tlayers.MLA_CACHE]
            lora = want["latent"].shape[-1]
            got = {"latent": buf[..., :lora], "k_pe": buf[..., lora:]}
        else:
            # head-major (B, Hkv, L, hd) read as the reference's (B, L, Hkv, hd)
            got = {name: layer[name].transpose(1, 2) for name in ("k", "v")}
        assert set(got) == set(want), what
        for name, t in got.items():
            _close(t, want[name], dtype, f"{what}: layer {n} {name}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compiled_steps_match_jax_jit(arch, dtype):
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype)
    jparams = jtf.init_lm(jax.random.PRNGKey(4), jcfg)
    tparams = ttf.params_from_jax(_np(jparams), tcfg, device="cpu")
    toks = np.random.default_rng(5).integers(0, jcfg.vocab, (2, PROMPT + DECODES))

    jprefill = jax.jit(jsteps.make_prefill_step(jcfg, MAX_LEN))
    jdecode = jax.jit(jsteps.make_decode_step(jcfg))
    jlogits, jc = jprefill(jparams, {"tokens": jnp.asarray(toks[:, :PROMPT], jnp.int32)})
    prefill = graph.compile_prefill(tsteps.make_prefill_step(tcfg, MAX_LEN))
    decode = graph.compile_decode(tsteps.make_decode_step(tcfg))
    with torch.inference_mode():
        tlogits, tc = prefill(tparams, {"tokens": torch.from_numpy(toks[:, :PROMPT])})
        _close(tlogits, jlogits, dtype, "prefill logits")
        _close_caches(tc, _np(jc), dtype, "prefill caches")
        assert tc[graph.HOST_POS] == PROMPT
        for i in range(PROMPT, PROMPT + DECODES):
            jlogits, jc = jdecode(jparams, jc, jnp.asarray(toks[:, i:i + 1], jnp.int32))
            tlogits, tc = decode(tparams, tc, torch.from_numpy(toks[:, i:i + 1]))
            _close(tlogits, jlogits, dtype, f"decode {i} logits")
        _close_caches(tc, _np(jc), dtype, "decode caches")
        assert tc[graph.HOST_POS] == PROMPT + DECODES


# ------------------------------------------------------------ no host read
_HOST_READS = ("item", "__bool__", "__int__", "__index__", "tolist", "cpu",
               "__float__", "numpy")


@contextlib.contextmanager
def _no_host_reads():
    """Every way a step could read a tensor's value on the host raises."""
    def refuse(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"host read: Tensor.{name}")
        return read
    saved = {name: getattr(torch.Tensor, name) for name in _HOST_READS}
    try:
        for name in _HOST_READS:
            setattr(torch.Tensor, name, refuse(name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma-2b", "granite-8b",
                                  "stablelm-12b", "qwen2-moe-a2.7b",
                                  "deepseek-v2-lite-16b"])
def test_decode_step_reads_nothing_on_the_host(arch):
    cfg = tconfigs.get_smoke(arch)
    params = ttf.init_lm(cfg, seed=1, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (2, 5)))
    with torch.inference_mode():
        _, caches = tsteps.make_prefill_step(cfg, 9)(params, {"tokens": tokens})
        decode = tsteps.make_decode_step(cfg)
        want, _ = decode(params, {"pos": caches["pos"].clone(),
                                  "layers": [dict(c) for c in caches["layers"]]},
                         tokens[:, :1])
        with _no_host_reads():
            got, new = decode(params, caches, tokens[:, :1])
            with pytest.raises(AssertionError, match="host read"):
                bool(new["pos"] == 6)       # the guard itself works
        assert int(new["pos"]) == 6
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_decode_past_the_capacity_raises_before_writing():
    cfg = tconfigs.get_smoke("qwen2-1.5b")
    params = ttf.init_lm(cfg, seed=2, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab, (2, 6)))
    prefill = graph.compile_prefill(tsteps.make_prefill_step(cfg, 7))
    decode = graph.compile_decode(tsteps.make_decode_step(cfg))
    with torch.inference_mode():
        _, caches = prefill(params, {"tokens": tokens})
        _, caches = decode(params, caches, tokens[:, :1])      # fills slot 6
        assert caches[graph.HOST_POS] == 7 and int(caches["pos"]) == 7
        before = [t.clone() for t in graph._cache_buffers(caches)]
        with pytest.raises(ValueError, match="do not fit a cache of 7"):
            decode(params, caches, tokens[:, 1:2])
    assert caches[graph.HOST_POS] == 7
    for got, want in zip(graph._cache_buffers(caches), before):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_embed_scale_float_rounds_as_the_tensor_product(dtype):
    """The Python float the step multiplies by (no tensor made on the
    device) gives the product with the dtype's 0-d tensor bit for bit."""
    x = torch.from_numpy(np.random.default_rng(9).standard_normal((64, 96))
                         .astype(np.float32)).to(dtype)
    for d in (128, 1536, 2048, 4096, 5120):
        assert torch.equal(x * ttf.embed_scale(d, dtype),
                           x * torch.tensor(d ** 0.5, dtype=dtype))


def test_forward_longer_than_the_cache_raises():
    """A shape check that needs no device value: S > capacity."""
    cfg = tconfigs.get_smoke("gemma-2b")
    params = ttf.init_lm(cfg, device="cpu")
    caches = ttf.init_caches(cfg, 1, 4, device="cpu")
    assert caches["pos"].dtype == torch.int32 and caches["pos"].shape == ()
    with torch.inference_mode(), pytest.raises(ValueError, match="do not fit"):
        ttf.forward(params, cfg, torch.zeros(1, 5, dtype=torch.long),
                    caches=caches, start=0)


# --------------------------------------------------- graph bookkeeping, stub
class _StubGraph:
    """Stands in for a captured CUDA graph: a replay re-runs the captured
    function and writes its result into the captured output, as a graph's
    kernels write into their captured buffers (its launches, which a real
    replay does not count again, are dropped)."""

    def __init__(self, fn, out):
        self.fn, self.out, self.replays = fn, out, 0

    def replay(self):
        self.replays += 1
        with launch.recording():
            out = self.fn()
        if isinstance(out, torch.Tensor):
            self.out.copy_(out)


@pytest.fixture
def stub_graphs(monkeypatch):
    """The CUDA path of the compiled steps on CPU tensors, on stub graphs."""
    made = []

    def capture(fn, device):
        out = fn()
        made.append(_StubGraph(fn, out))
        return made[-1], out

    monkeypatch.setattr(graph, "_captures", lambda device: True)
    monkeypatch.setattr(graph, "_warm_up", lambda fn, device: fn())
    monkeypatch.setattr(graph, "_capture", capture)
    return made


def test_replays_count_the_captured_launches(stub_graphs):
    def fn():
        launch.count_launch("flash_attention")
        launch.count_launch("flash_attention")
        launch.count_launch("flash_attention/combine")
        return "out"

    launch.reset_launches()
    launch.count_launch("earlier")
    step = graph.CapturedStep(fn, torch.device("cpu"))
    assert launch.LAUNCHES == {"earlier": 1}      # warm-up and capture: none
    assert step.launches == {"flash_attention": 2, "flash_attention/combine": 1}
    assert step.out == "out"
    for _ in range(3):
        step.replay()
    assert stub_graphs[0].replays == 3
    assert launch.LAUNCHES == {"earlier": 1, "flash_attention": 6,
                               "flash_attention/combine": 3}


def test_compiled_steps_on_a_stub_graph(stub_graphs):
    """Static caches and inputs, one capture per shape, fresh logits,
    foreign buffers refused; the results equal the eager steps bit for bit."""
    cfg = tconfigs.get_smoke("qwen2-1.5b")
    params = ttf.init_lm(cfg, seed=3, device="cpu")
    rng = np.random.default_rng(8)
    prompts = [torch.from_numpy(rng.integers(0, cfg.vocab, (2, n))) for n in (5, 5, 3)]
    eager_prefill = tsteps.make_prefill_step(cfg, 10)
    eager_decode = tsteps.make_decode_step(cfg)
    prefill = graph.compile_prefill(tsteps.make_prefill_step(cfg, 10))
    decode = graph.compile_decode(tsteps.make_decode_step(cfg))
    with torch.inference_mode():
        static = None
        for prompt in prompts:
            logits, caches = prefill(params, {"tokens": prompt})
            want, want_caches = eager_prefill(params, {"tokens": prompt})
            assert torch.equal(logits, want)
            static = static or caches
            assert caches is static                    # one cache per batch size
            assert caches[graph.HOST_POS] == prompt.shape[1]
            tok = prompt[:, :1]
            for _ in range(3):
                logits, caches = decode(params, caches, tok)
                want, want_caches = eager_decode(params, want_caches, tok)
                assert torch.equal(logits, want)
                assert logits.data_ptr() != decode.graphs[(tuple(tok.shape), tok.dtype)][
                    "graph"].out.data_ptr()            # a clone, not the buffer
                tok = torch.argmax(logits, -1)[:, None]
            for got, ref_t in zip(graph._cache_buffers(caches),
                                  graph._cache_buffers(want_caches)):
                assert torch.equal(got, ref_t)
        # two prompt lengths and one decode shape: three graphs
        assert len(prefill.graphs) == 2 and len(decode.graphs) == 1
        foreign = eager_prefill(params, {"tokens": prompts[0]})[1]
        with pytest.raises(ValueError, match="cache buffers other than"):
            decode(params, foreign, prompts[0][:, :1])
        other = ttf.init_lm(cfg, seed=4, device="cpu")
        with pytest.raises(ValueError, match="weights other than"):
            decode(other, caches, prompts[0][:, :1])
        with pytest.raises(ValueError, match="weights other than"):
            prefill(other, {"tokens": prompts[0]})
