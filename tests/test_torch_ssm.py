"""The port's Mamba-2 SSD block (`repro_torch.models.ssm`) and the stacks
that run it, Mamba2 (mamba2-1.3b: attention-free, no FFN) and Jamba
(jamba-v0.1-52b: mamba and attention sublayers, dense and MoE FFNs),
against the live reference (`repro.models.ssm`, `repro.models.transformer`)
on the CPU. Inputs come from numpy seeds; the reference's weights reach the
port through `params_from_jax`.

Tolerances: the SSD and its parts fp32 1e-4, bf16 2e-2; the block (whose
bf16 output passes through two more bf16 products) and the stacks fp32
1e-4 and bf16 tests/test_torch_models.py's (rtol 5e-2, atol 8e-2). Jamba's smoke stack has 16 layers whose residual
stream reaches magnitudes near 20, where a bf16 step is 0.125: two bf16
implementations drift apart by an ULP or two a layer, and its top-2 routes
sit at near-ties (the reference's own plumbing test runs MoE archs in fp32
for that reason). In bf16 it is therefore held layer by layer, each layer's
mixer and FFN given the reference's input to it, at the same tolerance; in
fp32 as a whole."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.kernels import launch
from repro_torch.launch import graph
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf

ARCHS = ("mamba2-1.3b", "jamba-v0.1-52b")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SSD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MODEL_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
             "bfloat16": dict(rtol=5e-2, atol=8e-2)}
B, S, N_PREFILL = 2, 12, 8


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _pair(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, dtype=jd), torch.from_numpy(a).to(td)


def _close(got, want, tol, what=""):
    assert tuple(got.shape) == tuple(np.shape(want)), what
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               err_msg=what, **tol)


def _tol(dtype):
    return dict(rtol=SSD_TOL[dtype], atol=SSD_TOL[dtype])


def _cfgs(arch, dtype="float32", **ssm):
    """The smoke config in both packages, in ``dtype``, SSM fields replaced."""
    return [dataclasses.replace(cfg, dtype=dtype,
                                ssm=dataclasses.replace(cfg.ssm, **ssm))
            for cfg in (jget_smoke(arch), tconfigs.get_smoke(arch))]


def _flat(tree, prefix=""):
    """{path: (shape, dtype name)} of a torch or a JAX tree."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))}


def _to_port(tree, dtype: torch.dtype):
    """A reference subtree as the carrier converts it: fp32 under
    `transformer.FP32_KEYS`, ``dtype`` elsewhere."""
    return {k: _to_port(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32)).to(
                torch.float32 if k in ttf.FP32_KEYS else dtype)
            for k, v in tree.items()}


def _block_params(jcfg, tcfg, seed=0):
    """The reference's `mamba_init` (conv_b made nonzero) and the same
    weights in the port."""
    jp = jssm.mamba_init(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, conv_b=jax.random.normal(jax.random.PRNGKey(seed + 1),
                                           jp["conv_b"].shape,
                                           jp["conv_b"].dtype) * 0.1)
    return jp, _to_port(jp, tlayers.dtype_of(tcfg))


# ------------------------------------------------------------------- parts
@pytest.mark.parametrize("shape", [(5,), (2, 3, 16)])
def test_segsum_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    got = tssm._segsum(torch.from_numpy(x))
    want = np.asarray(jssm._segsum(jnp.asarray(x)))
    assert np.array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[finite], want[finite], rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 9])
def test_causal_conv_matches_jax(dtype, s):
    rng = np.random.default_rng(1)
    ju, tu = _pair(rng, (2, s, 24), dtype)
    jw, tw = _pair(rng, (4, 24), dtype, 0.5)
    jb, tb = _pair(rng, (24,), dtype, 0.1)
    got = tssm._causal_conv(tu, tw, tb)
    assert got.dtype == DTYPES[dtype][1]
    _close(got, jssm._causal_conv(ju, jw, jb), _tol(dtype))


def _ssd_inputs(rng, dtype, s, h=4, p=8, g=1, n=6):
    jx, tx = _pair(rng, (2, s, h, p), dtype)
    a = -np.exp(rng.standard_normal((2, s, h))).astype(np.float32) * 0.3
    jb, tb = _pair(rng, (2, s, g, n), dtype, 0.5)
    jc, tc = _pair(rng, (2, s, g, n), dtype, 0.5)
    return (jx, jnp.asarray(a), jb, jc), (tx, torch.from_numpy(a), tb, tc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,chunk", [(32, 8), (29, 8), (5, 16)])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(dtype, s, chunk, groups, with_state):
    """S a chunk multiple and not (zero-padded), S under one chunk, grouped
    heads, a carried initial state."""
    rng = np.random.default_rng(2)
    jin, tin = _ssd_inputs(rng, dtype, s, g=groups)
    st = rng.standard_normal((2, 4, 8, 6)).astype(np.float32)
    jst, tst = ((jnp.asarray(st), torch.from_numpy(st)) if with_state
                else (None, None))
    jy, jfinal = jssm.ssd_chunked(*jin, chunk, init_state=jst)
    ty, tfinal = tssm.ssd_chunked(*tin, chunk, init_state=tst)
    assert ty.dtype == tfinal.dtype == torch.float32
    _close(ty, jy, _tol(dtype), "y")
    _close(tfinal, jfinal, _tol(dtype), "final state")


@pytest.mark.parametrize("s,chunk,groups", [(29, 8, 1), (24, 6, 2)])
def test_ssd_chunked_is_the_recurrence(s, chunk, groups):
    """Against the step-by-step recurrence in float64: st = st exp(a_t) +
    x_t b_t^T, y_t = st c_t (heads grouped consecutively)."""
    rng = np.random.default_rng(3)
    _, (x, a, b, c) = _ssd_inputs(rng, "float32", s, g=groups)
    st0 = rng.standard_normal((2, 4, 8, 6))
    y, final = tssm.ssd_chunked(x, a, b, c, chunk,
                                init_state=torch.from_numpy(st0).float())
    xd, ad, bd, cd = (t.double().numpy() for t in (x, a, b, c))
    rep = 4 // groups
    bd, cd = np.repeat(bd, rep, axis=2), np.repeat(cd, rep, axis=2)
    st, ys = st0, []
    for t in range(s):
        st = (st * np.exp(ad[:, t])[..., None, None]
              + xd[:, t, :, :, None] * bd[:, t, :, None, :])
        ys.append(np.einsum("bhpn,bhn->bhp", st, cd[:, t]))
    _close(y, np.stack(ys, 1), _tol("float32"), "y")
    _close(final, st, _tol("float32"), "final state")


# ------------------------------------------------------------------- params
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mamba_init_and_cache_are_the_reference_trees(arch, dtype):
    """Keys, shapes and dtypes of `mamba_init` and `init_ssm_cache` equal
    the reference's: A_log, D, dt_bias and the SSM state fp32 in a bf16
    config."""
    jcfg, tcfg = _cfgs(arch, dtype)
    tp = tssm.mamba_init(torch.Generator().manual_seed(0), tcfg,
                         torch.device("cpu"))
    assert _flat(tp) == _flat(jssm.mamba_init(jax.random.PRNGKey(0), jcfg))
    for name in ("A_log", "D", "dt_bias"):
        assert tp[name].dtype == torch.float32
    tc = tssm.init_ssm_cache(tcfg, 3, torch.device("cpu"))
    assert _flat(tc) == _flat(jssm.init_ssm_cache(jcfg, 3))
    assert tc["ssm"].dtype == torch.float32 and not tc["ssm"].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_carrier_builds_init_lm_structure(arch, dtype):
    """`params_from_jax` and the port's `init_lm` build the same tree, the
    mamba layers' fp32 leaves fp32 in both; a layer without an FFN has no
    norm2; `init_caches` gives each layer its mixer's cache."""
    jcfg, tcfg = _cfgs(arch, dtype)
    carried = ttf.params_from_jax(_np(jtf.init_lm(jax.random.PRNGKey(0), jcfg)),
                                  tcfg, device="cpu")
    own = ttf.init_lm(tcfg, seed=0, device="cpu")
    assert _flat(own) == _flat(carried)
    kinds = ttf.layer_kinds(tcfg)
    assert len(kinds) == len(own["layers"]) == tcfg.n_layers
    caches = ttf.init_caches(tcfg, 2, 8, device="cpu")
    for (mixer, ffn), layer, cache in zip(kinds, own["layers"], caches["layers"]):
        assert set(layer) == {"norm1", mixer} | (
            set() if ffn == "none" else {"norm2", "mlp" if ffn == "dense" else ffn})
        assert set(cache) == (set(tssm.STATE) if mixer == "mamba" else {"k", "v"})
        if mixer == "mamba":
            assert layer["mamba"]["A_log"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_at_full_width(arch):
    assert ttf.count_params(tconfigs.get_config(arch)) \
        == jtf.count_params(jget_config(arch))
    assert ttf.count_params(tconfigs.get_config(arch), active_only=True) \
        == jtf.count_params(jget_config(arch), active_only=True)


# -------------------------------------------------------------------- block
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,groups", [("mamba2-1.3b", 1),
                                         ("jamba-v0.1-52b", 1),
                                         ("mamba2-1.3b", 2)])
def test_mamba_apply_without_a_cache(arch, groups, dtype):
    jcfg, tcfg = _cfgs(arch, dtype, n_groups=groups)
    jp, tp = _block_params(jcfg, tcfg)
    jx, tx = _pair(np.random.default_rng(4), (2, 45, jcfg.d_model), dtype)
    want, jc = jssm.mamba_apply(jp, jx, jcfg)
    with torch.inference_mode():
        got, tc = tssm.mamba_apply(tp, tx, tcfg)
    assert jc is None and tc is None and got.dtype == DTYPES[dtype][1]
    _close(got, want, MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,n_pre", [("mamba2-1.3b", 37),
                                        ("jamba-v0.1-52b", 40),
                                        ("mamba2-1.3b", 2)])
def test_mamba_apply_prefill_then_decode(arch, n_pre, dtype):
    """A prefill into a cache (its output, the conv window of the last
    d_conv - 1 inputs and the final state), then recurrent decode steps,
    each step's output and cache. A prefill shorter than the window (2
    tokens) leaves zero rows in front, where the reference's slice would be
    short; the reference is then given the same padded window."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _block_params(jcfg, tcfg, seed=2)
    jx, tx = _pair(np.random.default_rng(5), (2, n_pre + 4, jcfg.d_model), dtype)
    jc = jssm.init_ssm_cache(jcfg, 2)
    tc = tssm.init_ssm_cache(tcfg, 2, torch.device("cpu"))
    want, jc = jssm.mamba_apply(jp, jx[:, :n_pre], jcfg, cache=jc)
    k = jcfg.ssm.d_conv - 1
    if n_pre < k:
        jc = dict(jc, conv=jnp.pad(jc["conv"], ((0, 0), (k - n_pre, 0), (0, 0))))
    with torch.inference_mode():
        got, tc2 = tssm.mamba_apply(tp, tx[:, :n_pre], tcfg, cache=tc)
        assert tc2 is tc and tc["ssm"].dtype == torch.float32
        _close(got, want, MODEL_TOL[dtype], "prefill")
        for name in ("conv", "ssm"):
            _close(tc[name], jc[name], MODEL_TOL[dtype], f"prefill cache {name}")
        for i in range(n_pre, n_pre + 4):
            want, jc = jssm.mamba_apply(jp, jx[:, i:i + 1], jcfg, cache=jc)
            got, _ = tssm.mamba_apply(tp, tx[:, i:i + 1], tcfg, cache=tc)
            _close(got, want, MODEL_TOL[dtype], f"decode {i}")
            for name in ("conv", "ssm"):
                _close(tc[name], jc[name], MODEL_TOL[dtype], f"decode {i} cache {name}")


# -------------------------------------------------------------------- stacks
def _port_layout(cache: dict) -> dict:
    """One reference layer cache in the port's layout: a mamba layer's conv
    and ssm as they are, an attention layer's (k, v) head-major."""
    if "mamba" in cache:
        return dict(cache["mamba"])
    return {k: np.swapaxes(v, 1, 2) for k, v in cache["self"].items()}


def _reference_caches(jc, tcfg) -> list[dict]:
    """The reference's caches, stacked over periods, as the port's flat
    list of layer caches."""
    per = len(tcfg.period_layout)
    return [_port_layout(jax.tree.map(lambda t, n=i // per: t[n],
                                      jc["periods"][f"sub{i % per}"]))
            for i in range(tcfg.n_layers)]


def _close_caches(tc, jc, tcfg, tol, what):
    assert int(tc["pos"]) == int(jc["pos"]), what
    want = _reference_caches(jc, tcfg)
    assert len(tc["layers"]) == len(want) == tcfg.n_layers
    for n, (layer, ref) in enumerate(zip(tc["layers"], want)):
        assert set(layer) == set(ref), what
        for name in layer:
            _close(layer[name], ref[name], tol, f"{what}: layer {n} {name}")


@pytest.mark.parametrize("arch,dtype", [("mamba2-1.3b", "float32"),
                                        ("mamba2-1.3b", "bfloat16"),
                                        ("jamba-v0.1-52b", "float32")])
def test_stack_matches_jax(arch, dtype):
    """Full forward, a prefill of N_PREFILL tokens into caches of S, then
    teacher-forced decode steps: logits and every layer's cache."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jparams = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = ttf.params_from_jax(_np(jparams), tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    tol = MODEL_TOL[dtype]

    jfull, _, jaux = jtf.forward(jparams, jcfg, jt)
    jc = jtf.init_caches(jcfg, B, S)
    jpre, jc, _ = jtf.forward(jparams, jcfg, jt[:, :N_PREFILL], caches=jc)
    with torch.inference_mode():
        tfull, _, taux = ttf.forward(tparams, tcfg, tt)
        assert tfull.shape == (B, S, tcfg.padded_vocab)
        assert tfull.dtype == DTYPES[dtype][1]
        _close(tfull, jfull, tol, "forward logits")
        np.testing.assert_allclose(float(taux), float(jaux), **tol)
        tc = ttf.init_caches(tcfg, B, S, device="cpu")
        tpre, tc, _ = ttf.forward(tparams, tcfg, tt[:, :N_PREFILL], caches=tc,
                                  start=0)
        _close(tpre, jpre, tol, "prefill logits")
        _close_caches(tc, _np(jc), tcfg, tol, "prefill caches")
        for i in range(N_PREFILL, S):
            jl, jc, _ = jtf.forward(jparams, jcfg, jt[:, i:i + 1], caches=jc)
            tl, tc, _ = ttf.forward(tparams, tcfg, tt[:, i:i + 1], caches=tc)
            _close(tl, jl, tol, f"decode {i} logits")
        _close_caches(tc, _np(jc), tcfg, tol, "decode caches")


def test_jamba_bf16_layer_by_layer():
    """bf16 Jamba, each of its 16 layers given the reference's input to it:
    the mixer (a prefill into the layer's cache, then teacher-forced decode
    steps: outputs and caches) and, on the mixer's reference output, the
    dense FFN or the MoE, at tests/test_torch_models.py's bf16 tolerance."""
    jcfg, tcfg = _cfgs("jamba-v0.1-52b", "bfloat16")
    tol = MODEL_TOL["bfloat16"]
    jparams = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = ttf.params_from_jax(_np(jparams), tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S))
    jx = jparams["embed"]["w"][jnp.asarray(toks, jnp.int32)]
    jcaches = jtf.init_caches(jcfg, B, S)
    tcaches = ttf.init_caches(tcfg, B, S, device="cpu")
    kinds = ttf.layer_kinds(tcfg)
    assert sum(m == "attn" for m, _ in kinds) == 2 \
        and {f for _, f in kinds} == {"dense", "moe"}
    for i, (mixer, ffn) in enumerate(kinds):
        n, j = divmod(i, len(jcfg.period_layout))
        jp = jax.tree.map(lambda t, n=n: t[n], jparams["periods"][f"sub{j}"])
        jc = jax.tree.map(lambda t, n=n: t[n], jcaches["periods"][f"sub{j}"])
        tp, tc = tparams["layers"][i], tcaches["layers"][i]
        mixer_only = {k: v for k, v in tp.items() if k in ("norm1", mixer)}
        spans = [(0, N_PREFILL)] + [(t, t + 1) for t in range(N_PREFILL, S)]
        outs = []
        for a, b in spans:
            jy, jc, _ = jtf._sublayer_apply(
                jp, jx[:, a:b], jcfg, mixer, "none", positions=jnp.arange(a, b),
                cache=jc, cache_pos=jnp.asarray(a, jnp.int32), memory=None,
                causal=True, parallel=None, chunk=jcfg.attn_chunk)
            with torch.inference_mode():
                ty, tc, _ = ttf._layer_apply(
                    mixer_only, torch.from_numpy(np.asarray(jx[:, a:b], np.float32))
                    .to(torch.bfloat16), tcfg, positions=torch.arange(a, b),
                    cache=tc, cache_pos=torch.tensor(a, dtype=torch.int32),
                    start=0 if a == 0 else None)
            _close(ty, jy, tol, f"layer {i} {mixer} tokens {a}:{b}")
            want = _port_layout(_np(jc))
            assert set(tc) == set(want)
            for name in tc:
                _close(tc[name], want[name], tol, f"layer {i} cache {name} at {b}")
            outs.append(jy)
        jmid = jnp.concatenate(outs, 1)
        jh = jlayers.norm_apply(jp["norm2"], jmid, jcfg.norm_eps)
        th = tlayers.norm_apply(tp["norm2"], torch.from_numpy(
            np.asarray(jmid, np.float32)).to(torch.bfloat16), tcfg.norm_eps)
        with torch.inference_mode():
            if ffn == "moe":
                jout, _ = jmoe.moe_apply(jp["moe"], jh, jcfg)
                tout, _ = tmoe.moe_apply(tp["moe"], th, tcfg)
            else:
                jout = jlayers.mlp_apply(jp["mlp"], jh, jcfg.act)
                tout = tlayers.mlp_apply(tp["mlp"], th, tcfg.act)
        _close(tout, jout, tol, f"layer {i} {ffn}")
        jx = jmid + jout


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_a_full_forward(arch):
    """fp32, the reference's `test_prefill_decode_matches_full_forward` on
    the port alone (MoE ragged, as there): a prefill over two chunks and a
    padded third, then one recurrent step a token, against one forward."""
    tcfg = tconfigs.get_smoke(arch)
    tcfg = dataclasses.replace(
        tcfg, dtype="float32",
        moe=tcfg.moe and dataclasses.replace(tcfg.moe, impl="ragged"))
    params = ttf.init_lm(tcfg, seed=3, device="cpu")
    s, n_pre = 72, 68
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab, (B, s)))
    with torch.inference_mode():
        full, _, _ = ttf.forward(params, tcfg, toks)
        caches = ttf.init_caches(tcfg, B, s, device="cpu")
        pre, caches, _ = ttf.forward(params, tcfg, toks[:, :n_pre],
                                     caches=caches, start=0)
        torch.testing.assert_close(pre[:, -1], full[:, n_pre - 1],
                                   **MODEL_TOL["float32"])
        for i in range(n_pre, s):
            step, caches, _ = ttf.forward(params, tcfg, toks[:, i:i + 1],
                                          caches=caches)
            torch.testing.assert_close(step[:, 0], full[:, i],
                                       **MODEL_TOL["float32"])
        assert int(caches["pos"]) == s


def test_cache_capacity_reads_the_first_attention_layer():
    """Jamba's layer 0 is a mamba layer: the capacity is its first attention
    layer's; Mamba2 has none, so nothing bounds its decode."""
    jamba = tconfigs.get_smoke("jamba-v0.1-52b")
    caches = ttf.init_caches(jamba, 2, 9, device="cpu")
    assert set(caches["layers"][0]) == set(tssm.STATE)
    assert ttf.cache_capacity(caches) == 9
    mamba = tconfigs.get_smoke("mamba2-1.3b")
    caches = ttf.init_caches(mamba, 2, 9, device="cpu")
    assert all(set(c) == set(tssm.STATE) for c in caches["layers"])
    assert ttf.cache_capacity(caches) is None
    params = ttf.init_lm(mamba, seed=1, device="cpu")
    decode = graph.compile_decode(tsteps.make_decode_step(mamba))
    tok = torch.zeros((2, 1), dtype=torch.long)
    with torch.inference_mode():
        for _ in range(12):                     # past max_len: no bound
            _, caches = decode(params, caches, tok)
    assert caches[graph.HOST_POS] == 12 and int(caches["pos"]) == 12


class _Replayed:
    """A stand-in for `graph.CapturedStep` on the CPU that runs ``fn`` at
    the warm-up, at the capture and at every replay, as a card's warm-up
    does (its capture runs nothing): the state is advanced before the
    first replay unless the compiled step puts it back."""

    def __init__(self, fn, device):
        fn()                                    # the warm-up, for real
        self.fn, self.launches = fn, {}
        self.out = fn()

    def replay(self):
        with launch.recording():
            self.out.copy_(self.fn())


@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_decode_puts_the_state_back(arch, monkeypatch):
    """The compiled steps on the stand-in graph: every step equals the
    eager step bit for bit, every mamba buffer too, so the warm-up's and
    the capture's runs of the step left no trace."""
    monkeypatch.setattr(graph, "_captures", lambda device: True)
    monkeypatch.setattr(graph, "CapturedStep", _Replayed)
    cfg = tconfigs.get_smoke(arch)
    params = ttf.init_lm(cfg, seed=5, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab, (2, 6)))
    prefill = graph.compile_prefill(tsteps.make_prefill_step(cfg, 10))
    decode = graph.compile_decode(tsteps.make_decode_step(cfg))
    eager_prefill = tsteps.make_prefill_step(cfg, 10)
    eager_decode = tsteps.make_decode_step(cfg)
    with torch.inference_mode():
        for _ in range(2):                      # a second request, same graphs
            logits, caches = prefill(params, {"tokens": prompt})
            want, want_caches = eager_prefill(params, {"tokens": prompt})
            assert torch.equal(logits, want)
            tok = prompt[:, -1:]
            for _ in range(4):
                logits, caches = decode(params, caches, tok)
                want, want_caches = eager_decode(params, want_caches, tok)
                assert torch.equal(logits, want)
                tok = torch.argmax(logits, -1)[:, None]
            for got, ref in zip(graph._cache_buffers(caches),
                                graph._cache_buffers(want_caches), strict=True):
                assert torch.equal(got, ref)
    assert len(prefill.graphs) == 1 and len(decode.graphs) == 1


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    """Every way a step could read a tensor's value on the host raises."""
    def refuse(self, *args, **kwargs):
        raise AssertionError("host read")
    with monkeypatch.context() as m:
        for name in ("item", "__bool__", "__int__", "__index__", "tolist",
                     "cpu", "__float__", "numpy"):
            m.setattr(torch.Tensor, name, refuse)
        yield


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_reads_nothing_on_the_host(arch, monkeypatch):
    """The recurrent decode reads no tensor value on the host, so a CUDA
    graph captures it; the state is cloned for the eager reference, since
    the step advances it in place."""
    cfg = tconfigs.get_smoke(arch)
    params = ttf.init_lm(cfg, seed=1, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, (2, 5)))
    with torch.inference_mode():
        _, caches = tsteps.make_prefill_step(cfg, 9)(params, {"tokens": tokens})
        decode = tsteps.make_decode_step(cfg)
        want, _ = decode(params, {"pos": caches["pos"].clone(),
                                  "layers": [{k: v.clone() for k, v in c.items()}
                                             for c in caches["layers"]]},
                         tokens[:, :1])
        with _no_host_reads(monkeypatch):
            got, new = decode(params, caches, tokens[:, :1])
        assert int(new["pos"]) == 6
        torch.testing.assert_close(got, want, rtol=0, atol=0)
