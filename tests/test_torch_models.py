"""The port's dense LM against the reference package's, on the four dense
archs at `get_smoke` size: the reference's own weights (JAX `init_lm`)
carried across with `params_from_jax`, the same numpy tokens, and forward
logits, prefill caches and teacher-forced decode steps compared. Tolerances:
fp32 rtol = atol = 2e-4; bf16 rtol 5e-2, atol 8e-2
(tests/test_smoke_archs.py). The port's caches are head-major (B, Hkv,
max_len, hd) and are read through `_reference_layout`, the reference's
(B, max_len, Hkv, hd)."""

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
from repro_torch import configs as tconfigs
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

ARCHS = ("qwen2-1.5b", "gemma-2b", "granite-8b", "stablelm-12b")
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=5e-2, atol=8e-2)}
B, S, N_PREFILL = 2, 12, 8


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _reference_layout(cache: torch.Tensor) -> torch.Tensor:
    """A port cache (B, Hkv, max_len, hd) in the reference's layout."""
    return cache.transpose(1, 2)


def _close(got, want, dtype, what=""):
    assert tuple(got.shape) == tuple(want.shape), what
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               err_msg=what, **TOL[dtype])


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """One arch in one dtype, run through both packages: full forward,
    prefill of N_PREFILL tokens into a cache of S, then the remaining tokens
    one decode step each."""
    arch, dtype = request.param
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype)
    jparams = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = ttf.params_from_jax(_np(jparams), tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (B, S))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)

    jfull, _, _ = jtf.forward(jparams, jcfg, jt)
    jc = jtf.init_caches(jcfg, B, S)
    jpre, jc, _ = jtf.forward(jparams, jcfg, jt[:, :N_PREFILL], caches=jc)
    jpre_caches = _np(jc)
    jsteps = []
    for i in range(N_PREFILL, S):
        lg, jc, _ = jtf.forward(jparams, jcfg, jt[:, i:i + 1], caches=jc)
        jsteps.append(np.asarray(lg[:, 0], np.float32))

    with torch.inference_mode():
        tfull, _, _ = ttf.forward(tparams, tcfg, tt)
        tc = ttf.init_caches(tcfg, B, S, device="cpu")
        tpre, tc, _ = ttf.forward(tparams, tcfg, tt[:, :N_PREFILL], caches=tc)
        tpre_caches = {"pos": tc["pos"],
                       "layers": [{k: v.clone() for k, v in c.items()}
                                  for c in tc["layers"]]}
        tsteps = []
        for i in range(N_PREFILL, S):
            lg, tc, _ = ttf.forward(tparams, tcfg, tt[:, i:i + 1], caches=tc)
            tsteps.append(lg[:, 0])
    return dict(arch=arch, dtype=dtype, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                tparams=tparams, jfull=jfull, tfull=tfull, jpre=jpre,
                tpre=tpre, jpre_caches=jpre_caches, tpre_caches=tpre_caches,
                jsteps=jsteps, tsteps=tsteps, tpos=tc["pos"])


def test_forward_logits_match_jax(pair):
    cfg = pair["tcfg"]
    assert pair["tfull"].shape == (B, S, cfg.padded_vocab)
    assert pair["tfull"].dtype == tlayers.dtype_of(cfg)
    _close(pair["tfull"], pair["jfull"], pair["dtype"])


def test_prefill_logits_and_caches_match_jax(pair):
    _close(pair["tpre"], pair["jpre"], pair["dtype"], "prefill logits")
    jc, tc = pair["jpre_caches"], pair["tpre_caches"]
    assert tc["pos"] == int(jc["pos"]) == N_PREFILL
    cfg = pair["tcfg"]
    assert len(tc["layers"]) == cfg.n_layers
    for n, layer in enumerate(tc["layers"]):
        for name in ("k", "v"):
            _close(_reference_layout(layer[name]),
                   jc["periods"]["sub0"]["self"][name][n], pair["dtype"],
                   f"layer {n} {name}")


def test_teacher_forced_decode_matches_jax(pair):
    assert pair["tpos"] == S
    for i, (got, want) in enumerate(zip(pair["tsteps"], pair["jsteps"])):
        _close(got, want, pair["dtype"], f"decode step {i}")


def test_decode_matches_the_port_forward(pair):
    """The port's own cache plumbing: teacher-forced decode reproduces its
    full-forward logits (as tests/test_smoke_archs.py holds the reference)."""
    tol = TOL[pair["dtype"]]
    full = pair["tfull"].float()
    torch.testing.assert_close(pair["tpre"][:, -1].float(),
                               full[:, N_PREFILL - 1], **tol)
    for i, got in enumerate(pair["tsteps"]):
        torch.testing.assert_close(got.float(), full[:, N_PREFILL + i], **tol)


def test_carrier_builds_init_lm_structure(pair):
    """`params_from_jax` and the port's `init_lm` build the same tree: the
    same keys and shapes and dtypes, layer by layer."""
    def flat(tree, prefix=""):
        if isinstance(tree, torch.Tensor):
            return {prefix: (tuple(tree.shape), tree.dtype)}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    own = ttf.init_lm(pair["tcfg"], seed=0, device="cpu")
    assert flat(own) == flat(pair["tparams"])


@pytest.mark.parametrize("arch", ARCHS + ("qwen2-moe-a2.7b",
                                          "deepseek-v2-lite-16b",
                                          "mamba2-1.3b", "jamba-v0.1-52b",
                                          "llama-3.2-vision-90b",
                                          "seamless-m4t-large-v2"))
def test_count_params_matches_jax_at_full_width(arch):
    assert ttf.count_params(tconfigs.get_config(arch)) \
        == jtf.count_params(jget_config(arch))
    assert tconfigs.get_config(arch).param_count() \
        == jget_config(arch).param_count()


@pytest.mark.parametrize("arch", ARCHS + ("qwen2-moe-a2.7b",
                                          "deepseek-v2-lite-16b",
                                          "mamba2-1.3b", "jamba-v0.1-52b",
                                          "llama-3.2-vision-90b",
                                          "seamless-m4t-large-v2"))
def test_configs_are_the_reference_data(arch):
    assert dataclasses.asdict(tconfigs.get_config(arch)) \
        == dataclasses.asdict(jget_config(arch))
    assert dataclasses.asdict(tconfigs.get_smoke(arch)) \
        == dataclasses.asdict(jget_smoke(arch))


@pytest.mark.parametrize("arch", ["mamba2-1.3b",
                                  "deepseek-v2-lite-16b", "jamba-v0.1-52b",
                                  "llama-3.2-vision-90b",
                                  "seamless-m4t-large-v2"])
def test_unported_archs_name_what_they_wait_for(arch):
    """Every arch the reference registers is one of the port's, and resolves
    to the reference's config (none waits any more); an unknown name is a
    KeyError."""
    assert arch in tconfigs.ARCHS
    assert dataclasses.asdict(tconfigs.get_config(arch)) \
        == dataclasses.asdict(jget_config(arch))
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


@pytest.mark.parametrize("change", [
    dict(period_layout=(("conv", "dense"),)),
    dict(period_layout=(("attn", "glu"),)),
    dict(period_layout=(("mamba", "none"),))])
def test_non_dense_stacks_raise(change):
    """A layout the reference does not define raises, naming what is
    outside it: an unknown mixer, an unknown FFN, and mamba sublayers
    without an SSM config. Every layout of the reference runs: MoE
    (tests/test_torch_moe.py), MLA and leading dense layers
    (tests/test_torch_mla.py), mamba sublayers (tests/test_torch_ssm.py),
    and the encoder, vision tokens and cross-attention mixers
    (tests/test_torch_cross.py)."""
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen2-1.5b"), **change)
    with pytest.raises(NotImplementedError,
                       match="the port runs the reference's stacks of.*"
                             "not among them"):
        ttf.init_lm(cfg, device="cpu")


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(kind):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    scale = rng.standard_normal(48).astype(np.float32)
    bias = rng.standard_normal(48).astype(np.float32)
    jp = {"scale": jnp.asarray(scale)}
    tp = {"scale": torch.from_numpy(scale)}
    if kind == "layernorm":
        jp["bias"], tp["bias"] = jnp.asarray(bias), torch.from_numpy(bias)
    _close(tlayers.norm_apply(tp, torch.from_numpy(x), 1e-5),
           jlayers.norm_apply(jp, jnp.asarray(x), 1e-5), "float32")


@pytest.mark.parametrize("rope_dim,batched", [(None, False), (32, True)])
def test_rope_matches_jax(rope_dim, batched):
    """Interleaved pairs, a partial rotary dim and (B, S) positions."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    pos = np.arange(7) + 11
    if batched:
        pos = np.stack([pos, pos + 5])
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                             rope_dim)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, rope_dim)
    _close(got, want, "float32")


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False), ("relu", False)])
def test_mlp_matches_jax(act, gated):
    """gelu is the tanh form on both sides (jax.nn.gelu's default)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 16)).astype(np.float32)
    names = ("wi", "wo", "wg") if gated else ("wi", "wo")
    shapes = {"wi": (16, 24), "wo": (24, 16), "wg": (16, 24)}
    w = {n: rng.standard_normal(shapes[n]).astype(np.float32) for n in names}
    got = tlayers.mlp_apply({n: {"w": torch.from_numpy(a)} for n, a in w.items()},
                            torch.from_numpy(x), act)
    want = jlayers.mlp_apply({n: {"w": jnp.asarray(a)} for n, a in w.items()},
                             jnp.asarray(x), act)
    _close(got, want, "float32")


def test_cache_overflow_raises():
    cfg = tconfigs.get_smoke("qwen2-1.5b")
    params = ttf.init_lm(cfg, device="cpu")
    caches = ttf.init_caches(cfg, 1, 4, device="cpu")
    with torch.inference_mode(), pytest.raises(ValueError, match="do not fit"):
        ttf.forward(params, cfg, torch.zeros(1, 5, dtype=torch.long),
                    caches=caches)
