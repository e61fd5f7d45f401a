"""The port's mixture of experts (`repro_torch.models.moe`) and the MoE
decoder (qwen2-moe-a2.7b) against the live reference (`repro.models.moe`,
`repro.models.transformer`) on the CPU. Inputs come from numpy seeds; the
reference's weights reach the port through `params_from_jax`.

Tolerances: routing weights and the aux loss 1e-6 in fp32; the expert FFN
1e-4 in fp32 and 2e-2 in bf16; `moe_apply` and the model at
tests/test_torch_models.py's (fp32 2e-4, bf16 rtol 5e-2 atol 8e-2).
Routing near-ties, tokens whose k-th and (k+1)-th probabilities differ by
less than `TIE`, may pick other experts on the two sides: they are counted
and bounded, never avoided."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import configs as tconfigs
from repro_torch.launch import graph
from repro_torch.models import moe as tmoe
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf

ARCH = "qwen2-moe-a2.7b"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FFN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MODEL_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
             "bfloat16": dict(rtol=5e-2, atol=8e-2)}
TIE = 1e-6


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


def _layer0_moe(jcfg, tcfg, seed=0):
    """Layer 0's MoE params: the reference's ``init_lm`` and the same
    weights through `params_from_jax`."""
    jparams = jtf.init_lm(jax.random.PRNGKey(seed), jcfg)
    tparams = ttf.params_from_jax(_np(jparams), tcfg, device="cpu")
    jp = jax.tree.map(lambda a: a[0], jparams["periods"]["sub0"]["moe"])
    return jp, tparams["layers"][0]["moe"]


def _flat(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape), tree.dtype)}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


# ------------------------------------------------------------------- params
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_init_is_the_reference_tree(dtype):
    """Keys and shapes of the reference's `moe_init`; the router in fp32
    whatever the config's dtype, the rest in the config's."""
    jcfg, tcfg = _cfgs(dtype)
    want = jax.eval_shape(lambda: jmoe.moe_init(jax.random.PRNGKey(0), jcfg))
    got = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg, torch.device("cpu"))
    dt = DTYPES[dtype][1]
    flat = _flat(got)
    assert {k: s for k, (s, _) in flat.items()} == {
        "/" + "/".join(k.key for k in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert {k: d for k, (_, d) in flat.items()} == {
        k: torch.float32 if k == "/router/w" else dt for k in flat}
    mc = tcfg.moe
    assert flat["/routed/wg"][0] == (mc.n_routed, tcfg.d_model, mc.expert_ff)
    assert flat["/routed/wo"][0] == (mc.n_routed, mc.expert_ff, tcfg.d_model)
    assert flat["/shared_gate/w"][0] == (tcfg.d_model, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_carrier_keeps_the_router_fp32(dtype):
    """`params_from_jax` builds `init_lm`'s tree, router fp32 included."""
    jcfg, tcfg = _cfgs(dtype)
    jparams = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    carried = ttf.params_from_jax(_np(jparams), tcfg, device="cpu")
    own = ttf.init_lm(tcfg, seed=0, device="cpu")

    def flat(tree):
        return _flat({str(i): layer for i, layer in enumerate(tree["layers"])}
                     | {k: v for k, v in tree.items() if k != "layers"})
    assert flat(own) == flat(carried)
    routers = jparams["periods"]["sub0"]["moe"]["router"]["w"]
    for n, layer in enumerate(carried["layers"]):
        np.testing.assert_array_equal(layer["moe"]["router"]["w"].numpy(),
                                      np.asarray(routers[n], np.float32))


def test_count_params_matches_jax_at_full_width():
    tcfg, jcfg = tconfigs.get_config(ARCH), jget_config(ARCH)
    for active in (False, True):
        assert ttf.count_params(tcfg, active_only=active) \
            == jtf.count_params(jcfg, active_only=active)
    assert tcfg.active_param_count() == jcfg.active_param_count() < tcfg.param_count()


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("norm_topk", [True, False])
@pytest.mark.parametrize("t", [24, 512])
def test_routing_matches_jax(norm_topk, t):
    """The reference's routing (moe.py's fp32 product, softmax, top_k,
    renormalisation, Switch loss) on the same x and router: idx equal but
    at near-ties, which are counted and bounded; weights and aux 1e-6."""
    rng = np.random.default_rng(t)
    jcfg, tcfg = _cfgs(norm_topk=norm_topk)
    mc = tcfg.moe
    w = (rng.standard_normal((tcfg.d_model, mc.n_routed)) / np.sqrt(tcfg.d_model)
         ).astype(np.float32)
    jx, tx = _pair(rng, (t, tcfg.d_model), "float32")
    logits = jx.astype(jnp.float32) @ jnp.asarray(w)
    probs = jax.nn.softmax(logits, -1)
    jweights, jidx = jax.lax.top_k(probs, mc.top_k)
    if mc.norm_topk:
        jweights = jweights / jnp.maximum(jweights.sum(-1, keepdims=True), 1e-9)
    jaux = jmoe.moe_apply(
        {"router": {"w": jnp.asarray(w)}, "routed": {
            "wg": jnp.zeros((mc.n_routed, tcfg.d_model, mc.expert_ff)),
            "wi": jnp.zeros((mc.n_routed, tcfg.d_model, mc.expert_ff)),
            "wo": jnp.zeros((mc.n_routed, mc.expert_ff, tcfg.d_model))}},
        jx[None], dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, n_shared=0)))[1]

    weights, idx, aux = tmoe.route(torch.from_numpy(w), tx, mc)
    assert weights.dtype == torch.float32 and idx.shape == (t, mc.top_k)
    top = np.sort(np.asarray(probs), -1)[:, ::-1]
    ties = top[:, mc.top_k - 1] - top[:, mc.top_k] < TIE
    assert ties.sum() <= max(1, t // 100), ties.sum()
    same = ~ties
    np.testing.assert_array_equal(idx.numpy()[same], np.asarray(jidx)[same])
    np.testing.assert_allclose(weights.numpy()[same], np.asarray(jweights)[same],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)


def test_expert_counts_are_bincount():
    flat_e = torch.from_numpy(np.random.default_rng(3).integers(0, 8, 97))
    assert torch.equal(tmoe.expert_counts(flat_e, 11),
                       torch.bincount(flat_e, minlength=11))


# --------------------------------------------------------------- dispatch
def _routes(rng, t, e, k, skew):
    """(T, k) distinct experts a token, drawn with weights ~ skew ** -i, and
    their combine weights, as numpy."""
    p = np.asarray([skew ** -i for i in range(e)], np.float64)
    idx = np.stack([rng.choice(e, k, replace=False, p=p / p.sum())
                    for _ in range(t)]).astype(np.int32)
    w = rng.random((t, k)).astype(np.float32)
    return idx, w / w.sum(-1, keepdims=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,skew", [(40, 1.0), (64, 3.0), (200, 1.0), (300, 2.0)])
def test_capacity_ffn_matches_jax(dtype, t, skew):
    """The reference's `_capacity_ffn` on the same routes: T <= 64 never
    drops, however skewed; past 64 a skewed router drops rows."""
    rng = np.random.default_rng(t)
    jcfg, tcfg = _cfgs(dtype)
    mc = tcfg.moe
    jp, tp = _layer0_moe(jcfg, tcfg)
    jx, tx = _pair(rng, (t, tcfg.d_model), dtype)
    idx, w = _routes(rng, t, mc.n_routed, mc.top_k, skew)
    want = jmoe._capacity_ffn(jp["routed"], jcfg.moe, jx,
                              jnp.asarray(w, DTYPES[dtype][0]), jnp.asarray(idx),
                              jcfg.act)
    got = tmoe._capacity_ffn(tp["routed"], mc, tx, torch.from_numpy(w).to(tx.dtype),
                             torch.from_numpy(idx).long(), tcfg.act)
    tol = FFN_TOL[dtype]
    _close(got, want, dict(rtol=tol, atol=tol))
    cap = tmoe.capacity(t, mc)
    dropped = int((np.bincount(idx.ravel(), minlength=mc.n_routed) - cap)
                  .clip(min=0).sum())
    _, _, slot = tmoe._dispatch(tx, torch.from_numpy(idx).long(), mc.n_routed, cap)
    assert int((slot == mc.n_routed * cap).sum()) == dropped
    assert (dropped > 0) == (t > 64 and skew > 1), (t, skew, dropped)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", [[3, 0, 5, 0, 0, 2, 7, 0],   # empty groups
                                   [0, 0, 0, 17, 0, 0, 0, 0],  # one group
                                   [4, 4, 2, 0, 1, 0, 0, 0]])  # rows past the groups
def test_ragged_dot_matches_jax(dtype, sizes):
    rng = np.random.default_rng(len(sizes) + sum(sizes))
    jx, tx = _pair(rng, (17, 24), dtype)
    jw, tw = _pair(rng, (8, 24, 12), dtype)
    gs = np.asarray(sizes, np.int32)
    want = jax.lax.ragged_dot(jx, jw, jnp.asarray(gs))
    got = tmoe.ragged_dot(tx, tw, torch.from_numpy(gs))
    tol = FFN_TOL[dtype]
    _close(got, want, dict(rtol=tol, atol=tol))
    assert not got[sum(sizes):].any()


# ---------------------------------------------------------------- moe_apply
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["capacity", "ragged"])
@pytest.mark.parametrize("shared", [dict(), dict(shared_gate=False),
                                    dict(n_shared=0, shared_ff=0,
                                         shared_gate=False)],
                         ids=["gated-shared", "shared", "no-shared"])
def test_moe_apply_matches_jax(dtype, impl, shared):
    rng = np.random.default_rng(11)
    jcfg, tcfg = _cfgs(dtype, impl=impl, **shared)
    jp, tp = _layer0_moe(jcfg, tcfg, seed=5)
    assert ("shared" in tp, "shared_gate" in tp) == (
        bool(tcfg.moe.n_shared), tcfg.moe.shared_gate)
    jx, tx = _pair(rng, (2, 40, tcfg.d_model), dtype)
    want, jaux = jmoe.moe_apply(jp, jx, jcfg)
    got, aux = tmoe.moe_apply(tp, tx, tcfg)
    assert got.dtype == tx.dtype and aux.dtype == torch.float32 and aux.shape == ()
    _close(got, want, MODEL_TOL[dtype])
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6, atol=1e-6)


def test_parallel_names_the_distributed_combine():
    _, tcfg = _cfgs()
    _, tp = _layer0_moe(*_cfgs())
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        tmoe.moe_apply(tp, torch.zeros(1, 2, tcfg.d_model), tcfg,
                       parallel=object())


# -------------------------------------------------------------------- model
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["capacity", "ragged"])
def test_forward_logits_and_aux_match_jax(dtype, impl):
    jcfg, tcfg = _cfgs(dtype, impl=impl)
    jparams = jtf.init_lm(jax.random.PRNGKey(0), jcfg)
    tparams = ttf.params_from_jax(_np(jparams), tcfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 12))
    want, _, jaux = jtf.forward(jparams, jcfg, jnp.asarray(toks, jnp.int32))
    with torch.inference_mode():
        got, _, aux = ttf.forward(tparams, tcfg, torch.from_numpy(toks))
    assert got.shape == (2, 12, tcfg.padded_vocab) and got.dtype == DTYPES[dtype][1]
    _close(got, want, MODEL_TOL[dtype], "logits")
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), **MODEL_TOL[dtype])


@pytest.mark.parametrize("impl", ["ragged", "capacity"])
def test_prefill_and_decode_match_a_full_forward(impl):
    """fp32, as the reference holds its own cache plumbing
    (tests/test_smoke_archs.py): prefill of 8 tokens, then one decode step
    a token, against one forward over all 12 (capacity: no drop at T <= 64)."""
    _, tcfg = _cfgs("float32", impl=impl)
    params = ttf.init_lm(tcfg, seed=3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab, (2, 12)))
    with torch.inference_mode():
        full, _, _ = ttf.forward(params, tcfg, toks)
        caches = ttf.init_caches(tcfg, 2, 12, device="cpu")
        pre, caches, _ = ttf.forward(params, tcfg, toks[:, :8], caches=caches, start=0)
        torch.testing.assert_close(pre[:, -1], full[:, 7], **MODEL_TOL["float32"])
        for i in range(8, 12):
            step, caches, _ = ttf.forward(params, tcfg, toks[:, i:i + 1], caches=caches)
            torch.testing.assert_close(step[:, 0], full[:, i], **MODEL_TOL["float32"])


def test_compiled_steps_refuse_the_ragged_dispatch():
    """A ragged step reads its group sizes on the host: compiling it raises
    on any device, naming the grouped GEMM's ROADMAP item; eager it runs."""
    _, tcfg = _cfgs(impl="ragged")
    for make in (lambda: graph.compile_prefill(tsteps.make_prefill_step(tcfg, 8)),
                 lambda: graph.compile_decode(tsteps.make_decode_step(tcfg))):
        with pytest.raises(ValueError, match="ROADMAP B5"):
            make()
    params = ttf.init_lm(tcfg, seed=1, device="cpu")
    with torch.inference_mode():
        logits, caches = tsteps.make_prefill_step(tcfg, 8)(
            params, {"tokens": torch.zeros(1, 4, dtype=torch.long)})
    assert logits.shape == (1, tcfg.padded_vocab) and int(caches["pos"]) == 4
