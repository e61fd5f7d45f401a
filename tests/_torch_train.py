"""Shared by the `tests/test_torch_train_*.py` parity files: one arch at
smoke size in both packages, the reference's weights carried across with
`params_from_jax` (every cross-attention gate set to a seeded nonzero value
first: the reference's init, 0, hides cross-attention from a gradient
check), a seeded numpy batch with masked labels and the arch's extra inputs,
and the reference's gradients put into the port's layout.

Tolerances are tests/test_torch_models.py's: fp32 rtol = atol = 2e-4; bf16
rtol 5e-2, atol 8e-2."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke as jget_smoke
from repro.data.pipeline import make_extra_inputs as jmake_extra_inputs
from repro.models import steps as jsteps
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch import tree as T
from repro_torch.data import make_extra_inputs
from repro_torch.models import steps as tsteps
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw

TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=5e-2, atol=8e-2)}
B, S = 2, 16
#: the train-step case's optimizer: eps 1e-3 makes the update a smooth
#: function of the gradient (at eps 1e-8 a gradient near 0 moves its
#: weight by +-lr on either side of a rounding), clipping is active
OPT = dict(lr=1e-2, warmup_steps=0, total_steps=10, eps=1e-3, clip_norm=1.0)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _with_gates(tree, seed: int):
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (jnp.asarray(rng.uniform(0.3, 1.0, np.shape(v)), v.dtype)
                        if k == "gate" else walk(v)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node
    return walk(tree)


def setup(arch: str, dtype: str, batch: int = B, seed: int = 0) -> dict:
    """Configs, weights and one batch of ``batch`` rows in both packages."""
    jcfg = dataclasses.replace(jget_smoke(arch), dtype=dtype)
    tcfg = dataclasses.replace(tconfigs.get_smoke(arch), dtype=dtype)
    jparams = _with_gates(jtf.init_lm(jax.random.PRNGKey(seed), jcfg), seed + 1)
    tparams = ttf.params_from_jax(_np(jparams), tcfg, device="cpu")
    rng = np.random.default_rng(seed + 2)
    seq = rng.integers(0, jcfg.vocab, (batch, S + 1)).astype(np.int32)
    labels = seq[:, 1:].copy()
    labels[0, :3] = -1                                   # masked labels
    jbatch = {"tokens": jnp.asarray(seq[:, :-1]), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(np.ascontiguousarray(seq[:, :-1])),
              "labels": torch.from_numpy(labels)}
    jbatch.update(jmake_extra_inputs(jcfg, batch, S, np.random.default_rng(seed)))
    tbatch.update(make_extra_inputs(tcfg, batch, S, np.random.default_rng(seed),
                                    device="cpu"))
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jbatch=jbatch, tbatch=tbatch, dtype=dtype)


def port_layout(jtree, tcfg) -> dict:
    """A tree shaped like the reference's params (gradients, optimizer
    moments) in the port's layout, fp32."""
    return ttf.params_from_jax(_np(jtree),
                               dataclasses.replace(tcfg, dtype="float32"),
                               device="cpu")


def close_trees(got, want, tol: dict, what: str) -> int:
    """Every leaf of ``got`` finite and within ``tol`` of ``want``'s; the
    leaf count."""
    g, w = T.flatten_with_keys(got), T.flatten_with_keys(want)
    assert list(g) == list(w), what
    for key in g:
        a = g[key].detach().float()
        assert torch.isfinite(a).all(), f"{what} {key}: non-finite"
        assert tuple(a.shape) == tuple(w[key].shape), f"{what} {key}"
        np.testing.assert_allclose(a.numpy(), w[key].float().numpy(),
                                   err_msg=f"{what} {key}", **tol)
    return len(g)


def check_loss_and_grads(case: dict) -> None:
    """`lm_loss`'s value, its parts and the gradient of every leaf against
    ``jax.value_and_grad`` of the reference's."""
    jcfg, tcfg, dtype = case["jcfg"], case["tcfg"], case["dtype"]
    (jloss, jparts), jgrads = jax.value_and_grad(
        lambda p: jsteps.lm_loss(p, jcfg, case["jbatch"]), has_aux=True)(
            case["jparams"])
    tloss, tparts, tgrads = tsteps.loss_and_grads(case["tparams"], tcfg,
                                                  case["tbatch"])
    tol = TOL[dtype]
    for name, got, want in [("loss", tloss, jloss)] + [
            (k, tparts[k], jparts[k]) for k in ("ce", "z_loss", "aux")]:
        assert torch.isfinite(got), name
        np.testing.assert_allclose(float(got), float(want), err_msg=name, **tol)
    n = close_trees(tgrads, port_layout(jgrads, tcfg), tol, "grad")
    assert n == len(T.leaves(case["tparams"]))
    for g, p in zip(T.leaves(tgrads), T.leaves(case["tparams"])):
        assert g.dtype == p.dtype


def check_train_step(case: dict, microbatches: int = 2) -> None:
    """One `make_train_step` step with ``microbatches`` slices (fp32
    gradient sums) and AdamW against the reference's: metrics, the new
    params and the whole optimizer state, written into the tensors given."""
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    jstep = jsteps.make_train_step(jcfg, jadamw.AdamWConfig(**OPT),
                                   microbatches=microbatches)
    tstep = tsteps.make_train_step(tcfg, tadamw.AdamWConfig(**OPT),
                                   microbatches=microbatches)
    jp, jo, jm = jstep(case["jparams"], jadamw.init(case["jparams"]),
                       case["jbatch"])
    tparams = T.tree_map(torch.clone, case["tparams"])
    topt = tadamw.init(tparams)
    before = [t.data_ptr() for t in T.leaves((tparams, topt))]
    tp, to, tm = tstep(tparams, topt, case["tbatch"])
    assert [t.data_ptr() for t in T.leaves((tp, to))] == before
    tol = TOL["float32"]
    assert set(tm) == {"loss", "ce", "z_loss", "aux", "grad_norm", "lr"}
    for key, value in tm.items():
        np.testing.assert_allclose(float(value), float(jm[key]), err_msg=key,
                                   **tol)
    assert float(tm["grad_norm"]) > OPT["clip_norm"]      # clipping was active
    close_trees(tp, port_layout(jp, tcfg), tol, "params")
    for part in ("master", "m", "v"):
        close_trees(to[part], port_layout(jo[part], tcfg), tol, part)
    assert int(to["count"]) == int(jo["count"]) == 1
    assert to["count"].dtype == torch.int32
