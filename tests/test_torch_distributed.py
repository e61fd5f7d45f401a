"""The port's tensor-parallel partial-sum combines on the CPU, with gloo.

Each mesh is a set of rank processes, spawned with a file rendezvous under
the test's temporary directory (so that test workers never share a port),
against the reference's sharded functions on a fake multi-device mesh in a
subprocess of its own (``XLA_FLAGS=--xla_force_host_platform_device_count``,
as tests/test_distributed.py runs them): the MoE's active (all-reduce) and
passive (all-gather and a local add) combines at world 2 and 4, flash
decoding over a sequence-sharded cache at world 2 (a prompt shorter than a
rank's block included, so that one rank sees no key), and the sharding
rules' specs against the reference's on every leaf of every smoke arch."""

import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as j_get_smoke
from repro.configs import list_archs
from repro.models import transformer as jtf
from repro.sharding import rules as jrules
from repro_torch.configs import get_smoke as t_get_smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as ttf
from repro_torch.sharding import api as tapi
from repro_torch.sharding import rules as trules
from repro_torch import tree as T

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 2e-4                      # tests/test_distributed.py's, fp32
MAX_LEN = 64
PROMPTS = (MAX_LEN - 3, 10)     # 10 < s_loc = 32: rank 1 sees no key
DECODES = 3
TIMEOUT = 120

_REF = """
import dataclasses, pickle, sys
import jax, numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs import get_smoke
from repro.models import moe as M
from repro.models import steps as ST
from repro.models.transformer import init_lm
from repro.sharding.api import Parallel, make_parallel

MAX_LEN, PROMPTS, DECODES = {max_len}, {prompts}, {decodes}

def mesh(d, m):
    devs = np.array(jax.devices()[:d * m]).reshape(d, m)
    return Mesh(devs, ("data", "model"), axis_types=(AxisType.Auto,) * 2)

res = {{}}
cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), dtype="float32")
p = M.moe_init(jax.random.PRNGKey(0), cfg)
x = np.random.default_rng(0).standard_normal((4, 16, cfg.d_model)).astype(np.float32)
res["moe_params"] = jax.tree.map(np.asarray, p)
res["moe_x"] = x
for d, m in ((1, 2), (2, 2)):
    for strat in ("active", "passive"):
        par = Parallel(mesh=mesh(d, m), dp_axes=("data",), psum_strategy=strat)
        f = jax.jit(lambda pp, xx: M.moe_apply(pp, xx, cfg, par)[0])
        with par.mesh:
            res[("moe", d * m, strat)] = np.asarray(f(p, x))
gcfg = dataclasses.replace(get_smoke("granite-8b"), dtype="float32")
gp = init_lm(jax.random.PRNGKey(0), gcfg)
res["granite_params"] = jax.tree.map(np.asarray, gp)
toks = np.random.default_rng(1).integers(0, gcfg.vocab, (4, MAX_LEN)).astype(np.int32)
res["granite_tokens"] = toks
par = make_parallel(mesh(1, 2), flash_decode=True)
prefill = jax.jit(ST.make_prefill_step(gcfg, MAX_LEN, par))
decode = jax.jit(ST.make_decode_step(gcfg, par))
for n in PROMPTS:
    with par.mesh:
        logits, caches = prefill(gp, {{"tokens": toks[:, :n]}})
        seq = [np.asarray(logits)]
        for i in range(DECODES):
            logits, caches = decode(gp, caches, toks[:, n + i:n + i + 1])
            seq.append(np.asarray(logits))
    res[("flash", n)] = np.stack(seq)
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
"""

_RANK = """
import dataclasses, pickle, sys
import numpy as np, torch
import torch.distributed as dist

rank, world, rdzv, data, out = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
MAX_LEN, PROMPTS, DECODES = {max_len}, {prompts}, {decodes}
dist.init_process_group("gloo", init_method=f"file://{{rdzv}}", rank=rank,
                        world_size=world)
moved = {{"all_reduce": 0, "all_gather_into_tensor": 0}}

def counting(name):                 # bytes each call moves, counted here
    fn = getattr(dist, name)
    def call(t, *args, **kwargs):
        moved[name] += t.numel() * t.element_size()
        return fn(t, *args, **kwargs)
    setattr(dist, name, call)

for name in moved:
    counting(name)

from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe as M
from repro_torch.models import steps as ST
from repro_torch.models import transformer as TF
from repro_torch.sharding import collectives, rules
from repro_torch.sharding.api import Parallel, make_parallel

with open(data, "rb") as f:
    ref = pickle.load(f)
mesh = make_test_mesh(world // 2, 2)
res = {{"coord": mesh.get_coordinate()}}
cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), dtype="float32")

def to_torch(node):
    if isinstance(node, dict):
        return {{k: to_torch(v) for k, v in node.items()}}
    return torch.from_numpy(np.array(node, dtype=np.float32))

p = to_torch(ref["moe_params"])
x = torch.from_numpy(ref["moe_x"])
with torch.no_grad():
    res["moe_single"] = M.moe_apply(p, x, cfg)[0].numpy()
    cut = rules.shard_tree(p, rules.routed_specs(p, mesh), mesh)
    res["cut_ff"] = cut["routed"]["wg"].shape[2], cut["routed"]["wo"].shape[1]
    for strat in ("active", "passive"):
        par = Parallel(mesh=mesh, dp_axes=("data",), psum_strategy=strat)
        before = dict(moved)
        collectives.reset()
        res[("moe", strat)] = M.moe_apply(cut, x, cfg, par)[0].numpy()
        res[("bytes", strat)] = {{k: moved[k] - before[k] for k in moved}}
        res[("counted", strat)] = {{k: v["bytes"] for k, v in
                                    collectives.COLLECTIVES.items()}}
        res[("moe_whole", strat)] = M.moe_apply(p, x, cfg, par)[0].numpy()
    if world == 4:          # (pod 2, data 1, model 2): data over two axes
        pod = make_test_mesh(1, 2, pod=2)
        par = make_parallel(pod, psum_strategy="passive")
        res["pod"] = (par.dp_axes, par.dp_size, par.dp_rank,
                      M.moe_apply(p, x, cfg, par)[0].numpy())

    # every cache leaf cut by the reference's specs: this rank's block
    gcfg = dataclasses.replace(get_smoke("granite-8b"), dtype="float32")
    caches = TF.init_caches(gcfg, 4, MAX_LEN, device="cpu")
    for c in caches["layers"]:
        for t in c.values():
            t.copy_(torch.arange(t.numel(), dtype=t.dtype).reshape(t.shape))
    local = rules.shard_tree(caches, rules.caches_shardings(mesh, caches), mesh)
    d_i, m_i = mesh.get_coordinate()
    b_loc, s_loc = 4 // (world // 2), MAX_LEN // 2
    k = caches["layers"][0]["k"]
    want = k[d_i * b_loc:(d_i + 1) * b_loc, :, m_i * s_loc:(m_i + 1) * s_loc]
    res["cache_cut"] = (tuple(local["layers"][0]["k"].shape),
                        bool(torch.equal(local["layers"][0]["k"], want)))

    if world == 2:
        gp = TF.params_from_jax(ref["granite_params"], gcfg, device="cpu")
        toks = torch.from_numpy(ref["granite_tokens"]).long()
        fd = make_parallel(mesh, flash_decode=True)
        for n in PROMPTS:
            for label, par in (("one", None), ("flash", fd)):
                prefill = ST.make_prefill_step(gcfg, MAX_LEN, par)
                decode = ST.make_decode_step(gcfg, par)
                logits, caches = prefill(gp, {{"tokens": toks[:, :n]}})
                seq = [logits]
                for i in range(DECODES):
                    logits, caches = decode(gp, caches, toks[:, n + i:n + i + 1])
                    seq.append(logits)
                res[(label, n)] = torch.stack(seq).numpy()
            res[("kv", n)] = (caches.get(TF.KV_SHARDED, False),
                              caches["layers"][0]["k"].shape[2])
with open(f"{{out}}.{{rank}}", "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), **extra)
    return env


def _wait(procs, what: str) -> None:
    """Every process to its end within TIMEOUT, or killed."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{what} {i}:\n{err}"


def _run(args, env, what):
    out = subprocess.run(args, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert out.returncode == 0, f"{what}:\n{out.stdout}\n{out.stderr}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs, then the ranks' of both meshes, run at once."""
    tmp = tmp_path_factory.mktemp("dist")
    fmt = dict(max_len=MAX_LEN, prompts=PROMPTS, decodes=DECODES)
    ref_path = tmp / "ref.pkl"
    _run([sys.executable, "-c", textwrap.dedent(_REF.format(**fmt)),
          str(ref_path)],
         _env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
              JAX_PLATFORMS="cpu"), "reference")
    script = textwrap.dedent(_RANK.format(**fmt))
    procs, outs = [], {}
    for world in (2, 4):
        outs[world] = tmp / f"out{world}"
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, str(rank), str(world),
                 str(tmp / f"rdzv{world}"), str(ref_path), str(outs[world])],
                env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
    _wait(procs, "rank")
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    ranks = {}
    for world, out in outs.items():
        ranks[world] = []
        for rank in range(world):
            with open(f"{out}.{rank}", "rb") as f:
                ranks[world].append(pickle.load(f))
    return ref, ranks


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("strategy", ["active", "passive"])
def test_moe_combine_matches_one_process_and_reference(runs, world, strategy):
    ref, ranks = runs
    for r in ranks[world]:
        assert r["cut_ff"] == (32, 32)          # expert ff 64 over 2 ranks
        _close(r[("moe", strategy)], r["moe_single"])
        _close(r[("moe", strategy)], ref[("moe", world, strategy)])
        np.testing.assert_array_equal(r[("moe_whole", strategy)],
                                      r[("moe", strategy)])
    first = ranks[world][0][("moe", strategy)]
    for r in ranks[world][1:]:
        np.testing.assert_array_equal(r[("moe", strategy)], first)


def test_moe_combine_over_two_data_axes(runs):
    """A pod mesh's data axes ("pod", "data") get a group of their own; the
    combine equals the one-process result and the reference's."""
    ref, ranks = runs
    for rank, r in enumerate(ranks[4]):
        axes, size, dp_rank, out = r["pod"]
        assert (axes, size, dp_rank) == (("pod", "data"), 2, rank // 2)
        _close(out, r["moe_single"])
        _close(out, ref[("moe", 4, "passive")])


@pytest.mark.parametrize("world", [2, 4])
def test_passive_combine_moves_more_bytes(runs, world):
    """The bytes through the two torch.distributed calls, counted by
    patching them in the ranks: the passive controller gathers TP partials
    where the active one all-reduces one, and the combine's own counts
    agree with the patched ones."""
    _, ranks = runs
    for r in ranks[world]:
        active, passive = r[("bytes", "active")], r[("bytes", "passive")]
        assert passive["all_gather_into_tensor"] > active["all_reduce"] > 0
        assert passive["all_reduce"] == 0
        for strat in ("active", "passive"):
            counted = r[("counted", strat)]
            assert sum(counted.values()) == sum(r[("bytes", strat)].values())
        assert set(r[("counted", "active")]) == (
            {"moe all_reduce"} | ({"moe/data all_gather"} if world == 4 else set()))


@pytest.mark.parametrize("prompt", PROMPTS)
def test_flash_decode_matches_one_process_and_reference(runs, prompt):
    ref, ranks = runs
    for r in ranks[2]:
        assert r[("kv", prompt)] == (True, MAX_LEN // 2)
        _close(r[("flash", prompt)], r[("one", prompt)])
        _close(r[("flash", prompt)], ref[("flash", prompt)])
        _close(r[("one", prompt)], ref[("flash", prompt)])
    np.testing.assert_array_equal(ranks[2][0][("flash", prompt)],
                                  ranks[2][1][("flash", prompt)])


@pytest.mark.parametrize("world", [2, 4])
def test_caches_cut_along_the_port_sequence_dim(runs, world):
    _, ranks = runs
    for r in ranks[world]:
        b_loc = 4 // (world // 2)
        shape, equal = r["cache_cut"]
        assert equal and shape[0] == b_loc and shape[2] == MAX_LEN // 2


def _ref_leaf(cfg, path: list[str]) -> tuple[list, int]:
    """The reference's path of a port leaf, and its stacked leading dims."""
    if path[0] in ("layers", "enc_layers"):
        i = int(path[1])
        if path[0] == "enc_layers":
            return ["enc_periods", "sub0", *path[2:]], 1
        if i < cfg.first_dense_layers:
            return ["first", i, *path[2:]], 0
        j = (i - cfg.first_dense_layers) % len(cfg.period_layout)
        return ["periods", f"sub{j}", *path[2:]], 1
    return path, 0


def _jax_path(keys):
    return tuple(jax.tree_util.SequenceKey(k) if isinstance(k, int)
                 else jax.tree_util.DictKey(k) for k in keys)


def _get(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


_CACHE_NAMES = {"k": ["self", "k"], "v": ["self", "v"],
                "cross_k": ["cross", "k"], "cross_v": ["cross", "v"],
                "latent_pe": ["self", "latent"], "conv": ["mamba", "conv"],
                "ssm": ["mamba", "ssm"]}


@pytest.mark.parametrize("sizes", [{"data": 2, "model": 4},
                                   {"data": 1, "model": 2}],
                         ids=["data2-model4", "data1-model2"])
@pytest.mark.parametrize("arch", list_archs())
def test_rules_specs_equal_reference(arch, sizes):
    """param_spec and cache_spec on every leaf of the smoke arch's params
    and caches equal the reference's (a layer leaf's spec without the
    reference's stacked leading None; a head-major cache's spec in the
    reference's (B, S, Hkv, hd) order)."""
    jcfg, tcfg = j_get_smoke(arch), t_get_smoke(arch)
    axes = trules.axes_of(sizes)
    jaxes = {"fsdp": ("data",), "tp": "model", "dp": ("data",), "sizes": sizes}
    jparams = jax.eval_shape(lambda: jtf.init_lm(jax.random.PRNGKey(0), jcfg))
    n = 0
    for path, leaf in T.flatten_with_keys(
            ttf.init_lm(tcfg, device="meta")).items():
        keys, stacked = _ref_leaf(jcfg, path.split("/"))
        want = jrules.param_spec(_jax_path(keys), _get(jparams, keys), jaxes)
        assert trules.param_spec(path, leaf, axes) == tuple(want)[stacked:], path
        n += 1
    mem = 8 if (tcfg.encoder or tcfg.n_vision_tokens) else 0
    jcaches = jax.eval_shape(lambda: jtf.init_caches(jcfg, 2, 16, mem_len=mem))
    for path, leaf in T.flatten_with_keys(
            ttf.init_caches(tcfg, 2, 16, mem_len=mem, device="meta")).items():
        parts = path.split("/")
        if parts == ["pos"]:
            keys, stacked = ["pos"], 0
        else:
            keys, stacked = _ref_leaf(jcfg, parts[:2] + _CACHE_NAMES[parts[2]])
        want = jrules.cache_spec(_jax_path(keys), _get(jcaches, keys), jaxes)
        assert trules.cache_spec(path, leaf, axes) == tuple(want)[stacked:], path
        n += 1
    assert n > 10


def test_mesh_and_parallel_refuse_what_they_cannot_hold():
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="process group"):
        tmesh.make_test_mesh(1, 2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        tapi.Parallel(mesh=object(), dp_axes=("data",))
    assert trules.axes_of({"pod": 2, "data": 2, "model": 4})["fsdp"] == (
        "pod", "data")


@pytest.mark.parametrize("compile_name", ["compile_prefill", "compile_decode"])
def test_steps_with_a_parallel_run_eagerly(compile_name):
    """A step that calls collectives is refused by the CUDA-graph compiler
    before any capture."""
    from repro_torch.launch import graph
    from repro_torch.models import steps as tsteps
    cfg = t_get_smoke("qwen2-moe-a2.7b")
    step = (tsteps.make_prefill_step(cfg, 16, parallel=object())
            if compile_name == "compile_prefill"
            else tsteps.make_decode_step(cfg, parallel=object()))
    with pytest.raises(ValueError, match="collectives"):
        getattr(graph, compile_name)(step)


class _Mesh:
    """What the rules read of a mesh: its axis names and its rank grid."""
    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self.mesh = torch.zeros(tuple(sizes.values()))


def test_tree_shardings_follow_the_leaf_specs():
    cfg = t_get_smoke("qwen2-moe-a2.7b")
    mesh = _Mesh({"data": 2, "model": 2})
    axes = trules.mesh_axes(mesh)
    params = ttf.init_lm(cfg, device="meta")
    specs = trules.params_shardings(mesh, params)
    leaves = T.flatten_with_keys(params)
    assert len(leaves) > 10
    for path, leaf in leaves.items():
        assert trules._at(specs, path) == trules.param_spec(path, leaf, axes)
    wg = "layers/0/moe/routed/wg"
    assert trules._at(specs, wg) == (None, "data", "model")
    zero2 = trules.params_shardings(mesh, params, weight_mode="zero2")
    assert trules._at(zero2, wg) == (None, None, "model")
    opt_specs = trules.opt_state_shardings(
        mesh, {"count": torch.zeros((), device="meta"), "m": params})
    assert opt_specs["count"] == ()
    assert trules._at(opt_specs, "m/embed/w") == trules._at(specs, "embed/w")
    batch = {"tokens": torch.zeros(4, 8), "odd": torch.zeros(3, 8),
             "pos": torch.zeros(())}
    assert trules.batch_shardings(mesh, batch) == {
        "tokens": ("data", None), "odd": (None, None), "pos": ()}
