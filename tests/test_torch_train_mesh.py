"""The port's train step on a mesh on the CPU, with gloo.

The ranks are processes spawned with a file rendezvous under the test's
temporary directory, against the reference's sharded train step on a fake
(2, 2) mesh in a JAX subprocess of its own
(``XLA_FLAGS=--xla_force_host_platform_device_count``, as
tests/test_distributed.py runs it): the same params (the reference's
``init_lm``), the same batch (numpy, seeded, its masked labels all in the
first data rank's rows), Qwen1.5-MoE-A2.7B at smoke size in fp32. The port
holds the fsdp shards of params and AdamW state, splits the batch over
the data axes and combines the experts' partial sums over tp; the loss is
held within 1e-4 relative, the gathered params within 2e-4, the one-device
step within 5e-3 (tests/test_distributed.py's), both combines give the
same gradients and the remat policies the same step. Then the launcher on
a two-rank group under each flag, and ``--mesh single`` refused."""

import json
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch.distributed as dist

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 240
B, S, MB = 8, 16, 2
LOSS_RTOL, PARAM_TOL, ONE_DEVICE_TOL = 1e-4, 2e-4, 5e-3
OPT = dict(lr=1e-2, warmup_steps=0, total_steps=10, eps=1e-3, clip_norm=1.0)
SETTINGS = (("active", "full"), ("passive", "full"), ("active", "none"),
            ("active", "dots"))

_REF = """
import dataclasses, pickle, sys
import jax, numpy as np
from jax.sharding import AxisType, Mesh
from repro.configs import get_smoke
from repro.models import steps as ST
from repro.models.transformer import init_lm
from repro.optim import adamw
from repro.sharding import rules
from repro.sharding.api import make_parallel

B, S, MB, OPT = {b}, {s}, {mb}, {opt}
cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), dtype="float32")
params = init_lm(jax.random.PRNGKey(0), cfg)
opt_cfg = adamw.AdamWConfig(**OPT)
opt = adamw.init(params)
rng = np.random.default_rng(3)
seq = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
labels = seq[:, 1:].copy()
labels[0, :5] = -1                  # every masked label in data rank 0's rows
labels[1, 2:] = -1
batch = {{"tokens": seq[:, :-1], "labels": labels}}
res = {{"params": jax.tree.map(np.asarray, params), "batch": batch}}
one = jax.jit(ST.make_train_step(cfg, opt_cfg, None, microbatches=MB))
_, _, m = one(params, opt, batch)
res["one_device"] = {{k: float(v) for k, v in m.items()}}
devs = np.array(jax.devices()[:4]).reshape(2, 2)
mesh = Mesh(devs, ("data", "model"), axis_types=(AxisType.Auto,) * 2)
par = make_parallel(mesh)
p_sh = rules.params_shardings(mesh, jax.eval_shape(lambda: params))
o_sh = rules.opt_state_shardings(mesh, jax.eval_shape(lambda: opt))
b_sh = rules.batch_shardings(mesh, jax.eval_shape(lambda: batch))
step = jax.jit(ST.make_train_step(cfg, opt_cfg, par, microbatches=MB),
               in_shardings=(p_sh, o_sh, b_sh))
with mesh:
    p2, o2, m2 = step(jax.device_put(params, p_sh), jax.device_put(opt, o_sh),
                      jax.device_put(batch, b_sh))
res["sharded"] = {{k: float(v) for k, v in m2.items()}}
res["sharded_params"] = jax.tree.map(np.asarray, p2)
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
"""

_RANK = """
import dataclasses, pickle, sys
import numpy as np, torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, rdzv, data, out = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
MB, OPT, SETTINGS = {mb}, {opt}, {settings}
dist.init_process_group("gloo", init_method=f"file://{{rdzv}}", rank=rank,
                        world_size=world)
from repro_torch import tree as T
from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import steps as ST
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw
from repro_torch.sharding import collectives, fsdp, rules
from repro_torch.sharding.api import make_parallel

with open(data, "rb") as f:
    ref = pickle.load(f)
cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), dtype="float32")
params0 = TF.params_from_jax(ref["params"], cfg, device="cpu")
batch = {{k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in ref["batch"].items()}}
mesh = make_test_mesh(2, 2)
held = fsdp.held_specs(mesh, params0)
res = {{"coord": list(mesh.get_coordinate())}}

def whole(tree, par):
    return {{path: fsdp.gather_leaf_global(leaf, rules._at(held, path), par,
                                          "test").numpy()
            for path, leaf in T.flatten_with_keys(tree).items()}}

for strat, remat in SETTINGS:
    par = make_parallel(mesh, psum_strategy=strat, remat=remat)
    p = rules.shard_tree(T.tree_map(torch.clone, params0), held, mesh)
    o = adamw.init(p)
    shapes = {{k: tuple(v.shape) for k, v in T.flatten_with_keys(p).items()}}
    step = ST.make_train_step(cfg, adamw.AdamWConfig(**OPT), par,
                              microbatches=MB)
    collectives.reset()
    p, o, m = step(p, o, batch)
    res[(strat, remat)] = {{
        "metrics": {{k: float(v) for k, v in m.items()}},
        "params": whole(p, par), "held": shapes,
        "collectives": {{k: dict(v) for k, v in
                         collectives.COLLECTIVES.items()}}}}
    if remat == "full":
        split = par.split_batch()
        local = rules.shard_tree(batch, rules.batch_shardings(mesh, batch), mesh)
        full = fsdp.gather(rules.shard_tree(params0, held, mesh), held, split)
        _, _, g = ST.loss_and_grads(full, cfg, local, split)
        res[("grads", strat)] = whole(fsdp.reduce_grads(g, held, split), split)

# the data-axis gather with a gradient: a replicated batch, its tokens cut
# over the data axes inside the MoE and gathered back; the routed weights'
# gradients summed over every rank are one process's
from repro_torch.models import moe as M
moe_p = T.tree_map(lambda t: t.detach().requires_grad_(True),
                   params0["layers"][0]["moe"])
x = torch.from_numpy(np.random.default_rng(9).standard_normal(
    (4, 16, cfg.d_model)).astype(np.float32))
w_out = torch.from_numpy(np.random.default_rng(10).standard_normal(
    (4, 16, cfg.d_model)).astype(np.float32))
routed = [moe_p["routed"][n] for n in ("wg", "wi", "wo")]
collectives.reset()
y = M.moe_apply(moe_p, x, cfg, make_parallel(mesh))[0]
summed = [g.clone() for g in torch.autograd.grad((y * w_out).sum(), routed)]
for g in summed:
    dist.all_reduce(g)
one = torch.autograd.grad((M.moe_apply(moe_p, x, cfg)[0] * w_out).sum(), routed)
res["gather_rows"] = ([g.numpy() for g in summed], [g.numpy() for g in one],
                      sorted(collectives.COLLECTIVES))
with open(f"{{out}}.{{rank}}", "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
"""

_LAUNCH = """
import json, sys, torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, rdzv, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"file://{{rdzv}}", rank=rank,
                        world_size=world)
import os, signal
from repro_torch.data import SyntheticLM
from repro_torch.launch.train import main

base = ["--arch", "qwen2-moe-a2.7b", "--smoke", "--batch", "4", "--seq", "16",
        "--device", "cpu", "--lr", "5e-3", "--ckpt-every", "5"]
real_batch = SyntheticLM.torch_batch

def preempting(self, step, device="cuda"):
    # a SIGTERM to this rank alone while it fetches step {preempt_at}'s batch
    if step == {preempt_at}:
        os.kill(os.getpid(), signal.SIGTERM)
    return real_batch(self, step, device)

out = {{}}
for name, ckpt, flags in {runs}:
    record = {{}}
    SyntheticLM.torch_batch = (preempting if name == "preempt" and rank == 1
                               else real_batch)
    res = main(base + ["--ckpt-dir", f"{{tmp}}/{{ckpt}}"] + flags, record=record)
    tr = record["trainer"]
    out[name] = {{"result": res, "start": tr.start_step,
                 "routed_ff": tr.params["layers"][0]["moe"]["routed"]["wg"].shape[-1],
                 "tp": record["parallel"].tp_size,
                 "remat": record["parallel"].remat,
                 "psum": record["parallel"].psum_strategy,
                 "preempted_here": tr._preempted,
                 "latest": tr.ckpt.latest_step()}}
with open(f"{{tmp}}/launch.{{rank}}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""

#: (name, checkpoint directory, flags): the launcher's runs on a two-rank
#: group, in order; the first four log their loss at step 10, and the
#: resume goes on from the default run's last checkpoint; rank 1 alone is
#: signalled in the "preempt" run, and the run after it resumes its
#: checkpoint
PREEMPT_AT = 3
LAUNCH_RUNS = (
    ("default", "default", ["--steps", "10"]),
    ("passive", "passive", ["--steps", "10", "--psum", "passive"]),
    ("remat_none", "remat_none", ["--steps", "10", "--remat", "none"]),
    ("remat_dots", "remat_dots", ["--steps", "10", "--remat", "dots"]),
    ("resume", "default", ["--steps", "12", "--resume"]),
    ("preempt", "preempt", ["--steps", "10"]),
    ("preempt_resume", "preempt", ["--steps", "6", "--resume"]),
)


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", **extra)
    return env


def _spawn(script: str, world: int, *args) -> list:
    return [subprocess.Popen([sys.executable, "-c", script, str(rank),
                              str(world), *map(str, args)],
                             env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for rank in range(world)]


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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's step (one device and the (2, 2) mesh), then the
    port's four ranks; the launcher's two ranks run meanwhile."""
    tmp = tmp_path_factory.mktemp("mesh")
    fmt = dict(b=B, s=S, mb=MB, opt=OPT, settings=SETTINGS)
    launch = _spawn(textwrap.dedent(_LAUNCH.format(
        runs=LAUNCH_RUNS, preempt_at=PREEMPT_AT)), 2, tmp / "rdzv_launch", tmp)
    ref_path = tmp / "ref.pkl"
    try:
        ref_run = subprocess.run(
            [sys.executable, "-c", textwrap.dedent(_REF.format(**fmt)),
             str(ref_path)],
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                     JAX_PLATFORMS="cpu"),
            capture_output=True, text=True, timeout=TIMEOUT)
        assert ref_run.returncode == 0, f"reference:\n{ref_run.stderr}"
        ranks = _spawn(textwrap.dedent(_RANK.format(**fmt)), 4,
                       tmp / "rdzv_step", ref_path, tmp / "out")
        _wait(ranks, "rank")
    finally:
        _wait(launch, "launcher rank")
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    out = []
    for rank in range(4):
        with open(f"{tmp / 'out'}.{rank}", "rb") as f:
            out.append(pickle.load(f))
    launched = [json.loads((tmp / f"launch.{r}.json").read_text())
                for r in range(2)]
    return ref, out, launched, tmp


def _ref_params(ref, key="sharded_params"):
    import dataclasses
    from repro_torch import tree as T
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as TF
    cfg = dataclasses.replace(get_smoke("qwen2-moe-a2.7b"), dtype="float32")
    return {k: v.numpy() for k, v in T.flatten_with_keys(
        TF.params_from_jax(ref[key], cfg, device="cpu")).items()}


def test_sharded_step_matches_the_reference_mesh(runs):
    """Loss within 1e-4 relative and every updated param within 2e-4 of
    the reference's step on its (2, 2) mesh; every metric equal on all four
    ranks; within 5e-3 of the one-device step."""
    ref, ranks, _, _ = runs
    want = _ref_params(ref)
    first = ranks[0][("active", "full")]
    for r in ranks:
        got = r[("active", "full")]
        assert got["metrics"] == first["metrics"]
        for path, value in got["params"].items():
            np.testing.assert_array_equal(value, first["params"][path])
    m = first["metrics"]
    for key in ("loss", "ce", "z_loss", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(m[key], ref["sharded"][key],
                                   rtol=LOSS_RTOL, err_msg=key)
    assert m["grad_norm"] > OPT["clip_norm"]            # clipping was active
    assert set(first["params"]) == set(want)
    for path, value in first["params"].items():
        np.testing.assert_allclose(value, want[path], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=path)
    assert abs(m["loss"] - ref["one_device"]["loss"]) < ONE_DEVICE_TOL * max(
        1.0, abs(ref["one_device"]["loss"]))


def test_ranks_hold_their_fsdp_shards(runs):
    """Each rank holds half of every leaf the data axes divide (the routed
    experts also half their ff, their tp block), and the step gathers the
    params, reduces the gradients and the norm, and the MoE reduces its
    load-balancing means and its block's input gradients."""
    ref, ranks, _, _ = runs
    whole = {k: v.shape for k, v in _ref_params(ref, "params").items()}
    held = ranks[0][("active", "full")]["held"]
    assert held["embed/w"] == (whole["embed/w"][0], whole["embed/w"][1] // 2)
    wg = "layers/0/moe/routed/wg"
    e, d, ff = whole[wg]
    assert held[wg] == (e, d // 2, ff // 2)
    assert held["layers/0/norm1/scale"] == whole["layers/0/norm1/scale"]
    kinds = set(ranks[0][("active", "full")]["collectives"])
    assert {"fsdp/params all_gather", "fsdp/grads all_reduce",
            "fsdp/norm all_reduce", "moe all_reduce", "moe/grad all_reduce",
            "moe/aux all_reduce", "train/labels all_reduce",
            "train/loss all_reduce"} <= kinds
    assert "moe/data all_gather" not in kinds          # the batch is cut once
    assert "moe all_gather" in ranks[0][("passive", "full")]["collectives"]


def test_active_and_passive_give_equal_gradients(runs):
    _, ranks, _, _ = runs
    for r in ranks:
        active, passive = r[("grads", "active")], r[("grads", "passive")]
        assert set(active) == set(passive)
        for path in active:
            np.testing.assert_array_equal(active[path], passive[path], path)
        np.testing.assert_allclose(r[("passive", "full")]["metrics"]["loss"],
                                   r[("active", "full")]["metrics"]["loss"],
                                   rtol=1e-6)


def test_data_axis_gather_hands_each_rank_its_rows(runs):
    """A forward with a gradient over a replicated batch on (2, 2): the MoE
    cuts its tokens over the data axes and gathers them back (``moe/data``),
    whose backward hands each rank the gradient of its rows, so that the
    routed experts' gradients, summed over every rank (the data ranks'
    rows, the tp ranks' ff blocks), are one process's."""
    _, ranks, _, _ = runs
    for r in ranks:
        summed, one, kinds = r["gather_rows"]
        assert "moe/data all_gather" in kinds
        for got, want in zip(summed, one):
            np.testing.assert_allclose(got, want, rtol=PARAM_TOL, atol=PARAM_TOL)


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_remat_changes_no_value(runs, remat):
    """A step under remat "none" or "dots" equals the "full" step bit for
    bit: its metrics and every updated param."""
    _, ranks, _, _ = runs
    for r in ranks:
        got, want = r[("active", remat)], r[("active", "full")]
        assert got["metrics"] == want["metrics"]
        for path, value in got["params"].items():
            np.testing.assert_array_equal(value, want["params"][path], path)


def test_launcher_on_a_two_rank_group(runs):
    """``--mesh local`` over two ranks: a (1, 2) mesh, the routed experts'
    ff halved, each flag reaching the Parallel; both ranks return the same
    result; the losses of the two combines and of the three remat policies
    agree at step 10; the checkpoint holds global leaves, and the resume
    cuts the ranks' shards from them and goes on from step 10."""
    _, _, launched, tmp = runs
    assert launched[0] == launched[1]
    out = launched[0]
    for name, run in out.items():
        assert run["tp"] == 2 and run["routed_ff"] == 32, name
    assert (out["default"]["psum"], out["default"]["remat"]) == ("active", "full")
    assert out["passive"]["psum"] == "passive"
    assert (out["remat_none"]["remat"], out["remat_dots"]["remat"]) == (
        "none", "dots")
    losses = {name: [h["loss"] for h in out[name]["result"]["history"]
                     if h["step"] == 10]
              for name in ("default", "passive", "remat_none", "remat_dots")}
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in losses.values())
    np.testing.assert_allclose(losses["passive"], losses["default"], rtol=1e-5)
    assert losses["remat_none"] == losses["default"] == losses["remat_dots"]
    assert (out["resume"]["start"], out["resume"]["result"]["final_step"]) == (
        10, 12)
    manifest = json.loads((tmp / "default" / "step_000010" /
                           "MANIFEST.json").read_text())
    assert manifest["leaves"]["params/layers/0/moe/routed/wg"]["shape"][-1] == 64


def test_a_signal_to_one_rank_preempts_every_rank_at_one_step(runs):
    """SIGTERM to rank 1 alone while it fetches step 3's batch: both ranks
    read the flag as set, leave the loop at step 4 and take part in the
    preemption checkpoint's gathers (else they pair a step's collectives
    with the checkpoint's, and gloo raises or hangs); the checkpoint is
    step 4's, and the resume on both ranks goes on from it."""
    _, _, launched, _ = runs
    assert launched[0] == launched[1]
    run, resumed = launched[0]["preempt"], launched[0]["preempt_resume"]
    assert run["result"]["preempted"] and run["preempted_here"]
    assert run["result"]["final_step"] == run["latest"] == PREEMPT_AT + 1
    assert (resumed["start"], resumed["result"]["final_step"]) == (
        PREEMPT_AT + 1, 6)
    assert not resumed["result"]["preempted"]


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_production_mesh_is_refused(mesh, tmp_path):
    from repro_torch.launch.train import main
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
              "--ckpt-dir", str(tmp_path), "--mesh", mesh])
    assert not dist.is_initialized()
