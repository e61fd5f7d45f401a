"""The port's int8 gradient compression, GPipe pipeline and elastic
restart on the CPU, with gloo, against the reference's.

Rank processes share a file rendezvous under the test's temporary
directory; the reference runs in a JAX subprocess of its own on a fake
two-device mesh (``XLA_FLAGS=--xla_force_host_platform_device_count``).
`compressed_allreduce` on a (2, 1) mesh: the mean and the error state of
the same gradients on both ranks against the reference's, and of other
gradients on each rank against the int8 arithmetic in numpy.
`pipeline_apply`: tests/test_distributed.py's two-stage case against the
reference's output. The elastic restart: a (2, 1) run checkpoints, one
process resumes it on `largest_healthy_mesh(1, 1)` and trains on, as
tests/test_distributed.py's restart does."""

import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.errors import BudgetError as RefBudgetError
from repro.faults import EngineDegrade as RefDegrade
from repro.runtime import elastic as ref_elastic
from repro_torch.errors import BudgetError
from repro_torch.faults.models import EngineDegrade
from repro_torch.runtime import elastic

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 240

_REF = """
import pickle, sys
import jax, numpy as np
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh
from repro.launch.mesh import make_test_mesh
from repro.optim.compress import compressed_allreduce, init_error_feedback
from repro.runtime.pipeline import pipeline_apply

res = {}
rng = np.random.default_rng(5)
grads = {"w": rng.standard_normal((64, 64)).astype(np.float32),
         "b": (1e-3 * rng.standard_normal(33)).astype(np.float32)}
err = {"w": (1e-3 * rng.standard_normal((64, 64))).astype(np.float32),
       "b": np.zeros(33, np.float32)}
mesh = make_test_mesh(2, 1)
with mesh:
    mean, new_err = compressed_allreduce(grads, err, mesh, ("data",))
res["grads"], res["err"] = grads, err
res["mean"] = jax.tree.map(np.asarray, mean)
res["new_err"] = jax.tree.map(np.asarray, new_err)
devs = np.array(jax.devices()[:2]).reshape(2,)
pmesh = Mesh(devs, ("pod",), axis_types=(AxisType.Auto,))
w = jnp.stack([jnp.eye(4) * 2.0, jnp.eye(4) * 3.0])
xs = jnp.arange(4 * 8 * 4, dtype=jnp.float32).reshape(4, 8, 4)
res["pipeline"] = np.asarray(pipeline_apply(pmesh, 2, lambda wi, x: x @ wi, w, xs))
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
"""

_RANK = """
import dataclasses, pickle, sys
import numpy as np, torch
import torch.distributed as dist

torch.set_num_threads(1)
rank, world, rdzv, data, out, ckpt = (int(sys.argv[1]), int(sys.argv[2]),
                                      sys.argv[3], sys.argv[4], sys.argv[5],
                                      sys.argv[6])
dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank,
                        world_size=world)
from torch.distributed.device_mesh import DeviceMesh
from repro_torch import tree as T
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import steps as ST
from repro_torch.models.transformer import init_lm
from repro_torch.optim import adamw, compress
from repro_torch.runtime.pipeline import pipeline_apply
from repro_torch.sharding import collectives, fsdp, rules
from repro_torch.sharding.api import make_parallel

res = {}
mesh = make_test_mesh(2, 1)
par = make_parallel(mesh)

# the elastic run first: its loss history and checkpoint
cfg = dataclasses.replace(get_smoke("qwen2-1.5b"), dtype="float32")
params = init_lm(cfg, seed=0, device="cpu")
held = fsdp.held_specs(mesh, params)
p = rules.shard_tree(params, held, mesh)
o = adamw.init(p)
opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=100,
                            weight_decay=0.0)
g = np.random.default_rng(7)
batch = {"tokens": torch.from_numpy(g.integers(0, cfg.vocab, (8, 32))),
         "labels": torch.from_numpy(g.integers(0, cfg.vocab, (8, 32)))}
step = ST.make_train_step(cfg, opt_cfg, par, microbatches=1)
losses = []
for i in range(4):
    p, o, m = step(p, o, batch)
    losses.append(float(m["loss"]))
CheckpointManager(ckpt).save(4, {"params": p, "opt_state": o}, blocking=True,
                             shardings={"params": held,
                                        "opt_state": fsdp.opt_held_specs(held)},
                             parallel=par)
res["losses"] = losses
res["held"] = tuple(p["embed"]["w"].shape)
torch.save(batch, f"{ckpt}/batch.pt")

with open(data, "rb") as f:
    ref = pickle.load(f)
def tt(tree):
    return T.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)

grads, err = tt(ref["grads"]), tt(ref["err"])
collectives.reset()
mean, new_err = compress.compressed_allreduce(grads, err, mesh, ("data",))
res["same"] = (T.tree_map(lambda t: t.numpy(), mean),
               T.tree_map(lambda t: t.numpy(), new_err))
res["collectives"] = {k: dict(v) for k, v in collectives.COLLECTIVES.items()}
own = T.tree_map(lambda t: t * (rank + 1) + rank, grads)
mean, new_err = compress.compressed_allreduce(
    own, compress.init_error_feedback(own), par, ("data",))
res["own"] = (T.tree_map(lambda t: t.numpy(), own),
              T.tree_map(lambda t: t.numpy(), mean),
              T.tree_map(lambda t: t.numpy(), new_err))

pmesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("pod",))
w = torch.stack([torch.eye(4) * 2.0, torch.eye(4) * 3.0])
xs = torch.arange(4 * 8 * 4, dtype=torch.float32).reshape(4, 8, 4)
res["pipeline"] = pipeline_apply(pmesh, 2, lambda wi, x: x @ wi, w, xs).numpy()
res["pipeline_own"] = pipeline_apply(pmesh, 2, lambda wi, x: x @ wi,
                                     w[rank:rank + 1], xs[:3]).numpy()
with open(f"{out}.{rank}", "wb") as f:
    pickle.dump(res, f)
dist.destroy_process_group()
"""

_RESUME = """
import dataclasses, json, sys, torch
import torch.distributed as dist

torch.set_num_threads(1)
rdzv, ckpt = sys.argv[1], sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=0,
                        world_size=1)
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.configs import get_smoke
from repro_torch.models import steps as ST
from repro_torch.models.transformer import init_lm
from repro_torch.optim import adamw
from repro_torch.runtime.elastic import largest_healthy_mesh, resume_on_mesh
from repro_torch.sharding.api import make_parallel

cfg = dataclasses.replace(get_smoke("qwen2-1.5b"), dtype="float32")
like = init_lm(cfg, device="meta")
mesh = largest_healthy_mesh(1, 1)
step_r, p, o = resume_on_mesh(CheckpointManager(ckpt), mesh, like,
                              adamw.init(like))
opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=100,
                            weight_decay=0.0)
step = ST.make_train_step(cfg, opt_cfg, make_parallel(mesh), microbatches=1)
batch = torch.load(f"{ckpt}/batch.pt")
losses = []
for i in range(4):
    p, o, m = step(p, o, batch)
    losses.append(float(m["loss"]))
print(json.dumps({"step": step_r, "shape": list(mesh.mesh.shape),
                  "count": int(o["count"]), "losses": losses}))
dist.destroy_process_group()
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1", **extra)
    return env


def _wait(procs, what: str) -> list[str]:
    """Every process to its end within TIMEOUT, or killed; their stdouts."""
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
    return [out for out, _ in outs]


def _popen(args, env):
    return subprocess.Popen([sys.executable, "-c", *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the two ranks at once (the ranks wait
    for the reference's file only after their training run), then the
    elastic resume in one process."""
    tmp = tmp_path_factory.mktemp("cp")
    ref_path, ckpt = tmp / "ref.pkl", tmp / "ckpt"
    procs = [_popen([textwrap.dedent(_REF), str(ref_path)],
                    _env(XLA_FLAGS="--xla_force_host_platform_device_count=2",
                         JAX_PLATFORMS="cpu"))]
    _wait(procs, "reference")
    ranks = [_popen([textwrap.dedent(_RANK), str(r), "2", str(tmp / "rdzv"),
                     str(ref_path), str(tmp / "out"), str(ckpt)], _env())
             for r in range(2)]
    _wait(ranks, "rank")
    (resumed,) = _wait([_popen([textwrap.dedent(_RESUME),
                                str(tmp / "rdzv1"), str(ckpt)], _env())],
                       "resume")
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    out = []
    for rank in range(2):
        with open(f"{tmp / 'out'}.{rank}", "rb") as f:
            out.append(pickle.load(f))
    import json
    return ref, out, json.loads(resumed.strip().splitlines()[-1])


def test_compressed_allreduce_matches_the_reference(runs):
    """The same gradients and residuals on both ranks: the mean and the new
    residual equal the reference's bit for bit; one MAX of the scales and
    an int32 SUM a leaf, 4 bytes a word."""
    ref, ranks, _ = runs
    for r in ranks:
        mean, new_err = r["same"]
        for key in ("w", "b"):
            np.testing.assert_array_equal(mean[key], ref["mean"][key])
            np.testing.assert_array_equal(new_err[key], ref["new_err"][key])
        coll = r["collectives"]
        assert coll["compress all_reduce"]["calls"] == 3
        assert coll["compress all_reduce"]["bytes"] == 4 * (64 * 64 + 33) + 4 * 2


def test_compressed_allreduce_of_distinct_gradients(runs):
    """Each rank its own gradients: the mean is the reference's int8
    arithmetic (the ints summed, dequantized with the largest scale, over
    2; not the true mean where the ranks' scales differ), the same on both
    ranks; the residual is the rank's own."""
    _, ranks, _ = runs
    own = [r["own"][0] for r in ranks]
    for key in ("w", "b"):
        scales = [np.maximum(np.abs(g[key]).max(), 1e-12) / np.float32(127.0)
                  for g in own]
        qs = [np.clip(np.round(g[key] / s), -127, 127).astype(np.int32)
              for g, s in zip(own, scales)]
        want = (qs[0] + qs[1]).astype(np.float32) * max(scales) / 2
        for r, g, q, s in zip(ranks, own, qs, scales):
            np.testing.assert_allclose(r["own"][1][key], want, rtol=1e-6,
                                       atol=1e-6 * max(scales))
            np.testing.assert_allclose(r["own"][2][key],
                                       g[key] - q.astype(np.float32) * s,
                                       rtol=1e-6, atol=1e-6 * s)
        np.testing.assert_array_equal(ranks[0]["own"][1][key],
                                      ranks[1]["own"][1][key])


def test_pipeline_matches_the_reference(runs):
    """tests/test_distributed.py's two-stage pipeline of affine maps: every
    rank returns the reference's output, xs * 6; with each rank given only
    its own stage (leading dim 1) and 3 microbatches, the same."""
    ref, ranks, _ = runs
    xs = np.arange(4 * 8 * 4, dtype=np.float32).reshape(4, 8, 4)
    for r in ranks:
        np.testing.assert_array_equal(r["pipeline"], ref["pipeline"])
        np.testing.assert_allclose(r["pipeline"], xs * 6.0, rtol=1e-5)
        np.testing.assert_allclose(r["pipeline_own"], xs[:3] * 6.0, rtol=1e-5)


def test_elastic_restart_on_a_smaller_mesh(runs):
    """Four steps on (2, 1), each rank holding half the embedding; the
    checkpoint of global leaves resumed by one process on
    largest_healthy_mesh(1, 1), four steps more: the losses fall overall
    and no step raises the loss by 0.05 (tests/test_distributed.py's)."""
    _, ranks, resumed = runs
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["held"][1] * 2 == 128           # d_model over 2 ranks
    assert resumed["step"] == 4 and resumed["shape"] == [1, 1]
    assert resumed["count"] == 8
    losses = ranks[0]["losses"] + resumed["losses"]
    assert losses[-1] < losses[0], losses
    assert (np.diff(losses) < 0.05).all(), losses


def test_healthy_shape_and_survivors_equal_the_reference():
    """tests/test_faults.py's cases, each against the reference's."""
    for n, mp in ((8, 4), (7, 2), (5, 4), (4, 4), (1, 1), (2, 1)):
        assert elastic.healthy_shape(n, mp) == ref_elastic.healthy_shape(n, mp)
    assert elastic.healthy_shape(7, 2) == (3, 2)
    with pytest.raises(BudgetError):
        elastic.healthy_shape(3, 4)
    with pytest.raises(RefBudgetError):
        ref_elastic.healthy_shape(3, 4)
    for kw, n in ((dict(surviving_frac=0.75), 6), (dict(surviving_frac=0.25), 2),
                  (dict(surviving_devices=3), 8), (dict(surviving_devices=12), 8)):
        assert (elastic.surviving_devices(EngineDegrade(**kw), n)
                == ref_elastic.surviving_devices(RefDegrade(**kw), n))
    assert elastic.surviving_devices(EngineDegrade(surviving_devices=12), 8) == 8


def test_largest_healthy_mesh_needs_a_group():
    with pytest.raises(ValueError, match="process group"):
        elastic.largest_healthy_mesh(1, 1)
