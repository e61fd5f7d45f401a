"""The port's training substrate against the reference's on the CPU: AdamW
(`repro_torch.optim.adamw`), the synthetic stream
(`repro_torch.data.SyntheticLM`), checkpoints
(`repro_torch.checkpoint.CheckpointManager`), the fault-tolerant loop
(`repro_torch.runtime.Trainer`), the launcher
(`repro_torch.launch.train`) and the two examples. The counterparts of
tests/test_infra.py and tests/test_launchers.py' training tests, plus
parity with the live reference: one AdamW update per step of three at 1e-6
(fp32 and bf16 leaves), the same batches for the same (seed, step, host),
and checkpoints written by either package restored by the other bit for
bit."""

import os
import pathlib
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointManager as JCheckpointManager
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import adamw as jadamw
from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.optim import adamw
from repro_torch.runtime import StragglerDetector, Trainer, TrainLoopConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ------------------------------------------------------------------ optimizer
def test_adamw_converges_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                            weight_decay=0.0, clip_norm=10.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init(params)
    target = torch.tensor([1.0, 1.0])
    for _ in range(200):
        w = params["w"].clone().requires_grad_()
        torch.sum((w - target) ** 2).backward()
        params, state, _ = adamw.update(cfg, {"w": w.grad}, state, params)
    np.testing.assert_allclose(params["w"].numpy(), [1.0, 1.0], atol=1e-2)


def test_adamw_clips_gradients():
    cfg = adamw.AdamWConfig(clip_norm=1.0, warmup_steps=0)
    params = {"w": torch.zeros(3)}
    state = adamw.init(params)
    _, _, stats = adamw.update(cfg, {"w": torch.tensor([100.0, 0.0, 0.0])},
                               state, params)
    assert float(stats["grad_norm"]) == pytest.approx(100.0)


def test_schedule_warmup_and_cosine():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                            min_lr_ratio=0.1)
    assert float(adamw.schedule(cfg, 5)) == pytest.approx(0.5)
    assert float(adamw.schedule(cfg, torch.tensor(10, dtype=torch.int32))) \
        == pytest.approx(1.0)
    assert float(adamw.schedule(cfg, 110)) == pytest.approx(0.1)
    for step in (0, 3, 10, 37, 60, 110, 200):
        assert float(adamw.schedule(cfg, step)) == pytest.approx(
            float(jadamw.schedule(cfg, jnp.int32(step))), rel=1e-6)


def test_bf16_params_fp32_master():
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = adamw.init(params)
    assert state["master"]["w"].dtype == torch.float32
    assert state["count"].dtype == torch.int32
    grads = {"w": torch.full((4,), 0.001, dtype=torch.bfloat16)}
    new_params, state, _ = adamw.update(cfg, grads, state, params)
    assert new_params["w"].dtype == torch.bfloat16
    assert state["master"]["w"].data_ptr() != new_params["w"].data_ptr()


def _adam_tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 8)).astype(np.float32),
            "b": {"c": rng.standard_normal(6).astype(np.float32),
                  "d": [rng.standard_normal((3, 5)).astype(np.float32),
                        rng.standard_normal(2).astype(np.float32)]}}


def test_adamw_update_matches_jax():
    """Three updates of a tree of fp32 and bf16 leaves, clipping active on
    the first: params, master, m, v, count, grad_norm and lr against the
    reference's at 1e-6 (bf16 params within one bf16 step). The results
    are written into the tensors given."""
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            clip_norm=2.0)
    bf16 = {"b/d/0"}
    init = _adam_tree(0)

    def as_dtype(tree, jax_side):
        flat = T.flatten_with_keys(tree)
        out = []
        for key, a in flat.items():
            if jax_side:
                out.append(jnp.asarray(a, jnp.bfloat16 if key in bf16 else jnp.float32))
            else:
                t = torch.from_numpy(a.copy())
                out.append(t.to(torch.bfloat16) if key in bf16 else t)
        return T.unflatten_like(tree, out)

    jp, tp = as_dtype(init, True), as_dtype(init, False)
    jo, to = jadamw.init(jp), adamw.init(tp)
    for step in range(3):
        g = _adam_tree(step + 1)
        if step == 0:
            g = jax.tree.map(lambda a: a * 10, g)
        before = [t.data_ptr() for t in T.leaves((tp, to))]
        jp, jo, jstats = jadamw.update(cfg, as_dtype(g, True), jo, jp)
        tp, to, tstats = adamw.update(cfg, as_dtype(g, False), to, tp)
        assert [t.data_ptr() for t in T.leaves((tp, to))] == before
        for key in ("grad_norm", "lr"):
            assert float(tstats[key]) == pytest.approx(float(jstats[key]),
                                                       rel=1e-6), key
        assert int(to["count"]) == int(jo["count"]) == step + 1
        for part in ("master", "m", "v"):
            for key, got in T.flatten_with_keys(to[part]).items():
                want = np.asarray(T.flatten_with_keys(
                    jax.tree.map(np.asarray, jo[part]))[key])
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=1e-7, err_msg=f"{part} {key}")
        for key, got in T.flatten_with_keys(tp).items():
            want = np.asarray(T.flatten_with_keys(jp)[key], np.float32)
            tol = 2 ** -7 if key in bf16 else 1e-6
            assert got.dtype == (torch.bfloat16 if key in bf16 else torch.float32)
            np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                       atol=1e-7, err_msg=key)


# ----------------------------------------------------------------------- data
def test_data_deterministic_and_resumable():
    cfg = DataConfig(vocab=1000, seq_len=32, global_batch=8)
    a = SyntheticLM(cfg).batch(7)
    b = SyntheticLM(cfg).batch(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticLM(cfg).batch(8)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_data_host_sharding_disjoint():
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=8)
    h0 = SyntheticLM(cfg, host_index=0, n_hosts=2).batch(3)
    h1 = SyntheticLM(cfg, host_index=1, n_hosts=2).batch(3)
    assert h0["tokens"].shape == (4, 16)
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    with pytest.raises(ValueError, match="not divisible"):
        SyntheticLM(cfg, n_hosts=3)


def test_data_labels_shifted():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=2)
    b = SyntheticLM(cfg).batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("host,n_hosts", [(0, 1), (1, 2)])
def test_data_matches_jax_bit_for_bit(host, n_hosts):
    kw = dict(vocab=997, seq_len=24, global_batch=4, seed=5)
    mine = SyntheticLM(DataConfig(**kw), host, n_hosts)
    ref = JSyntheticLM(JDataConfig(**kw), host, n_hosts)
    for step in (0, 1, 12):
        got, want = mine.torch_batch(step, "cpu"), ref.jax_batch(step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


# ----------------------------------------------------------------- checkpoint
def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 8, generator=g),
            "b": {"c": torch.arange(6, dtype=torch.int32),
                  "d": [torch.ones(3), torch.zeros(2)],
                  "e": torch.randn(5, generator=g).to(torch.bfloat16)}}


def _equal_trees(got, want):
    for (kg, g), (kw, w) in zip(T.flatten_with_keys(got).items(),
                                T.flatten_with_keys(want).items()):
        assert kg == kw and g.dtype == w.dtype and torch.equal(g, w), kg


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = _tree()
    mgr.save(10, tree, blocking=True)
    _equal_trees(mgr.restore(10, tree), tree)
    nbytes, seconds = mgr.last_write
    assert nbytes == 4 * 32 + 4 * 6 + 4 * 5 + 2 * 5 and seconds >= 0


def test_checkpoint_snapshots_before_the_write(tmp_path):
    """`save` copies the tensors at once: a tensor overwritten in place
    after `save` (the train step updates in place) is written as it was."""
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    want = T.tree_map(torch.clone, tree)
    mgr.save(1, tree)
    for t in T.leaves(tree):
        t.fill_(7)
    mgr.wait()
    _equal_trees(mgr.restore(1, want), want)


def test_checkpoint_atomicity_no_commit(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _tree(), blocking=True)
    os.remove(os.path.join(mgr._step_dir(5), "COMMIT"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(5, _tree())


def test_checkpoint_checksum_detects_corruption(tmp_path):
    import json
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, _tree(), blocking=True)
    manifest_path = os.path.join(mgr._step_dir(3), "MANIFEST.json")
    manifest = json.load(open(manifest_path))
    manifest["leaves"]["a"]["crc32"] ^= 0xFF   # bit-rot on the recorded crc
    json.dump(manifest, open(manifest_path, "w"))
    with pytest.raises(IOError):
        mgr.restore(3, _tree())


def test_checkpoint_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(), blocking=True)
    assert mgr.valid_steps() == [3, 4]


def test_checkpoint_async_overlap(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())       # non-blocking
    mgr.save(2, _tree())       # waits for 1, then writes 2
    mgr.wait()
    assert mgr.valid_steps() == [1, 2]


def test_checkpoint_writer_failure_is_raised(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", broken)
    mgr.save(1, _tree())
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None
    mgr.wait()                 # raised once


def test_checkpoint_stores_bf16_as_its_bits(tmp_path):
    import json
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree, blocking=True)
    d = mgr._step_dir(1)
    meta = json.load(open(os.path.join(d, "MANIFEST.json")))["leaves"]
    assert {k: m["dtype"] for k, m in meta.items()} == {
        "a": "float32", "b/c": "int32", "b/d/0": "float32",
        "b/d/1": "float32", "b/e": "bfloat16"}
    with np.load(os.path.join(d, "shard_00000.npz")) as data:
        np.testing.assert_array_equal(
            data["b/e"], tree["b"]["e"].view(torch.int16).numpy().view(np.uint16))


def _jax_tree(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16) if t.dtype == torch.bfloat16 else jnp.asarray(t.numpy()),
        tree)


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    tree = _tree(1)
    CheckpointManager(str(tmp_path)).save(7, tree, blocking=True)
    jmgr = JCheckpointManager(str(tmp_path))
    assert jmgr.latest_step() == 7
    want = _jax_tree(tree)
    got = jmgr.restore(7, jax.eval_shape(lambda: want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(np.asarray(g).view(np.uint8),
                                      np.asarray(w).view(np.uint8))


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    tree = _tree(2)
    JCheckpointManager(str(tmp_path)).save(9, _jax_tree(tree), blocking=True)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 9
    _equal_trees(mgr.restore(9, tree), tree)


_NO_ML_DTYPES = """
import sys
sys.modules["ml_dtypes"] = None     # any `import ml_dtypes` now raises
import torch
from repro_torch.checkpoint import CheckpointManager
tree = {"w": torch.randn(7).to(torch.bfloat16), "n": torch.arange(3)}
mgr = CheckpointManager(sys.argv[1])
mgr.save(1, tree, blocking=True)
back = mgr.restore(1, tree)
assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], tree["w"])
assert torch.equal(back["n"], tree["n"])
"""


def test_checkpoint_bf16_needs_no_ml_dtypes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


# -------------------------------------------------------------------- trainer
def _tiny_trainer(tmp_path, total=60, ckpt_every=10):
    opt_cfg = adamw.AdamWConfig(lr=0.15, warmup_steps=0, total_steps=total,
                                weight_decay=0.0)
    params = {"w": torch.tensor([4.0])}
    opt_state = adamw.init(params)

    def step(params, opt_state, batch):
        w = params["w"].clone().requires_grad_()
        loss = torch.sum((w - batch["target"]) ** 2)
        loss.backward()
        p, s, stats = adamw.update(opt_cfg, {"w": w.grad}, opt_state, params)
        return p, s, {"loss": loss.detach(), **stats}

    def batch_fn(i):
        return {"target": torch.tensor([1.0])}

    return Trainer(TrainLoopConfig(total_steps=total, ckpt_every=ckpt_every,
                                   ckpt_dir=str(tmp_path), log_every=1000),
                   step, params, opt_state, batch_fn)


def test_trainer_runs_and_checkpoints(tmp_path):
    tr = _tiny_trainer(tmp_path)
    out = tr.run()
    assert out["final_step"] == 60
    assert tr.ckpt.latest_step() == 60
    assert float(tr.params["w"][0]) == pytest.approx(1.0, abs=0.2)


def test_trainer_preemption_and_resume(tmp_path):
    tr = _tiny_trainer(tmp_path, total=1000, ckpt_every=5)
    orig_observe = tr.straggler.observe
    count = {"n": 0}

    def preempt_after(step, dt):
        count["n"] += 1
        if count["n"] >= 12:
            tr._preempted = True      # simulated SIGTERM
        return orig_observe(step, dt)

    tr.straggler.observe = preempt_after
    out = tr.run()
    assert out["preempted"]
    stopped_at = out["final_step"]
    assert tr.ckpt.latest_step() == stopped_at

    tr2 = _tiny_trainer(tmp_path, total=stopped_at + 10, ckpt_every=5)
    resumed = tr2.maybe_restore()
    assert resumed == stopped_at
    assert torch.equal(tr2.params["w"], tr.params["w"])
    assert int(tr2.opt_state["count"]) == stopped_at
    out2 = tr2.run()
    assert out2["final_step"] == stopped_at + 10


def test_trainer_signal_handler_preempts(tmp_path):
    tr = _tiny_trainer(tmp_path, total=1000, ckpt_every=1000)
    before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    previous = tr.install_signal_handlers()
    try:
        signal.raise_signal(signal.SIGTERM)
    finally:
        tr.restore_signal_handlers(previous)
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == before
    out = tr.run()
    assert out["preempted"] and out["final_step"] == 0
    assert tr.ckpt.latest_step() == 0


def test_straggler_detector():
    det = StragglerDetector(k=3.0, alpha=0.5)
    for i in range(10):
        assert not det.observe(i, 0.1)
    assert det.observe(10, 1.0)       # 10x slower -> flagged
    assert det.report()["n_flagged"] == 1
    assert not det.observe(11, 0.1)   # ewma not polluted by the outlier


# ------------------------------------------------------------------ launcher
def test_train_launcher_end_to_end(tmp_path):
    from repro_torch.launch.train import main
    res = main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "80",
                "--batch", "4", "--seq", "64", "--lr", "5e-3",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "40",
                "--device", "cpu"])
    assert res["final_step"] == 80
    losses = [h["loss"] for h in res["history"]]
    assert sum(losses[-2:]) / 2 < sum(losses[:2]) / 2   # learns the bigram
    assert os.path.exists(os.path.join(str(tmp_path), "step_000080"))


def test_train_launcher_step_updates_in_place(tmp_path):
    """The launcher's train step writes params and optimizer state into
    the tensors it is given: no second copy of the fp32 state."""
    from repro_torch.launch.train import main
    record = {}
    main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "1", "--batch", "2",
          "--seq", "16", "--ckpt-dir", str(tmp_path), "--device", "cpu"],
         record=record)
    tr = record["trainer"]
    trees = (tr.params, tr.opt_state)
    before = [t.data_ptr() for t in T.leaves(trees)]
    old = T.tree_map(torch.clone, tr.params)
    params, opt_state, _ = record["step_fn"](*trees, record["batch_fn"](1))
    assert [t.data_ptr() for t in T.leaves((params, opt_state))] == before
    assert int(opt_state["count"]) == 2
    assert any(not torch.equal(a, b) for a, b in
               zip(T.leaves(params), T.leaves(old)))


def test_train_launcher_resume(tmp_path):
    from repro_torch.launch.train import main
    main(["--arch", "gemma-2b", "--smoke", "--steps", "10", "--batch", "4",
          "--seq", "64", "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
          "--device", "cpu"])
    record = {}
    before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    res = main(["--arch", "gemma-2b", "--smoke", "--steps", "20", "--batch",
                "4", "--seq", "64", "--ckpt-dir", str(tmp_path),
                "--ckpt-every", "5", "--resume", "--device", "cpu"],
               record=record)
    assert res["final_step"] == 20
    assert record["trainer"].start_step == 10
    # the launcher put the handlers back
    assert (signal.getsignal(signal.SIGTERM),
            signal.getsignal(signal.SIGINT)) == before


def test_train_launcher_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "1",
              "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("example,args", [
    ("torch_train_lm.py", ["--steps", "3", "--batch", "2", "--seq", "32"]),
    ("torch_serve_decode.py", ["--requests", "2", "--batch", "2",
                               "--prompt-len", "16", "--gen-len", "4"]),
])
def test_example_runs_on_the_cpu(example, args, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    extra = ["--ckpt-dir", str(tmp_path)] if "train" in example else []
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / example), *args, *extra,
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    if "train" in example:
        assert "done: 3 steps" in out.stdout
        assert os.path.exists(os.path.join(str(tmp_path), "step_000003"))
    else:
        assert "'tokens': 8" in out.stdout


def test_train_steps_leave_no_tensor_in_a_reference_cycle():
    """The tree helpers recurse without closures over themselves, so the
    trees they build and walk (gradients, updated state) are freed when
    the caller drops them, not at the next gc: after two steps of the
    train step no tensor waits in a reference cycle."""
    import gc

    from repro_torch.configs import get_smoke
    from repro_torch.models import steps as ST
    from repro_torch.models.transformer import init_lm

    cfg = get_smoke("qwen2-1.5b")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=2, seed=0))
    gc.collect()
    gc.disable()
    try:
        params = init_lm(cfg, seed=0, device="cpu")
        opt_state = adamw.init(params)
        step = ST.make_train_step(cfg, adamw.AdamWConfig(
            lr=1e-3, warmup_steps=0, total_steps=4), microbatches=1)
        for i in range(2):
            params, opt_state, _ = step(params, opt_state,
                                        data.torch_batch(i, "cpu"))
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cycled = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert cycled == []
