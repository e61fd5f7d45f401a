"""End-to-end training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --smoke --device cpu --steps 200 --batch 8 --seq 256

Runs on the card unless ``--device cpu`` is given. Builds the model
(`init_lm`, seeded), the AdamW state, the synthetic stream and the modality
inputs of a vlm or enc-dec arch, and drives the fault-tolerant `Trainer`
(checkpoints, resume, straggler detection; SIGTERM and SIGINT preempt it
while it runs) over the eager train step, whose
params and optimizer state are updated in place (the reference's launcher
donates them to ``jax.jit``). Every attention forward runs the flash kernel,
its backward `chunked_attention` recomputed (`layers.FlashAttention`).

The mesh (``--mesh``, ``--psum``, ``--remat``, the reference's flags): with
no process group standing, ``--mesh local`` trains in this one process on
one device, as a step with ``parallel=None``. Where the caller has started
a group (``torch.distributed.init_process_group``, one process a rank),
``--mesh local`` builds the reference's test mesh over its ranks
(`build_mesh`), each rank holds its fsdp shard of the params and the AdamW
state (`repro_torch.sharding.fsdp`), the train step splits the global
batch over the data axes, combines the MoE's partial sums by ``--psum``
and checkpoints each layer by ``--remat``; rank 0 alone writes checkpoints
(global leaves) and prints, and every rank returns rank 0's result.
``--mesh single`` and ``multi`` ask for the production mesh, which still
waits for ROADMAP A9 (`make_production_mesh` raises).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke
from repro_torch.data import DataConfig, SyntheticLM, make_extra_inputs
from repro_torch.kernels.launch import resolve_device
from repro_torch.models import steps as ST
from repro_torch.models.transformer import init_lm
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainLoopConfig
from repro_torch.sharding import fsdp, rules
from repro_torch.sharding.api import make_parallel


def build_mesh(kind: str, device_type: str = "cpu"):
    """The reference's `build_mesh` over the ranks of the process group
    that stands: ``single`` and ``multi`` the production mesh (raises,
    ROADMAP A9); ``local`` (1, 1) on one rank, else (n / 2, 2) where the n
    ranks pair up and (n, 1) where they do not. None where no group
    stands: the launcher then trains in one process."""
    from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
    if kind == "single":
        return make_production_mesh(multi_pod=False)
    if kind == "multi":
        return make_production_mesh(multi_pod=True)
    if not dist.is_initialized():
        return None
    n = dist.get_world_size()
    if n == 1:
        return make_test_mesh(1, 1, device_type=device_type)
    model = 2 if n % 2 == 0 else 1
    return make_test_mesh(n // model, model, device_type=device_type)


def main(argv=None, *, record: dict | None = None) -> dict:
    """Train and return the reference's result dict (``final_step``,
    ``preempted``, ``straggler``, ``history``). Given a dict as
    ``record``, it also receives the config, the trainer (its params and
    optimizer state, its checkpoint manager), the train step, the batch
    function and the `Parallel` (None in one process), so a caller can
    check and time what was trained."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="local", choices=["local", "single", "multi"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--psum", default="active", choices=["active", "passive"])
    ap.add_argument("--remat", default="full", choices=["none", "dots", "full"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    mesh = build_mesh(args.mesh, device.type)
    parallel = (None if mesh is None else
                make_parallel(mesh, psum_strategy=args.psum, remat=args.remat))
    params = init_lm(cfg, seed=args.seed, device=device)
    shardings = None
    if parallel is not None:
        p_sh = fsdp.held_specs(mesh, params)
        params = rules.shard_tree(params, p_sh, mesh)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                                total_steps=args.steps)
    opt_state = adamw.init(params)
    if parallel is not None:
        shardings = (p_sh, fsdp.opt_held_specs(p_sh))

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    extras = make_extra_inputs(cfg, args.batch, args.seq,
                               np.random.default_rng(args.seed), device=device)

    def batch_fn(step: int):
        b = data.torch_batch(step, device)
        b.update(extras)
        return b

    step_fn = ST.make_train_step(cfg, opt_cfg, parallel)
    trainer = Trainer(
        TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir),
        step_fn, params, opt_state, batch_fn, shardings=shardings,
        parallel=parallel)
    previous = trainer.install_signal_handlers()
    try:
        if args.resume:
            resumed = trainer.maybe_restore()
            if trainer.lead:
                print(f"resumed from step {resumed}")
        result = trainer.run()
    finally:
        trainer.restore_signal_handlers(previous)
    if parallel is not None:
        # every rank returns rank 0's result (its step times and straggler
        # report are its own)
        box = [result]
        dist.broadcast_object_list(box, src=int(mesh.mesh.flatten()[0]))
        result = box[0]
    if trainer.lead:
        print(f"done: {result['final_step']} steps, "
              f"straggler report: {result['straggler']}")
    if record is not None:
        record.update(cfg=cfg, trainer=trainer, step_fn=step_fn,
                      batch_fn=batch_fn, parallel=parallel)
    return result


if __name__ == "__main__":
    main()
