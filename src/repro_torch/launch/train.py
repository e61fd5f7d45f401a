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
its backward `chunked_attention` recomputed (`layers.FlashAttention`). One
process, one device: the reference's ``--mesh``, ``--psum`` and ``--remat``
configure its sharding (``Parallel``) and wait for ROADMAP A9.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs import get_config, get_smoke
from repro_torch.data import DataConfig, SyntheticLM, make_extra_inputs
from repro_torch.kernels.launch import resolve_device
from repro_torch.models import steps as ST
from repro_torch.models.transformer import init_lm
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainLoopConfig


def main(argv=None, *, record: dict | None = None) -> dict:
    """Train and return the reference's result dict (``final_step``,
    ``preempted``, ``straggler``, ``history``). Given a dict as
    ``record``, it also receives the config, the trainer (its params and
    optimizer state, its checkpoint manager), the train step and the batch
    function, so a caller can check and time what was trained."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    params = init_lm(cfg, seed=args.seed, device=device)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                                total_steps=args.steps)
    opt_state = adamw.init(params)

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    extras = make_extra_inputs(cfg, args.batch, args.seq,
                               np.random.default_rng(args.seed), device=device)

    def batch_fn(step: int):
        b = data.torch_batch(step, device)
        b.update(extras)
        return b

    step_fn = ST.make_train_step(cfg, opt_cfg)
    trainer = Trainer(
        TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir),
        step_fn, params, opt_state, batch_fn)
    previous = trainer.install_signal_handlers()
    try:
        if args.resume:
            resumed = trainer.maybe_restore()
            print(f"resumed from step {resumed}")
        result = trainer.run()
    finally:
        trainer.restore_signal_handlers(previous)
    print(f"done: {result['final_step']} steps, "
          f"straggler report: {result['straggler']}")
    if record is not None:
        record.update(cfg=cfg, trainer=trainer, step_fn=step_fn,
                      batch_fn=batch_fn)
    return result


if __name__ == "__main__":
    main()
