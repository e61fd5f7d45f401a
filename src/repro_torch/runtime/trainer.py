"""Fault-tolerant training loop of the port (the reference's
``repro/runtime/trainer.py``):

  * periodic async checkpoints with atomic commit (`repro_torch.checkpoint`);
  * SIGTERM/SIGINT (preemption) -> final blocking checkpoint -> clean exit;
    on a mesh the ranks agree on the flag before each step, so that all of
    them stop at the same step and make the same collectives;
  * resume from the newest valid checkpoint (`Trainer.maybe_restore`);
  * straggler detection: per-step wall-time EWMA + outlier flagging, with a
    rolling report;
  * deterministic, stateless-resumable data order (``batch_fn(step)``).

A step's wall is an `obs.Stopwatch` around the step and the host read of
its loss (``float``, which waits for the card, as the reference's
``block_until_ready`` does).
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.obs.trace import Stopwatch
from repro_torch.sharding import collectives


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    keep_last: int = 3
    log_every: int = 10
    straggler_k: float = 3.0      # flag steps slower than k * EWMA
    ewma_alpha: float = 0.1


class StragglerDetector:
    """EWMA-based step-time monitor: flags a step slower than k times the
    EWMA, which the outlier does not update."""

    def __init__(self, k: float = 3.0, alpha: float = 0.1):
        self.k = k
        self.alpha = alpha
        self.ewma: float | None = None
        self.flags: list[tuple[int, float, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if self.ewma is not None and dt > self.k * self.ewma:
            self.flags.append((step, dt, self.ewma))
            is_straggler = True
            # don't pollute the EWMA with the outlier
        else:
            self.ewma = dt if self.ewma is None else (
                self.alpha * dt + (1 - self.alpha) * self.ewma)
        return is_straggler

    def report(self) -> dict:
        return {"ewma_s": self.ewma, "n_flagged": len(self.flags),
                "flagged_steps": [s for s, _, _ in self.flags[-10:]]}


class Trainer:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` run from ``start_step`` to ``total_steps``; ``metrics`` holds
    at least 0-d tensors ``loss`` and ``grad_norm``.

    ``shardings`` (the reference's): a (params specs, optimizer specs) pair
    saying which shards of each leaf this rank of ``parallel``'s mesh holds
    (`repro_torch.sharding.fsdp.held_specs`, ``opt_held_specs``). Then the
    checkpoints hold global leaves (gathered; rank 0 writes), a restore
    cuts this rank's shards from them, only rank 0 prints, and a signal to
    any rank preempts every rank at the same step (`agreed_preempted`)."""

    def __init__(self, loop_cfg: TrainLoopConfig, train_step: Callable,
                 params: Any, opt_state: Any,
                 batch_fn: Callable[[int], Any],
                 shardings: tuple[Any, Any] | None = None, parallel=None):
        if (shardings is None) != (parallel is None):
            raise ValueError("Trainer: shardings and parallel go together")
        self.shardings = shardings
        self.parallel = parallel
        self.lead = parallel is None or not any(parallel.mesh.get_coordinate())
        self.cfg = loop_cfg
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.batch_fn = batch_fn
        self.ckpt = CheckpointManager(loop_cfg.ckpt_dir, loop_cfg.keep_last)
        self.straggler = StragglerDetector(loop_cfg.straggler_k,
                                           loop_cfg.ewma_alpha)
        self.start_step = 0
        self.history: list[dict] = []
        self._preempted = False

    # ----------------------------------------------------------- preemption
    def install_signal_handlers(self) -> dict:
        """SIGTERM and SIGINT set the preemption flag; returns the handlers
        they replace, by signal, for `restore_signal_handlers`."""
        def handler(signum, frame):  # noqa: ARG001
            self._preempted = True

        return {sig: signal.signal(sig, handler)
                for sig in (signal.SIGTERM, signal.SIGINT)}

    @staticmethod
    def restore_signal_handlers(previous: dict) -> None:
        for sig, old in previous.items():
            signal.signal(sig, old)

    def agreed_preempted(self) -> bool:
        """Whether to stop for preemption: this rank's flag, or on a mesh
        whether any rank's is set (a MAX over the tp group, then over the
        data group, counted under ``"train/preempt"``). The flag decides
        which collectives come next (a step's, or the final checkpoint's
        gathers), so every rank must read the same value."""
        if self.parallel is None:
            return self._preempted
        flag = torch.tensor(float(self._preempted),
                            device=T.leaves(self.params)[0].device)
        for group in (self.parallel.tp_group, self.parallel.dp_group):
            collectives.all_reduce(flag, group, op=dist.ReduceOp.MAX,
                                   site="train/preempt")
        self._preempted = bool(flag.item())
        return self._preempted

    # --------------------------------------------------------------- resume
    def maybe_restore(self) -> int:
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0
        tree = {"params": self.params, "opt_state": self.opt_state}
        restored = self.ckpt.restore(latest, tree, **self._placement(mesh=True))
        self.params = restored["params"]
        self.opt_state = restored["opt_state"]
        self.start_step = latest
        return latest

    def _placement(self, mesh: bool = False) -> dict:
        """The checkpoint store's arguments for a sharded tree."""
        if self.shardings is None:
            return {}
        specs = {"params": self.shardings[0], "opt_state": self.shardings[1]}
        return ({"shardings": specs, "mesh": self.parallel.mesh} if mesh
                else {"shardings": specs, "parallel": self.parallel})

    def _save(self, step: int, blocking: bool = False) -> None:
        self.ckpt.save(step, {"params": self.params,
                              "opt_state": self.opt_state}, blocking,
                       **self._placement())

    # ------------------------------------------------------------------ run
    def run(self) -> dict:
        step = self.start_step
        while not (preempted := self.agreed_preempted()) and \
                step < self.cfg.total_steps:
            batch = self.batch_fn(step)
            with Stopwatch() as sw:
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])
            dt = sw.s
            flagged = self.straggler.observe(step, dt)
            step += 1
            if step % self.cfg.log_every == 0 or flagged:
                rec = {"step": step, "dt_s": dt, "loss": loss,
                       "grad_norm": float(metrics["grad_norm"]),
                       "straggler": flagged}
                self.history.append(rec)
                if self.lead:
                    print(f"step {step:>6} loss={rec['loss']:.4f} "
                          f"gnorm={rec['grad_norm']:.3f} dt={dt*1e3:.0f}ms"
                          + ("  [STRAGGLER]" if flagged else ""), flush=True)
            if step % self.cfg.ckpt_every == 0:
                self._save(step)
        # final (blocking) checkpoint — also the preemption path
        self._save(step, blocking=True)
        return {"final_step": step, "preempted": preempted,
                "straggler": self.straggler.report(),
                "history": self.history}
