"""AdamW with fp32 master weights, global-norm clipping and a cosine
schedule: the reference's ``repro/optim/adamw.py`` on tensors.

The reference's functional API: ``init(params) -> state`` and
``update(cfg, grads, state, params) -> (new_params, new_state, stats)``,
plain functions over the port's trees (`repro_torch.tree`), not
``torch.optim.AdamW``. Mixed precision: the model's params are in its
compute dtype (bf16 at full size); the state holds fp32 master weights, fp32
(m, v) and an int32 step count, and each update casts the new master
weights back to the params' dtype. Gradients may come in either dtype (bf16
from one microbatch, the fp32 sum from several).

`update` writes the new state and params into the tensors it was given and
returns them, as the reference's launcher donates them to ``jax.jit``: a
step holds one copy of the fp32 state, not two.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree as T


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor): linear warm-up
    over ``warmup_steps``, then a cosine down to ``min_lr_ratio`` of ``lr``
    at ``total_steps``. fp32, on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init(params: Any) -> dict:
    """fp32 copies of the params (``master``), zero ``m`` and ``v``, and a
    0-d int32 ``count`` on the params' device."""
    leaves = T.leaves(params)
    device = leaves[0].device if leaves else torch.device("cpu")
    return {
        "master": T.tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params),
        "v": T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of their squares summed in fp32."""
    sq = sum(torch.sum(torch.square(x.float())) for x in T.leaves(tree))
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def update(cfg: AdamWConfig, grads: Any, state: dict, params: Any,
           grad_norm: torch.Tensor | None = None) -> tuple[Any, dict, dict]:
    """One AdamW step: the gradients clipped to ``clip_norm`` by their
    global norm, (m, v) moved, bias-corrected, the decay applied to the
    master weights, and the params made from the new master weights, all
    written in place. ``grad_norm``: the global norm where the caller has
    it (a rank holding shards of the gradients reduces its squares over the
    mesh, `repro_torch.sharding.fsdp.global_norm`); else `global_norm` of
    ``grads``. Returns (params, state, {"grad_norm", "lr"}), the trees
    given."""
    count = state["count"] + 1
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    lr = schedule(cfg, count)
    b1c = 1 - cfg.b1 ** count.to(torch.float32)
    b2c = 1 - cfg.b2 ** count.to(torch.float32)

    def upd(g, m, v, master, p):
        g = g.float() * scale
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        step = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps) \
            + cfg.weight_decay * master
        m.copy_(m_new)
        v.copy_(v_new)
        master.sub_(lr * step)
        p.copy_(master)

    for leaf in zip(T.leaves(grads), T.leaves(state["m"]), T.leaves(state["v"]),
                    T.leaves(state["master"]), T.leaves(params)):
        upd(*leaf)
    state["count"].copy_(count)
    return params, state, {"grad_norm": gnorm, "lr": lr}
