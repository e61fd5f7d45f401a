"""Step factories: the loss and train_step, prefill_step / decode_step for
the port's stacks, and the greedy sampling loop. The factories return the
plain step bodies, as the reference's do. `repro_torch.launch.graph`
compiles the serving steps, which carry their config as ``step.cfg``
(captured CUDA graphs on the card), as the reference's callers wrap them in
``jax.jit``. The train step runs eagerly: autograd differentiates the
stack, attention through `layers.FlashAttention` (the flash kernel forward,
``chunked_attention`` recomputed as its backward)."""

from __future__ import annotations

import torch

from repro_torch import tree as T
from repro_torch.configs.base import ArchConfig
from repro_torch.launch import graph
from repro_torch.models.transformer import (KV_SHARDED, encode, forward,
                                            init_caches)
from repro_torch.optim import adamw

Z_LOSS = 1e-4


def _memory_from_batch(cfg: ArchConfig, params, batch):
    """The cross-attention memory of a vlm or enc-dec arch: the encoder's
    output over the batch's ``frames``, or the batch's ``vision_ctx`` as it
    stands; None for the other archs."""
    if cfg.encoder is not None:
        return encode(params, cfg, batch["frames"])
    if cfg.n_vision_tokens:
        return batch["vision_ctx"]
    return None


def lm_loss(params, cfg: ArchConfig, batch):
    """Next-token cross-entropy (+ z-loss + MoE aux). tokens/labels: (B, S);
    a label < 0 is masked. The logits are taken to fp32 and the
    log-sum-exp is shifted by their max, held out of the gradient; the
    label's logit is a gather (the reference's one-hot contraction serves
    a vocab sharded over ranks, ROADMAP A9; on one card both give the same
    value). Returns (loss, {"ce", "z_loss", "aux"}), 0-d fp32."""
    memory = _memory_from_batch(cfg, params, batch)
    logits, _, aux = forward(params, cfg, batch["tokens"], memory=memory)
    logits = logits.float()
    m = logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]     # (B, S)
    labels = batch["labels"].long()
    label_logit = torch.gather(logits, -1,
                               labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    denom = torch.clamp_min(mask.sum(), 1.0)
    ce = torch.sum((lse - label_logit) * mask) / denom
    zl = Z_LOSS * torch.sum(torch.square(lse) * mask) / denom
    loss = ce + zl + aux
    return loss, {"ce": ce, "z_loss": zl, "aux": aux}


def loss_and_grads(params, cfg: ArchConfig, batch):
    """(loss, parts, grads) of one batch: `lm_loss` on leaves that require
    grad and share the params' storage, and its gradient, a tree like the
    params in their dtype (zeros for a leaf the loss does not reach)."""
    train = T.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, parts = lm_loss(train, cfg, batch)
        leaves = T.leaves(train)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)]
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            T.unflatten_like(params, gs))


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    microbatches: int | None = None):
    """Training step with gradient accumulation: the batch is split into
    ``microbatches`` sequential slices (``cfg.train_microbatches`` by
    default; one where the batch does not divide), and each slice's
    gradients are added into fp32 buffers shaped like the params (the
    active accumulation: one sum held across slices), divided by the
    count; loss and parts are averaged. Then `adamw.update`, which writes
    params and state in place, as the reference's launcher donates them to
    ``jax.jit``. Returns ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)``, metrics ``loss``, ``ce``, ``z_loss``,
    ``aux``, ``grad_norm`` and ``lr`` as 0-d tensors on the device."""
    mb = microbatches if microbatches is not None else cfg.train_microbatches

    def train_step(params, opt_state, batch):
        b = batch["tokens"].shape[0]
        # smoke/CI batches may be smaller than the configured accumulation
        mb_eff = mb if (mb > 1 and b % mb == 0) else 1
        if mb_eff <= 1:
            loss, parts, grads = loss_and_grads(params, cfg, batch)
        else:
            n = b // mb_eff
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in T.leaves(params)]
            losses, parts_all = [], []
            for i in range(mb_eff):
                mbatch = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, pp, g = loss_and_grads(params, cfg, mbatch)
                for acc, gi in zip(gsum, T.leaves(g)):
                    acc.add_(gi)
                del g
                losses.append(l)
                parts_all.append(pp)
            grads = T.unflatten_like(params, [acc.div_(mb_eff) for acc in gsum])
            loss = torch.stack(losses).mean()
            parts = {k: torch.stack([pp[k] for pp in parts_all]).mean()
                     for k in parts_all[0]}
        new_params, new_opt, stats = adamw.update(opt_cfg, grads, opt_state,
                                                  params)
        return new_params, new_opt, {"loss": loss, **parts, **stats}

    return train_step


def _cut_kv_blocks(caches, parallel):
    """The caches with each self-attention KV cache cut to this rank's block
    of the sequence and marked `KV_SHARDED`, where ``max_len`` divides over
    the tp axis (the reference's condition for flash decoding); else as
    they are, and decode attends over the whole cache on every rank."""
    from repro_torch.sharding import rules
    keys = [c["k"] for c in caches["layers"] if "k" in c]
    if keys and all(k.shape[2] % parallel.tp_size == 0 for k in keys):
        caches = rules.shard_tree(caches, rules.kv_block_specs(caches, parallel),
                                  parallel.mesh)
        caches[KV_SHARDED] = True
    return caches


def make_prefill_step(cfg: ArchConfig, max_len: int, parallel=None):
    """Full-sequence forward that fills caches and returns the last token's
    logits (sampling seed). The caches are fresh ones on the tokens' device,
    or ``caches`` where given, zeroed at position 0 (the compiled step's
    static cache); either way the position is 0 on the host, so attention
    takes it as an integer. A vlm or enc-dec arch's batch also carries
    ``vision_ctx`` or ``frames`` (`repro_torch.data.make_extra_inputs`):
    the memory is computed here (the encoder runs inside the step) and its
    keys and values fill the cross caches.

    ``parallel``: this process is one rank of a mesh (`forward`); the
    prefill itself runs replicated, and under ``parallel.flash_decode`` the
    caches it returns hold this rank's block of each KV cache's sequence
    where ``max_len`` divides over the tp axis. Such a step runs eagerly:
    its collectives are not captured in a CUDA graph."""
    def prefill_step(params, batch, caches=None):
        tokens = batch["tokens"]
        memory = _memory_from_batch(cfg, params, batch)
        if caches is None:
            caches = init_caches(cfg, tokens.shape[0], max_len,
                                 mem_len=0 if memory is None else memory.shape[1],
                                 device=tokens.device)
        logits, caches, _ = forward(params, cfg, tokens, caches=caches, start=0,
                                    memory=memory, parallel=parallel)
        if parallel is not None and parallel.flash_decode:
            caches = _cut_kv_blocks(caches, parallel)
        return logits[:, -1], caches

    prefill_step.cfg, prefill_step.parallel = cfg, parallel
    return prefill_step


def make_decode_step(cfg: ArchConfig, parallel=None):
    """One-token decode against a populated cache (the cross keys and values
    included, so no memory is needed); it reads its position on the device
    only. ``parallel`` as in `make_prefill_step`: with caches that a
    flash-decoding prefill cut, each rank attends over its block."""
    def decode_step(params, caches, token):
        logits, caches, _ = forward(params, cfg, token, caches=caches,
                                    parallel=parallel)
        return logits[:, -1], caches

    decode_step.cfg, decode_step.parallel = cfg, parallel
    return decode_step


def greedy_generate(cfg: ArchConfig, params, prompt: torch.Tensor,
                    steps: int, max_len: int, extras=None) -> torch.Tensor:
    """Reference sampling loop (prefill + steps - 1 decodes) -> (B, steps),
    through the compiled steps; ``extras`` are a vlm's or enc-dec arch's
    ``vision_ctx`` or ``frames``."""
    prefill = graph.compile_prefill(make_prefill_step(cfg, max_len))
    decode = graph.compile_decode(make_decode_step(cfg))
    logits, caches = prefill(params, {"tokens": prompt, **(extras or {})})
    toks = [torch.argmax(logits, -1)[:, None]]
    for _ in range(steps - 1):
        logits, caches = decode(params, caches, toks[-1])
        toks.append(torch.argmax(logits, -1)[:, None])
    return torch.cat(toks, 1)
