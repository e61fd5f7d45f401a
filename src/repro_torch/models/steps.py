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
                                            init_caches, init_lm)
from repro_torch.optim import adamw
from repro_torch.sharding import collectives, fsdp, rules

Z_LOSS = 1e-4


def _memory_from_batch(cfg: ArchConfig, params, batch, parallel=None):
    """The cross-attention memory of a vlm or enc-dec arch: the encoder's
    output over the batch's ``frames``, or the batch's ``vision_ctx`` as it
    stands; None for the other archs."""
    if cfg.encoder is not None:
        return encode(params, cfg, batch["frames"], parallel)
    if cfg.n_vision_tokens:
        return batch["vision_ctx"]
    return None


def _split(parallel) -> bool:
    return parallel is not None and parallel.batch_split and parallel.dp_size > 1


def lm_loss(params, cfg: ArchConfig, batch, parallel=None):
    """Next-token cross-entropy (+ z-loss + MoE aux). tokens/labels: (B, S);
    a label < 0 is masked. The logits are taken to fp32 and the
    log-sum-exp is shifted by their max, held out of the gradient; the
    label's logit is a gather (the reference's one-hot contraction serves
    a vocab sharded over ranks, the tp placement of the LM head that
    ROADMAP A9 still holds; on one card both give the same value). Returns
    (loss, {"ce", "z_loss", "aux"}), 0-d fp32.

    ``parallel`` goes to `forward`. With a batch split over its data axes
    (``parallel.batch_split``, a train step's), the label count is summed
    over the data group, so ``ce`` and ``z_loss`` are this rank's shares
    of the global batch's (their sum over the group is the global value)
    and ``aux`` is the global batch's (`moe.route`): the gradients summed
    over the data group are the global batch's, whatever the mask."""
    memory = _memory_from_batch(cfg, params, batch, parallel)
    logits, _, aux = forward(params, cfg, batch["tokens"], memory=memory,
                             parallel=parallel)
    logits = logits.float()
    m = logits.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]     # (B, S)
    labels = batch["labels"].long()
    label_logit = torch.gather(logits, -1,
                               labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    count = mask.sum()
    if _split(parallel):
        count = collectives.all_reduce(count, parallel.dp_group,
                                       site="train/labels")
    denom = torch.clamp_min(count, 1.0)
    ce = torch.sum((lse - label_logit) * mask) / denom
    zl = Z_LOSS * torch.sum(torch.square(lse) * mask) / denom
    loss = ce + zl + aux
    return loss, {"ce": ce, "z_loss": zl, "aux": aux}


def loss_and_grads(params, cfg: ArchConfig, batch, parallel=None):
    """(loss, parts, grads) of one batch: `lm_loss` on leaves that require
    grad and share the params' storage, and its gradient, a tree like the
    params in their dtype (zeros for a leaf the loss does not reach)."""
    train = T.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, parts = lm_loss(train, cfg, batch, parallel)
        leaves = T.leaves(train)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)]
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            T.unflatten_like(params, gs))


def _accumulate(params, cfg: ArchConfig, batch, mb: int, parallel):
    """The gradients of ``mb`` sequential slices of ``batch`` (one: the
    batch itself) summed in fp32 buffers shaped like the params and divided
    by ``mb`` (the active accumulation: one sum held across slices), with
    each slice's loss and parts. With ``parallel`` (a split batch) each
    slice is cut to this rank's rows over the data axes first."""
    n = batch["tokens"].shape[0] // mb
    mesh = parallel.mesh if parallel is not None else None
    grads, gsum, losses, parts_all = None, None, [], []
    for i in range(mb):
        mbatch = batch if mb == 1 else {k: v[i * n:(i + 1) * n]
                                        for k, v in batch.items()}
        if _split(parallel):
            mbatch = rules.shard_tree(mbatch, rules.batch_shardings(mesh, mbatch),
                                      mesh)
        l, pp, g = loss_and_grads(params, cfg, mbatch, parallel)
        losses.append(l)
        parts_all.append(pp)
        if mb == 1:
            grads = g
            break
        if gsum is None:
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in T.leaves(params)]
        for acc, gi in zip(gsum, T.leaves(g)):
            acc.add_(gi)
        del g
    if grads is None:
        grads = T.unflatten_like(params, [acc.div_(mb) for acc in gsum])
    return losses, parts_all, grads


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    parallel=None, microbatches: int | None = None):
    """Training step with gradient accumulation: the batch is split into
    ``microbatches`` sequential slices (``cfg.train_microbatches`` by
    default; one where the batch does not divide), and each slice's
    gradients are added into fp32 buffers shaped like the params (the
    active accumulation: one sum held across slices), divided by the
    count; loss and parts are averaged. Then `adamw.update`, which writes
    params and state in place, as the reference's launcher donates them to
    ``jax.jit``. Returns ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)``, metrics ``loss``, ``ce``, ``z_loss``,
    ``aux``, ``grad_norm`` and ``lr`` as 0-d tensors on the device.

    ``parallel`` (`repro_torch.sharding.api.Parallel`): this process is one
    rank of a mesh, and ``params`` and ``opt_state`` are its shards as
    `repro_torch.sharding.fsdp.held_specs` and ``opt_held_specs`` cut them
    (`rules.shard_tree`). ``batch`` is the global batch, the same on every
    rank: each slice is cut to this rank's rows over the data axes
    (`rules.batch_shardings`; a slice whose rows the data axes do not
    divide raises). The params are gathered whole over the data axes, the
    forward runs with the batch split (``parallel.batch_split``: the MoE
    does not cut it again, its load-balancing means are the global
    batch's), the gradients are summed over the data group and each rank
    keeps its shard, clipped by the norm over the whole mesh
    (`fsdp.global_norm`). The loss and its parts are the global batch's,
    equal on every rank."""
    mb = microbatches if microbatches is not None else cfg.train_microbatches
    split = parallel.split_batch() if parallel is not None else None
    specs: dict = {}

    def train_step(params, opt_state, batch):
        b = batch["tokens"].shape[0]
        # smoke/CI batches may be smaller than the configured accumulation
        mb_eff = mb if (mb > 1 and b % mb == 0) else 1
        if split is None:
            losses, parts_all, grads = _accumulate(params, cfg, batch, mb_eff,
                                                   None)
            gnorm = None
        else:
            if (b // mb_eff) % split.dp_size:
                raise ValueError(
                    f"train_step: {b // mb_eff} rows a microbatch do not "
                    f"divide over {split.dp_size} data ranks")
            if "p" not in specs:
                specs["p"] = fsdp.held_specs(
                    split.mesh, init_lm(cfg, device="meta"), split.tp_axis)
            whole = fsdp.gather(params, specs["p"], split)
            losses, parts_all, grads = _accumulate(whole, cfg, batch, mb_eff,
                                                   split)
            del whole
            grads = fsdp.reduce_grads(grads, specs["p"], split)
            gnorm = fsdp.global_norm(grads, specs["p"], split)
            if split.dp_size > 1:
                # the ranks' shares of ce and z_loss, summed: the global
                # batch's (aux is already equal on every rank)
                shares = collectives.all_reduce(torch.stack([
                    torch.stack([pp["ce"], pp["z_loss"]]) for pp in parts_all]),
                    split.dp_group, site="train/loss")
                for pp, (ce, zl) in zip(parts_all, shares):
                    pp.update(ce=ce, z_loss=zl)
                losses = [pp["ce"] + pp["z_loss"] + pp["aux"]
                          for pp in parts_all]
        loss = torch.stack(losses).mean() if mb_eff > 1 else losses[0]
        parts = ({k: torch.stack([pp[k] for pp in parts_all]).mean()
                  for k in parts_all[0]} if mb_eff > 1 else parts_all[0])
        new_params, new_opt, stats = adamw.update(opt_cfg, grads, opt_state,
                                                  params, grad_norm=gnorm)
        return new_params, new_opt, {"loss": loss, **parts, **stats}

    return train_step


def _cut_kv_blocks(caches, parallel):
    """The caches with each self-attention KV cache cut to this rank's block
    of the sequence and marked `KV_SHARDED`, where ``max_len`` divides over
    the tp axis (the reference's condition for flash decoding); else as
    they are, and decode attends over the whole cache on every rank."""
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
