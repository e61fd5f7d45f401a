"""Step factories: prefill_step / decode_step for the port's stacks, and the
greedy sampling loop. The factories return the plain step bodies, as the
reference's do, each carrying its config as ``step.cfg``;
`repro_torch.launch.graph` compiles them (captured CUDA graphs on the card),
as the reference's callers wrap them in ``jax.jit``.
``lm_loss`` and the train step wait for the training slice (ROADMAP A8)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import graph
from repro_torch.models.transformer import encode, forward, init_caches


def _memory_from_batch(cfg: ArchConfig, params, batch):
    """The cross-attention memory of a vlm or enc-dec arch: the encoder's
    output over the batch's ``frames``, or the batch's ``vision_ctx`` as it
    stands; None for the other archs."""
    if cfg.encoder is not None:
        return encode(params, cfg, batch["frames"])
    if cfg.n_vision_tokens:
        return batch["vision_ctx"]
    return None


def make_prefill_step(cfg: ArchConfig, max_len: int):
    """Full-sequence forward that fills caches and returns the last token's
    logits (sampling seed). The caches are fresh ones on the tokens' device,
    or ``caches`` where given, zeroed at position 0 (the compiled step's
    static cache); either way the position is 0 on the host, so attention
    takes it as an integer. A vlm or enc-dec arch's batch also carries
    ``vision_ctx`` or ``frames`` (`repro_torch.data.make_extra_inputs`):
    the memory is computed here (the encoder runs inside the step) and its
    keys and values fill the cross caches."""
    def prefill_step(params, batch, caches=None):
        tokens = batch["tokens"]
        memory = _memory_from_batch(cfg, params, batch)
        if caches is None:
            caches = init_caches(cfg, tokens.shape[0], max_len,
                                 mem_len=0 if memory is None else memory.shape[1],
                                 device=tokens.device)
        logits, caches, _ = forward(params, cfg, tokens, caches=caches, start=0,
                                    memory=memory)
        return logits[:, -1], caches

    prefill_step.cfg = cfg
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """One-token decode against a populated cache (the cross keys and values
    included, so no memory is needed); it reads its position on the device
    only."""
    def decode_step(params, caches, token):
        logits, caches, _ = forward(params, cfg, token, caches=caches)
        return logits[:, -1], caches

    decode_step.cfg = cfg
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
