"""Model assembly of the port: LMs whose period layout is made of
attention, cross-attention or Mamba-2 mixers, each with a dense FFN, the
MoE or no FFN: the dense archs, the MoE decoder (qwen2-moe,
`repro_torch.models.moe`), DeepSeek-V2-Lite, whose attention is MLA
(`layers.mla_apply`) and whose first layer is dense, Mamba2
(`repro_torch.models.ssm`, attention-free), Jamba (mamba and attention
sublayers, dense and MoE FFNs in one period), Llama-3.2-Vision (four
self-attention layers and one ``"cross"`` layer a period, over stubbed
vision tokens) and SeamlessM4T (an encoder, `encode`, and ``"attn+cross"``
decoder layers over its output).

The reference stacks parameters over periods and runs the stack with
``jax.lax.scan``; the port keeps one params dict per layer in one flat list,
``params["layers"]``, and runs a Python loop over it. The list holds the
reference's ``first[i]`` (``first_dense_layers`` attention + dense-FFN
sublayers, FFN width ``first_dense_ff``) first, then period n's
``periods["sub{i}"]`` sliced at n, period by period (`layer_kinds`). A
layer's params say what it runs: ``attn`` or ``mamba``, then ``mlp`` or
``moe`` after ``norm2``, or neither (``ffn == "none"``: no ``norm2``, as in
the reference); a ``"cross"`` layer has ``cross`` in place of ``attn``, an
``"attn+cross"`` layer ``attn``, ``norm_cross`` and ``cross``. An encoder's
layers are one params dict each in ``params["enc_layers"]`` (the
reference's ``enc_periods``), after ``enc_proj`` and before ``enc_norm``.
Caches follow the same order: one flat dict of tensors per layer, a
head-major (k, v) pair, an MLA layer's latent buffer
(`layers.init_mla_cache`), a mamba layer's conv and SSM state
(`ssm.init_ssm_cache`) or a cross layer's memory keys and values
(`layers.init_cross_cache`; beside the (k, v) pair in an ``"attn+cross"``
layer), plus the position ``pos``, a 0-d int32 tensor on the caches'
device as in the reference, so that a step reads it only there.
"""

from __future__ import annotations

import functools
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.launch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

Params = dict[str, Any]


MIXERS = ("attn", "mamba", "cross", "attn+cross")
FFNS = ("dense", "moe", "none")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def check_ported(cfg: ArchConfig) -> None:
    """Raise `NotImplementedError` for a layout the reference does not
    define: stacks of attention (GQA or MLA), cross-attention or Mamba-2
    mixers (`MIXERS`), each with a dense FFN, the MoE or none (`FFNS`),
    leading dense layers, an encoder and vision tokens; a mamba sublayer
    needs an SSM config."""
    missing = [what for what, on in (
        (f"family {cfg.family!r}", cfg.family not in FAMILIES),
        (f"mixers other than {', '.join(MIXERS)}",
         any(mixer not in MIXERS for mixer, _ in cfg.period_layout)),
        (f"FFNs other than {', '.join(FFNS)}",
         any(ffn not in FFNS for _, ffn in cfg.period_layout)),
        ("mamba sublayers without an SSM config",
         cfg.ssm is None and any(m == "mamba" for m, _ in cfg.period_layout)))
        if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the port runs the reference's stacks of "
            f"{', '.join(MIXERS)} mixers with {', '.join(FFNS)} FFNs; "
            f"{', '.join(missing)} are not among them")


def layer_kinds(cfg: ArchConfig) -> list[tuple[str, str]]:
    """Each layer's (mixer, ffn) in the flat list's order: the leading dense
    layers, then the period layout ``n_periods`` times."""
    return ([("attn", "dense")] * cfg.first_dense_layers
            + list(cfg.period_layout) * cfg.n_periods)


def _layer_init(gen, cfg: ArchConfig, mixer: str, ffn: str, device,
                d_ff: int | None = None) -> Params:
    """One sublayer: a mamba mixer, cross-attention (``"cross"``), or MLA
    where the config has it, else GQA attention, followed by ``norm_cross``
    and cross-attention in an ``"attn+cross"`` layer; then the dense FFN
    ``d_ff`` wide (the config's by default), the MoE, or nothing
    (``"none"``: no ``norm2``)."""
    dt = L.dtype_of(cfg)
    p = {"norm1": L.norm_init(cfg.d_model, dt, device, cfg.norm)}
    if mixer == "mamba":
        p["mamba"] = S.mamba_init(gen, cfg, device)
    elif mixer == "cross":
        p["cross"] = L.attn_init(gen, cfg, device, cross=True)
    else:
        p["attn"] = (L.mla_init if cfg.mla else L.attn_init)(gen, cfg, device)
        if mixer == "attn+cross":
            p["norm_cross"] = L.norm_init(cfg.d_model, dt, device, cfg.norm)
            p["cross"] = L.attn_init(gen, cfg, device, cross=True)
    if ffn != "none":
        p["norm2"] = L.norm_init(cfg.d_model, dt, device, cfg.norm)
    if ffn == "moe":
        p["moe"] = M.moe_init(gen, cfg, device)
    elif ffn == "dense":
        p["mlp"] = L.mlp_init(gen, cfg.d_model, d_ff or cfg.d_ff, dt, device,
                              gated=cfg.gated_mlp)
    return p


def _layer_apply(p: Params, x: torch.Tensor, cfg: ArchConfig, *,
                 positions: torch.Tensor, cache: Params | None,
                 cache_pos: torch.Tensor | None, start: int | None,
                 memory: torch.Tensor | None = None, causal: bool = True,
                 parallel=None, attn_parallel=None
                 ) -> tuple[torch.Tensor, Params | None, torch.Tensor | None]:
    """One sublayer: the mamba mixer, cross-attention over ``memory`` (or
    the cross cache), or self-attention (``causal`` unless an encoder's),
    followed in an ``"attn+cross"`` layer by ``norm_cross`` and
    cross-attention, each added to the residual; then the dense or MoE FFN
    where the layer has one. ``parallel`` goes to the MoE (the experts'
    partial sums combined across the tp axis), ``attn_parallel`` to
    self-attention (flash decoding over a sequence-sharded cache). Returns
    (x, cache, aux), aux the MoE's loss or None."""
    h = L.norm_apply(p["norm1"], x, cfg.norm_eps)
    if "mamba" in p:
        out, cache = S.mamba_apply(p["mamba"], h, cfg, cache=cache)
    elif "attn" not in p:
        out, cache = L.cross_apply(p["cross"], h, cfg, cache=cache, memory=memory)
    else:
        apply = L.mla_apply if cfg.mla else L.attn_apply
        out, cache = apply(p["attn"], h, cfg, positions=positions, cache=cache,
                           cache_pos=cache_pos, start=start,
                           **({} if cfg.mla else {"causal": causal,
                                                  "parallel": attn_parallel}))
        if "cross" in p:
            x = x + out
            h = L.norm_apply(p["norm_cross"], x, cfg.norm_eps)
            out, cache = L.cross_apply(p["cross"], h, cfg, cache=cache,
                                       memory=memory)
    x = x + out
    if "norm2" not in p:
        return x, cache, None
    h = L.norm_apply(p["norm2"], x, cfg.norm_eps)
    if "moe" in p:
        out, aux = M.moe_apply(p["moe"], h, cfg, parallel)
        return x + out, cache, aux
    return x + L.mlp_apply(p["mlp"], h, cfg.act), cache, None


# ----------------------------------------------------------------- full model
def init_lm(cfg: ArchConfig, *, seed: int = 0, device="cuda") -> Params:
    """Random weights from ``seed`` on ``device`` with the reference's
    distributions: fan-in normal / sqrt(d_in) for projections, normal * 0.02
    for the embedding, norms 1, biases 0. On the meta device only shapes."""
    check_ported(cfg)
    device = resolve_device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))
    dt = L.dtype_of(cfg)
    p: Params = {
        "embed": {"w": L.normal(gen, (cfg.padded_vocab, cfg.d_model), 0.02,
                                dt, device)},
        "final_norm": L.norm_init(cfg.d_model, dt, device, cfg.norm),
        "layers": [_layer_init(gen, cfg, mixer, ffn, device,
                               cfg.first_dense_ff if i < cfg.first_dense_layers
                               else None)
                   for i, (mixer, ffn) in enumerate(layer_kinds(cfg))],
    }
    if not cfg.tie_embed:
        p["lm_head"] = L.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt,
                                    device)
    if cfg.encoder:
        p["enc_proj"] = L.dense_init(gen, cfg.encoder.frontend_dim,
                                     cfg.d_model, dt, device)
        p["enc_layers"] = [_layer_init(gen, cfg, "attn", "dense", device)
                           for _ in range(cfg.encoder.n_layers)]
        p["enc_norm"] = L.norm_init(cfg.d_model, dt, device, cfg.norm)
    return p


def init_caches(cfg: ArchConfig, batch: int, max_len: int, *,
                mem_len: int = 0, device="cuda") -> Params:
    """``pos``, a 0-d int32 zero on ``device``, and one zeroed cache per
    layer: a head-major (k, v) pair (`layers.init_kv_cache`), for MLA the
    latent buffer (`layers.init_mla_cache`), for a mamba layer its conv
    window and SSM state (`ssm.init_ssm_cache`; ``max_len`` does not bound
    it), for a cross layer the memory's keys and values over ``mem_len``
    positions (`layers.init_cross_cache`), an ``"attn+cross"`` layer's
    both in one dict."""
    check_ported(cfg)
    device = resolve_device(device)
    init = L.init_mla_cache if cfg.mla else L.init_kv_cache

    def layer_cache(mixer: str) -> Params:
        if mixer == "mamba":
            return S.init_ssm_cache(cfg, batch, device)
        if mixer == "cross":
            return L.init_cross_cache(cfg, batch, mem_len, device)
        c = init(cfg, batch, max_len, device)
        if mixer == "attn+cross":
            c.update(L.init_cross_cache(cfg, batch, mem_len, device))
        return c

    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "layers": [layer_cache(mixer) for mixer, _ in layer_kinds(cfg)]}


def cache_capacity(caches: Params) -> int | None:
    """The positions a stack's caches hold, read from its first attention
    layer in either layout: axis 2 of a head-major (B, Hkv, max_len, hd) key
    cache, axis 1 of an MLA latent buffer (B, max_len, kv_lora + qk_rope).
    A cross layer's memory keys (`layers.CROSS_K`) are not read: the memory
    does not grow. None for a stack with no self-attention layer (Mamba2):
    its state has no length to outgrow."""
    for layer in caches["layers"]:
        if "k" in layer:
            return layer["k"].shape[2]
        if L.MLA_CACHE in layer:
            return layer[L.MLA_CACHE].shape[1]
    return None


@functools.cache
def embed_scale(d_model: int, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to ``dtype``, as a Python float: x times it
    rounds as the reference's product with ``jnp.asarray(d ** 0.5, x.dtype)``
    does, with no tensor made on the device."""
    return float(torch.tensor(d_model ** 0.5, dtype=dtype))


@functools.cache
def _dot_ops() -> frozenset:
    """What the "dots" policy keeps of a layer's forward: the matmuls'
    outputs."""
    return frozenset(getattr(torch.ops.aten, name).default
                     for name in ("mm", "bmm", "addmm", "baddbmm"))


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _dot_ops()
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(parallel, caches) -> str:
    """The checkpoint policy of a forward: ``parallel.remat`` where a
    gradient is wanted and no cache is filled, else "none" (as the
    reference's ``parallel=None`` is)."""
    if parallel is None or caches is not None or not torch.is_grad_enabled():
        return "none"
    return parallel.remat


def _run_layer(remat: str, lp: Params, x: torch.Tensor, cfg: ArchConfig,
               **kw) -> tuple[torch.Tensor, Params | None, torch.Tensor | None]:
    """`_layer_apply` under ``remat``: "full" is `torch.utils.checkpoint`
    over the layer (its forward runs again in the backward), "dots" a
    selective checkpoint that keeps the matmul outputs
    (``jax.checkpoint_policies.checkpoint_dots``), "none" the layer as it
    is."""
    if remat == "none":
        return _layer_apply(lp, x, cfg, **kw)
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    extra = ({} if remat == "full" else {"context_fn": functools.partial(
        create_selective_checkpoint_contexts, _dots_policy)})
    return checkpoint(functools.partial(_layer_apply, cfg=cfg, **kw), lp, x,
                      use_reentrant=False, **extra)


def encode(params: Params, cfg: ArchConfig, frames: torch.Tensor,
           parallel=None) -> torch.Tensor:
    """The encoder of an enc-dec arch. ``frames``: the stubbed modality
    frontend's output (B, S_enc, frontend_dim), precomputed frame
    embeddings. ``enc_proj``, then the encoder's layers, each non-causal
    self-attention (rope at positions 0 .. S_enc - 1) and a dense FFN, with
    no cache, then ``enc_norm``: the memory (B, S_enc, d_model) of the
    decoder's cross-attention. ``parallel`` sets the layers' checkpoint
    policy (`forward`)."""
    x = L.dense(params["enc_proj"], frames)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = _remat(parallel, None)
    for lp in params["enc_layers"]:
        x, _, _ = _run_layer(remat, lp, x, cfg, positions=positions,
                             cache=None, cache_pos=None, start=None,
                             causal=False)
    return L.norm_apply(params["enc_norm"], x, cfg.norm_eps)


def layers_apply(layers: list, x: torch.Tensor, cfg: ArchConfig,
                 parallel=None) -> torch.Tensor:
    """Hidden states (B, S, d) through ``layers`` (a run of
    ``params["layers"]``) at positions 0 .. S - 1, without caches or
    memory: a pipeline stage's body (`repro_torch.runtime.pipeline`)."""
    positions = torch.arange(x.shape[1], device=x.device)
    remat = _remat(parallel, None)
    for lp in layers:
        x, _, _ = _run_layer(remat, lp, x, cfg, positions=positions,
                             cache=None, cache_pos=None, start=None,
                             parallel=parallel)
    return x


#: the key a caches dict carries when its self-attention KV caches are this
#: rank's blocks of the sequence (`repro_torch.models.steps` cuts them after
#: a prefill under a flash-decoding `Parallel`)
KV_SHARDED = "kv_sharded"


def forward(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
            caches: Params | None = None, start: int | None = None,
            memory: torch.Tensor | None = None, parallel=None
            ) -> tuple[torch.Tensor, Params | None, torch.Tensor]:
    """tokens: (B, S) int -> (logits (B, S, padded_vocab), new_caches,
    aux_loss). The caches are updated in place and returned with ``pos``
    advanced by S: the positions are built from ``caches["pos"]`` on the
    device and nothing is read on the host. ``start`` is the position where
    the caller knows it on the host (a prefill into fresh caches: 0); the
    attention then takes it as an integer (`layers.attn_apply`). aux_loss
    is the MoE layers' losses summed in fp32 (0 for the dense stack).
    ``memory`` (B, Sm, d_model), the encoder's output (`encode`) or the
    stubbed vision embeddings, is what the cross layers attend to; with
    caches it is written into their cross caches, and a step without it
    (decode) reads them.

    ``parallel`` (`repro_torch.sharding.api.Parallel`): this process is one
    rank of a mesh. The MoE layers combine their experts' partial sums
    across the tp axis; with caches marked `KV_SHARDED`, self-attention
    decodes over each rank's block of the sequence. Everything else runs
    replicated on every rank, the same math as the reference, whose
    ``_constrain`` and ``_seq_shard`` are sharding annotations that change
    no value: in the port they have no counterpart. Where a gradient is
    wanted and no cache is filled, each layer runs under
    ``parallel.remat`` (`_run_layer`), the reference's checkpoint of its
    period scan. ``parallel=None`` is one device, with no checkpoint."""
    check_ported(cfg)
    x = params["embed"]["w"][tokens]
    if cfg.embed_scale:
        x = x * embed_scale(cfg.d_model, x.dtype)
    s = tokens.shape[1]
    pos = caches["pos"] if caches is not None else None
    positions = torch.arange(s, device=tokens.device)
    if pos is not None:
        positions = pos + positions
    sharded = caches is not None and caches.get(KV_SHARDED, False)
    remat = _remat(parallel, caches)
    layer_caches = []
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params["layers"]):
        c = caches["layers"][i] if caches is not None else None
        x, c, aux = _run_layer(remat, lp, x, cfg, positions=positions,
                               cache=c, cache_pos=pos, start=start,
                               memory=memory, parallel=parallel,
                               attn_parallel=parallel if sharded else None)
        layer_caches.append(c)
        if aux is not None:
            aux_total = aux_total + aux
    new_caches = (None if caches is None
                  else {"pos": pos + s, "layers": layer_caches,
                        **({KV_SHARDED: True} if sharded else {})})
    x = L.norm_apply(params["final_norm"], x, cfg.norm_eps)
    head_w = (params["embed"]["w"].T if cfg.tie_embed
              else params["lm_head"]["w"])
    logits = x @ head_w
    return logits, new_caches, aux_total


# ------------------------------------------------------------------- counting
def count_params(cfg: ArchConfig, active_only: bool = False) -> int:
    """Parameters of `init_lm`'s tree, counted from shapes on the meta
    device. ``active_only`` counts a token's share of the routed experts,
    top_k of n_routed, as the reference does."""
    counts = {"total": 0, "routed": 0}

    def walk(node, routed: bool) -> None:
        if isinstance(node, torch.Tensor):
            counts["total"] += node.numel()
            counts["routed"] += node.numel() if routed else 0
        elif isinstance(node, dict):
            for key, value in node.items():
                walk(value, routed or key == "routed")
        else:
            for value in node:
                walk(value, routed)

    walk(init_lm(cfg, device="meta"), False)
    total = counts["total"]
    if active_only and cfg.moe:
        total -= round(counts["routed"] * (1 - cfg.moe.top_k / cfg.moe.n_routed))
    return total


# ------------------------------------------------------------ weight carrier
#: the reference's leaves kept in fp32 whatever the config's dtype
FP32_KEYS = frozenset({"router", "A_log", "D", "dt_bias"})


def params_from_jax(tree: Mapping[str, Any], cfg: ArchConfig,
                    device="cuda") -> Params:
    """The reference's ``init_lm`` tree, as nested dicts of numpy arrays,
    turned into `init_lm`'s structure: ``first[i]`` in front, then the
    leading ``n_periods`` axis of ``periods`` unstacked into one params dict
    per layer, in the config's dtype on ``device`` (MLA's ``kv_norm`` scale
    too, as the reference's is); the MoE router and a mamba layer's
    ``A_log``, ``D`` and ``dt_bias`` stay fp32, as the reference's are (a
    router in bf16 would route differently). A cross layer's scalar
    ``gate`` stays 0-d. An encoder's ``enc_periods`` (one layer a period)
    are unstacked over its ``n_layers`` into ``enc_layers``, between
    ``enc_proj`` and ``enc_norm``."""
    check_ported(cfg)
    device = resolve_device(device)

    def convert(node, index=None, dt=L.dtype_of(cfg)):
        if isinstance(node, Mapping):
            return {k: convert(v, index, torch.float32 if k in FP32_KEYS else dt)
                    for k, v in node.items()}
        a = np.array(node, dtype=np.float32)
        if index is not None:
            a = np.array(a[index], order="C")        # a 0-d slice stays 0-d
        return torch.from_numpy(a).to(device, dt)

    layout = cfg.period_layout
    p: Params = {
        "embed": convert(tree["embed"]),
        "final_norm": convert(tree["final_norm"]),
        "layers": [convert(first) for first in tree.get("first", ())]
        + [convert(tree["periods"][f"sub{i}"], n)
           for n in range(cfg.n_periods) for i in range(len(layout))],
    }
    if "lm_head" in tree:
        p["lm_head"] = convert(tree["lm_head"])
    if cfg.encoder:
        p["enc_proj"] = convert(tree["enc_proj"])
        p["enc_layers"] = [convert(tree["enc_periods"]["sub0"], n)
                           for n in range(cfg.encoder.n_layers)]
        p["enc_norm"] = convert(tree["enc_norm"])
    return p
