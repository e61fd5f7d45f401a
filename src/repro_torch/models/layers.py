"""Core layer library of the port: dense projections, norms, rotary
embeddings, GQA/MQA self-attention with a KV cache (causal, or not for an
encoder), cross-attention over an encoder's or a vision stub's memory with
its cross cache, DeepSeek's multi-head latent attention (MLA) with its
latent cache, and gated MLPs.

Functional like the reference (``repro/models/layers.py``): ``*_init(...) ->
params dict`` and ``*_apply(params, x, ...) -> y`` over plain dicts of
tensors. Attention runs through `ops.gqa_flash_attention`: the flash kernel
keeps the running (m, l, acc) partial sums on chip and never materialises
S = QK^T, the schedule the reference's ``chunked_attention`` computes at the
XLA level. MLA's prefill (the expanded form) takes the same kernel; its
absorbed decode, whose 576-wide keys are wider than the kernel is built
for, runs `chunked_attention`, the plain counterpart of the reference's
own plain-XLA path.

Training differentiates attention through `FlashAttention`: the flash
kernel is its forward, and its backward recomputes `chunked_attention`
on the saved inputs and differentiates that, which is the function the
reference's ``jax.value_and_grad`` differentiates. Every call site goes
through `attention`, which takes the Function only where a gradient is
wanted, so serving (inference mode, CUDA-graph capture) runs the kernel
as before.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

Params = dict[str, Any]

ACTS = {"silu": F.silu,
        "gelu": functools.partial(F.gelu, approximate="tanh"),  # as jax.nn.gelu
        "relu": torch.relu}


def dtype_of(cfg) -> torch.dtype:
    """The activation and weight type a config names ("bfloat16", ...)."""
    return getattr(torch, cfg.dtype)


def normal(gen: torch.Generator | None, shape: tuple[int, ...], scale: float,
           dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """N(0, scale^2) drawn in fp32 from ``gen`` and cast to ``dtype``; only a
    shape on the meta device."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


# --------------------------------------------------------------------- basics
def dense_init(gen, d_in: int, d_out: int, dtype, device,
               bias: bool = False) -> Params:
    p = {"w": normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def norm_init(d: int, dtype, device, kind: str = "rmsnorm") -> Params:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """rmsnorm, or layernorm where the params have a bias; computed in fp32
    and cast back."""
    xf = x.float()
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


# ----------------------------------------------------------------------- rope
def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rope_dim: int | None = None) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (S,) or (B, S). Rotates the first
    ``rope_dim`` dims (full head by default) in interleaved pairs
    (x[..., 0::2], x[..., 1::2]), as the reference does."""
    hd = x.shape[-1]
    rd = rope_dim or hd
    freqs = theta ** (-torch.arange(0, rd, 2, dtype=torch.float32,
                                    device=x.device) / rd)        # (rd/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                     # (B, S, rd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rd].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    rot = rot.reshape(x.shape[:-1] + (rd,)).to(x.dtype)
    return torch.cat([rot, x[..., rd:]], -1) if rd < hd else rot


# ----------------------------------------------------- chunked (online) attn
def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int | torch.Tensor = 0,
                      kv_valid_len: int | torch.Tensor | None = None,
                      chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over kv chunks, the reference's
    ``chunked_attention`` in plain PyTorch. q: (B, Hq, Sq, D); k: (B, Hkv,
    Skv, D); v: (B, Hkv, Skv, Dv), Hq % Hkv == 0 (GQA by logical grouping:
    no kv head is repeated). Scores are q k^T / sqrt(D) in fp32; the
    output is in q's dtype.

    ``q_offset`` is the position of q[0] and keys at or past
    ``kv_valid_len`` are masked (a cache's tail); either may be a 0-d
    tensor on the device, which is compared there and never read on the
    host, so that a CUDA graph can capture the call. The last chunk may be
    shorter than ``chunk``: it is sliced, not padded, so a cache reaches
    the loop with no copy. A masked key gets p = 0, and a row that has
    seen no valid key yet keeps m = -inf without a NaN, as in the
    reference."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[-1]
    g = hq // hkv
    dev = q.device
    qg = q.reshape(b, hkv, g, sq, d).float() / math.sqrt(d)
    chunk = min(chunk, skv)
    q_pos = q_offset + torch.arange(sq, device=dev)
    acc = torch.zeros((b, hkv, g, sq, dv), dtype=torch.float32, device=dev)
    m_run = torch.full((b, hkv, g, sq, 1), -math.inf, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((b, hkv, g, sq, 1), dtype=torch.float32, device=dev)
    for c0 in range(0, skv, chunk):
        kb = k[:, :, c0:c0 + chunk].float()
        vb = v[:, :, c0:c0 + chunk].float()
        k_pos = c0 + torch.arange(kb.shape[2], device=dev)
        mask = torch.ones((sq, kb.shape[2]), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if kv_valid_len is not None:
            mask = mask & (k_pos[None, :] < kv_valid_len)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb)
        s = torch.where(mask, s, -math.inf)
        m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask, torch.exp(s - m_safe), 0.0)
        alpha = torch.exp(torch.clamp_max(m_run - m_safe, 0.0))
        alpha = torch.where(torch.isfinite(m_run), alpha, 0.0)
        l_run = l_run * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m_run = m_new
    out = acc / torch.clamp_min(l_run, 1e-30)
    return out.reshape(b, hq, sq, dv).to(q.dtype)


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is the flash kernel
    (`ops.gqa_flash_attention`; its plain version on the CPU) and whose
    backward is autograd through `chunked_attention`, recomputed on the
    saved q, k and v under the call's own (logical) arguments: ``causal``,
    an integer ``q_offset`` and ``kv_valid_len`` as the caller gave them,
    not as the flash wrapper rewrites them (a ragged non-causal call run
    as a causal one, a narrower v padded). The backward launches no flash
    kernel; it costs one more ``chunked_attention`` forward a call."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_valid_len, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, q_offset, kv_valid_len, chunk)
        return ops.gqa_flash_attention(q, k, v, causal=causal,
                                       q_offset=q_offset,
                                       kv_valid_len=kv_valid_len)

    @staticmethod
    def backward(ctx, grad_out):
        causal, q_offset, kv_valid_len, chunk = ctx.args
        saved = ctx.saved_tensors
        wanted = [i for i in range(3) if ctx.needs_input_grad[i]]
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_(i in wanted)
                   for i, t in enumerate(saved)]
            out = chunked_attention(*qkv, causal=causal, q_offset=q_offset,
                                    kv_valid_len=kv_valid_len, chunk=chunk)
            grads = torch.autograd.grad(out, [qkv[i] for i in wanted],
                                        grad_out)
        full = [None] * 3
        for i, g in zip(wanted, grads):
            full[i] = g
        return (*full, None, None, None, None)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset: int | torch.Tensor = 0,
              kv_valid_len: int | torch.Tensor | None = None,
              chunk: int = 1024) -> torch.Tensor:
    """Attention as every layer calls it; shapes and arguments as in
    `ops.gqa_flash_attention`. Where grad is enabled and q, k or v
    requires it, `FlashAttention` (the kernel forward, ``chunked_attention``
    over ``chunk`` keys a step as its backward); otherwise the flash
    wrapper itself, so that inference and a captured step run as they
    did. A position on the device (a cache) is refused where a gradient
    is wanted: training has no cache."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if (isinstance(q_offset, torch.Tensor)
                or isinstance(kv_valid_len, torch.Tensor)):
            raise ValueError("attention: a gradient through a call whose "
                             "position is a device tensor (a cache) is not "
                             "supported; training runs without caches")
        return FlashAttention.apply(q, k, v, causal, q_offset, kv_valid_len,
                                    chunk)
    return ops.gqa_flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_valid_len=kv_valid_len)


# ------------------------------------------------------------------ attention
def attn_init(gen, cfg, device, cross: bool = False) -> Params:
    """``wq``, ``wk``, ``wv``, ``wo`` (and the qk norms where the config has
    them); a cross-attention layer (``cross``) also has the scalar tanh
    ``gate`` of Llama-3.2-Vision, zero as in the reference, so that at init
    cross-attention adds nothing to the residual."""
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = dtype_of(cfg)
    p = {
        "wq": dense_init(gen, d, hq * hd, dt, device, cfg.qkv_bias),
        "wk": dense_init(gen, d, hkv * hd, dt, device, cfg.qkv_bias),
        "wv": dense_init(gen, d, hkv * hd, dt, device, cfg.qkv_bias),
        "wo": dense_init(gen, hq * hd, d, dt, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(hd, dt, device)
        p["k_norm"] = norm_init(hd, dt, device)
    if cross:
        p["gate"] = torch.zeros((), dtype=dt, device=device)
    return p


def init_kv_cache(cfg, batch: int, max_len: int, device) -> Params:
    """Zeroed keys and values, head-major: (B, Hkv, max_len, hd), so that
    the flash kernel reads each kv head's keys as one contiguous block with
    no copy (the reference keeps (B, max_len, Hkv, hd))."""
    shape = (batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}


#: a cross-attention layer's cache: the keys and values of the memory,
#: head-major (B, Hkv, Sm, hd), under names of their own, so that a layer
#: with self- and cross-attention keeps one flat dict of tensors and
#: `transformer.cache_capacity` reads "k" of self-attention only
CROSS_K, CROSS_V = "cross_k", "cross_v"


def init_cross_cache(cfg, batch: int, mem_len: int, device) -> Params:
    """Zeroed cross keys and values, head-major (B, Hkv, mem_len, hd) (the
    reference keeps (B, mem_len, Hkv, hd)): computed once from the memory at
    prefill, read by every decode step."""
    shape = (batch, cfg.n_kv_heads, mem_len, cfg.hd)
    return {CROSS_K: torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            CROSS_V: torch.zeros(shape, dtype=dtype_of(cfg), device=device)}


def cross_apply(p: Params, x: torch.Tensor, cfg, *,
                cache: Params | None = None,
                memory: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, Params | None]:
    """Cross-attention: queries from x, keys and values from ``memory`` (B,
    Sm, d) where given, written in place into the cache's `CROSS_K` and
    `CROSS_V` (a prefill), else read from them (a decode step). No rope, no
    qk-norm, not causal: every query sees all Sm keys. One query against
    the cache passes the valid length Sm as a 0-d tensor on the device, so
    the flash kernel takes split_kv, whose blocks serve all q heads of a kv
    head at once; the one-pass bodies give a block to each q head. Then
    ``wo``, and the output times tanh(gate) (rounded to the output's dtype,
    as in the reference)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = dense(p["wq"], x).reshape(b, s, hq, hd).transpose(1, 2)
    valid = None
    if memory is not None:
        sm = memory.shape[1]
        k = dense(p["wk"], memory).reshape(b, sm, hkv, hd).transpose(1, 2)
        v = dense(p["wv"], memory).reshape(b, sm, hkv, hd).transpose(1, 2)
        if cache is not None:
            if tuple(cache[CROSS_K].shape) != tuple(k.shape):
                raise ValueError(f"cross_apply: memory of {sm} keys for a "
                                 f"cross cache of {tuple(cache[CROSS_K].shape)}")
            cache[CROSS_K].copy_(k)
            cache[CROSS_V].copy_(v)
            k, v = cache[CROSS_K], cache[CROSS_V]
    else:
        if cache is None:
            raise ValueError("cross_apply: cross-attention without memory "
                             "needs the cross cache a prefill filled")
        k, v = cache[CROSS_K], cache[CROSS_V]
        if s == 1:
            valid = torch.full((), k.shape[2], dtype=torch.int32,
                               device=x.device)
    out = attention(q, k, v, causal=False, kv_valid_len=valid,
                    chunk=cfg.attn_chunk)
    out = dense(p["wo"], out.transpose(1, 2).reshape(b, s, hq * hd))
    return torch.tanh(p["gate"].float()).to(out.dtype) * out, cache


def attn_apply(p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
               cache: Params | None = None,
               cache_pos: torch.Tensor | None = None,
               start: int | None = None, causal: bool = True
               ) -> tuple[torch.Tensor, Params | None]:
    """Self-attention with an optional KV cache, causal unless ``causal`` is
    False (an encoder's, with no cache); cross-attention is `cross_apply`.
    x: (B, S, d); positions: (S,) on x's device.

    With a cache, this step's keys and values are written at ``positions``
    with ``index_copy_`` on that device index (in place: the reference's
    ``dynamic_update_slice`` at ``cache_pos`` returns an updated copy), and
    the queries attend over the whole cache with ``q_offset = cache_pos``
    and ``kv_valid_len = cache_pos + S``, both 0-d tensors on the device:
    nothing is read on the host, so a CUDA graph can capture the step.
    ``start``, where the caller knows the position on the host (a prefill
    into fresh caches: 0), attends to keys [0, start + S) of the cache with
    an integer offset instead, which the flash kernel's one-pass bodies
    take. Returns (out, cache)."""
    b, s, _ = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = dense(p["wq"], x).reshape(b, s, hq, hd)
    k = dense(p["wk"], x).reshape(b, s, hkv, hd)
    v = dense(p["wv"], x).reshape(b, s, hkv, hd)
    if cfg.qk_norm:
        q = norm_apply(p["q_norm"], q, cfg.norm_eps)
        k = norm_apply(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta).transpose(1, 2)
    k = apply_rope(k, positions, cfg.rope_theta).transpose(1, 2)
    v = v.transpose(1, 2)
    if cache is None:
        out = attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    else:
        cap = cache["k"].shape[2]
        if s > cap or (start is not None and not 0 <= start <= cap - s):
            at = "" if start is None else f" at position {start}"
            raise ValueError(f"attn_apply: {s} tokens{at} do not fit a "
                             f"cache of {cap}")
        cache["k"].index_copy_(2, positions, k)
        cache["v"].index_copy_(2, positions, v)
        if start is None:
            out = attention(
                q, cache["k"], cache["v"], causal=True, q_offset=cache_pos,
                kv_valid_len=cache_pos + s, chunk=cfg.attn_chunk)
        else:
            n = start + s
            out = attention(
                q, cache["k"][:, :, :n], cache["v"][:, :, :n], causal=True,
                q_offset=start, chunk=cfg.attn_chunk)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return dense(p["wo"], out), cache


# ------------------------------------------------------------------------ MLA
#: an MLA layer's cache: (B, max_len, kv_lora + qk_rope), the normalised
#: latent in columns [:kv_lora] and the rotated shared key k_pe after them
MLA_CACHE = "latent_pe"


def mla_init(gen, cfg, device) -> Params:
    """The reference's tree: ``wq`` (d, H (qk_nope + qk_rope)), ``wkv_a``
    (d, kv_lora + qk_rope), the latent's rmsnorm ``kv_norm``, ``wkv_b``
    (kv_lora, H (qk_nope + v_head)) and ``wo`` (H v_head, d)."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    dt = dtype_of(cfg)
    return {
        "wq": dense_init(gen, d, h * (m.qk_nope + m.qk_rope), dt, device),
        "wkv_a": dense_init(gen, d, m.kv_lora + m.qk_rope, dt, device),
        "kv_norm": norm_init(m.kv_lora, dt, device),
        "wkv_b": dense_init(gen, m.kv_lora, h * (m.qk_nope + m.v_head), dt,
                            device),
        "wo": dense_init(gen, h * m.v_head, d, dt, device),
    }


def init_mla_cache(cfg, batch: int, max_len: int, device) -> Params:
    """One zeroed buffer under `MLA_CACHE`, (B, max_len, kv_lora +
    qk_rope): the latent in columns [:kv_lora], k_pe in the rest (the
    reference keeps two arrays, ``latent`` and ``k_pe``). The absorbed
    decode's keys are then the buffer itself and its values a view of it,
    where concatenating two arrays would copy the whole cache every step."""
    m = cfg.mla
    return {MLA_CACHE: torch.zeros((batch, max_len, m.kv_lora + m.qk_rope),
                                   dtype=dtype_of(cfg), device=device)}


def _mla_expand(latent: torch.Tensor, k_pe: torch.Tensor, wkv_b: torch.Tensor,
                m, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The expanded form's keys and values, head-major: k = [latent W_bk,
    k_pe] (B, H, S, qk_nope + qk_rope), k_pe shared by the heads, and v =
    latent W_bv (B, H, S, v_head). The product is in fp32 and cast to
    ``dtype``, as the reference's is."""
    kv = torch.einsum("bsl,lhe->bhse", latent.float(), wkv_b.float()).to(dtype)
    b, h, skv, _ = kv.shape
    k = torch.cat([kv[..., :m.qk_nope],
                   k_pe[:, None].expand(b, h, skv, m.qk_rope)], -1)
    return k, kv[..., m.qk_nope:]


def _mla_absorbed(q_nope: torch.Tensor, q_pe: torch.Tensor, buf: torch.Tensor,
                  wkv_b: torch.Tensor, m, *, q_offset, kv_valid_len, chunk: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """The absorbed decode: q_nope W_bk^T (fp32) and q_pe against the cache
    as one kv head of kv_lora + qk_rope dims, the latent as its values,
    through `chunked_attention`; the output expanded through W_bv in fp32.
    `chunked_attention` scales by 1/sqrt(kv_lora + qk_rope); q is
    pre-scaled to MLA's 1/sqrt(qk_nope + qk_rope). Returns (B, S, H v_head)
    in ``dtype``."""
    b, s, h, _ = q_nope.shape
    w_bk, w_bv = wkv_b[..., :m.qk_nope], wkv_b[..., m.qk_nope:]
    q_abs = torch.einsum("bshn,lhn->bshl", q_nope.float(), w_bk.float())
    q_full = torch.cat([q_abs, q_pe.float()], -1) * (
        math.sqrt(m.kv_lora + m.qk_rope) / math.sqrt(m.qk_nope + m.qk_rope))
    out = chunked_attention(
        q_full.transpose(1, 2).to(dtype), buf[:, None],
        buf[:, None, :, :m.kv_lora], causal=True, q_offset=q_offset,
        kv_valid_len=kv_valid_len, chunk=chunk)          # (B, H, S, kv_lora)
    ctx = torch.einsum("bhsl,lhv->bshv", out.float(), w_bv.float())
    return ctx.reshape(b, s, h * m.v_head).to(dtype)


def mla_apply(p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
              cache: Params | None = None,
              cache_pos: torch.Tensor | None = None,
              start: int | None = None) -> tuple[torch.Tensor, Params | None]:
    """DeepSeek-V2 multi-head latent attention. x: (B, S, d); positions,
    ``cache_pos`` and ``start`` as in `attn_apply`.

    With a cache, this step's latent and k_pe are written at ``positions``
    with one ``index_copy_`` into the layer's `MLA_CACHE` buffer. One token
    with a cache takes the absorbed form (`_mla_absorbed`: per step
    O(S kv_lora), no per-head key of the cache is made); anything else the
    expanded form: keys and values of every head (`_mla_expand`) through
    `ops.gqa_flash_attention`, q and k 192 wide and v 128 at full width, at
    the scale 1/sqrt(qk_nope + qk_rope). With ``start`` known on the host
    only keys [0, start + S) are expanded and attended with an integer
    offset; else the whole cache, with the position on the device.
    Returns (out, cache)."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    q = dense(p["wq"], x).reshape(b, s, h, m.qk_nope + m.qk_rope)
    q_nope, q_pe = q[..., :m.qk_nope], q[..., m.qk_nope:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta)
    kv_a = dense(p["wkv_a"], x)
    latent = norm_apply(p["kv_norm"], kv_a[..., :m.kv_lora], cfg.norm_eps)
    k_pe = apply_rope(kv_a[..., None, m.kv_lora:], positions,
                      cfg.rope_theta)[..., 0, :]                  # (B, S, rope)
    wkv_b = p["wkv_b"]["w"].reshape(m.kv_lora, h, m.qk_nope + m.v_head)
    q_offset, valid = 0, None
    if cache is None:
        latent_all, k_pe_all = latent, k_pe
    else:
        buf = cache[MLA_CACHE]
        cap = buf.shape[1]
        if s > cap or (start is not None and not 0 <= start <= cap - s):
            at = "" if start is None else f" at position {start}"
            raise ValueError(f"mla_apply: {s} tokens{at} do not fit a "
                             f"cache of {cap}")
        buf.index_copy_(1, positions, torch.cat([latent, k_pe], -1))
        if start is None:
            q_offset, valid = cache_pos, cache_pos + s
        else:
            q_offset, buf = start, buf[:, :start + s]
        if s == 1:
            out = _mla_absorbed(q_nope, q_pe, buf, wkv_b, m, q_offset=q_offset,
                                kv_valid_len=valid, chunk=cfg.attn_chunk,
                                dtype=x.dtype)
            return dense(p["wo"], out), cache
        latent_all, k_pe_all = buf[..., :m.kv_lora], buf[..., m.kv_lora:]
    k, v = _mla_expand(latent_all, k_pe_all, wkv_b, m, x.dtype)
    out = attention(
        torch.cat([q_nope, q_pe], -1).transpose(1, 2), k, v, causal=True,
        q_offset=q_offset, kv_valid_len=valid, chunk=cfg.attn_chunk)
    out = out.transpose(1, 2).reshape(b, s, h * m.v_head)
    return dense(p["wo"], out), cache


# ------------------------------------------------------------------------ MLP
def mlp_init(gen, d: int, ff: int, dtype, device, gated: bool = True) -> Params:
    p = {"wi": dense_init(gen, d, ff, dtype, device),
         "wo": dense_init(gen, ff, d, dtype, device)}
    if gated:
        p["wg"] = dense_init(gen, d, ff, dtype, device)
    return p


def mlp_apply(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = dense(p["wi"], x)
    if "wg" in p:
        h = ACTS[act](dense(p["wg"], x)) * h
    else:
        h = ACTS[act](h)
    return dense(p["wo"], h)
