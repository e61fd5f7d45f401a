"""Core layer library of the port, for dense attention and the MLP: dense
projections, norms, rotary embeddings, causal GQA/MQA self-attention with a
KV cache, and gated MLPs.

Functional like the reference (``repro/models/layers.py``): ``*_init(...) ->
params dict`` and ``*_apply(params, x, ...) -> y`` over plain dicts of
tensors. Attention runs through `ops.gqa_flash_attention`: the flash kernel
keeps the running (m, l, acc) partial sums on chip and never materialises
S = QK^T, the schedule the reference's ``chunked_attention`` computes at the
XLA level. MLA, cross-attention and ``chunked_attention`` itself wait for
later slices (ROADMAP A7).
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


# ------------------------------------------------------------------ attention
def attn_init(gen, cfg, device) -> Params:
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
    return p


def init_kv_cache(cfg, batch: int, max_len: int, device) -> Params:
    """Zeroed keys and values, head-major: (B, Hkv, max_len, hd), so that
    the flash kernel reads each kv head's keys as one contiguous block with
    no copy (the reference keeps (B, max_len, Hkv, hd))."""
    shape = (batch, cfg.n_kv_heads, max_len, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}


def attn_apply(p: Params, x: torch.Tensor, cfg, *, positions: torch.Tensor,
               cache: Params | None = None,
               cache_pos: torch.Tensor | None = None,
               start: int | None = None) -> tuple[torch.Tensor, Params | None]:
    """Causal self-attention with an optional KV cache. x: (B, S, d);
    positions: (S,) on x's device.

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
        out = ops.gqa_flash_attention(q, k, v, causal=True)
    else:
        cap = cache["k"].shape[2]
        if s > cap or (start is not None and not 0 <= start <= cap - s):
            at = "" if start is None else f" at position {start}"
            raise ValueError(f"attn_apply: {s} tokens{at} do not fit a "
                             f"cache of {cap}")
        cache["k"].index_copy_(2, positions, k)
        cache["v"].index_copy_(2, positions, v)
        if start is None:
            out = ops.gqa_flash_attention(
                q, cache["k"], cache["v"], causal=True, q_offset=cache_pos,
                kv_valid_len=cache_pos + s)
        else:
            n = start + s
            out = ops.gqa_flash_attention(
                q, cache["k"][:, :, :n], cache["v"][:, :, :n], causal=True,
                q_offset=start)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
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
