"""Mamba-2 of the port (the reference's ``repro/models/ssm.py``): the SSD
(state-space duality) block in its chunked matmul form, and its O(1)
recurrent decode.

The chunked SSD is a partial-sum partitioning in the paper's sense: the
sequence is cut into chunks, each chunk yields a partial state (the
partial sum), and a sequential recurrence carries the accumulator from
chunk to chunk, while the work inside a chunk is dense products. The
reference computes it as XLA einsums, ``cumsum`` and a ``lax.scan`` with no
Pallas kernel; the port computes it in plain PyTorch, the scan a Python loop
over the chunks. Nothing is read on the host, so a CUDA graph captures a
prefill or a decode step.

Types follow the reference's promotions step by step: the projections and
the conv in the config's dtype, ``dt``, ``A`` and the state in fp32, the
in-chunk scores ``C B^T`` in the config's dtype and every product with a
decay in fp32 (`_promoted` casts an einsum's operands as JAX's promotion
does, where ``torch.einsum`` would refuse mixed ones). ``A_log``, ``D``,
``dt_bias`` and the state cache are fp32 whatever the config's dtype.

Heads are grouped consecutively (``jnp.repeat``: `torch.repeat_interleave`).
A layer's cache is ``{"conv": (B, d_conv - 1, conv_dim), "ssm": (B, H, P,
N)}``; `mamba_apply` writes both in place, so a captured step updates the
buffers its graph was captured on.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

Params = dict[str, Any]

#: the keys of a mamba layer's cache; a step advances both
STATE = ("conv", "ssm")


def _dims(cfg) -> tuple[int, int, int]:
    """(d_inner, heads, conv_dim) of a config's SSM."""
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    n_heads = d_inner // sc.head_dim
    conv_dim = d_inner + 2 * sc.n_groups * sc.d_state
    return d_inner, n_heads, conv_dim


def mamba_init(gen, cfg, device) -> Params:
    """The reference's tree: the projections ``wx``, ``wz`` (d, d_inner),
    ``wbc`` (d, 2 G N), ``wdt`` (d, H) and ``wo`` (d_inner, d), the
    depthwise ``conv_w`` (d_conv, conv_dim) and ``conv_b``, the gated
    rmsnorm ``out_norm`` in the config's dtype; ``A_log``, ``D`` and
    ``dt_bias`` (H,) in fp32."""
    sc, d = cfg.ssm, cfg.d_model
    d_inner, h, conv_dim = _dims(cfg)
    dt = L.dtype_of(cfg)
    f32 = torch.float32
    return {
        "wx": L.dense_init(gen, d, d_inner, dt, device),
        "wz": L.dense_init(gen, d, d_inner, dt, device),
        "wbc": L.dense_init(gen, d, 2 * sc.n_groups * sc.d_state, dt, device),
        "wdt": L.dense_init(gen, d, h, dt, device),
        "conv_w": L.normal(gen, (sc.d_conv, conv_dim),
                           1.0 / math.sqrt(sc.d_conv), dt, device),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=f32,
                                          device=device)),
        "D": torch.ones((h,), dtype=f32, device=device),
        "dt_bias": torch.full((h,), math.log(math.e ** 0.01 - 1.0), dtype=f32,
                              device=device),
        "out_norm": L.norm_init(d_inner, dt, device),
        "wo": L.dense_init(gen, d_inner, d, dt, device),
    }


def init_ssm_cache(cfg, batch: int, device) -> Params:
    """Zeroed decode state: the conv window in the config's dtype, the SSM
    state in fp32."""
    sc = cfg.ssm
    _, h, conv_dim = _dims(cfg)
    return {"conv": torch.zeros((batch, sc.d_conv - 1, conv_dim),
                                dtype=L.dtype_of(cfg), device=device),
            "ssm": torch.zeros((batch, h, sc.head_dim, sc.d_state),
                               dtype=torch.float32, device=device)}


def _promoted(*ts: torch.Tensor) -> list[torch.Tensor]:
    """The tensors in their promoted dtype, as ``jnp.einsum`` promotes its
    operands (bf16 with fp32 gives fp32)."""
    dt = functools.reduce(torch.promote_types, (t.dtype for t in ts))
    return [t.to(dt) for t in ts]


# ----------------------------------------------------------------- the parts
def _project_in(p: Params, x: torch.Tensor):
    """x, z, (B, C) and the raw dt (fp32) of the block's input."""
    return (L.dense(p["wx"], x), L.dense(p["wz"], x), L.dense(p["wbc"], x),
            L.dense(p["wdt"], x).float())


def _project_out(p: Params, y: torch.Tensor) -> torch.Tensor:
    return L.dense(p["wo"], y)


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """u: (B, S, C); w: (K, C): the depthwise causal conv as K shifted
    adds, in u's dtype, then silu."""
    kk, s = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, kk - 1, 0))
    y = sum(up[:, i:i + s] * w[i] for i in range(kk))
    return F.silu(y + b)


def _conv_step(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """The conv at one position: window (B, K, C), the state's K - 1 rows
    and the token's, summed over K -> (B, 1, C)."""
    return F.silu((window * w).sum(1) + b)[:, None]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., L) -> (..., L, L) with out[i, j] = sum_{j < t <= i} x[t], and
    -inf for j > i (strictly causal segment sums)."""
    ll = x.shape[-1]
    cs = torch.cumsum(x, -1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((ll, ll), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -math.inf)


def _in_chunk(cr: torch.Tensor, br: torch.Tensor, ar: torch.Tensor,
              xr: torch.Tensor, rep: int) -> torch.Tensor:
    """The output within each chunk: the scores C_i B_j (heads grouped,
    in the operands' dtype) times the decays exp(segsum(a)), against x.
    (B, C, L, H, P)."""
    ll = torch.exp(_segsum(ar))                                  # (B,H,C,L,L)
    cb = torch.einsum("bclgn,bcsgn->bcgls", cr, br)              # (B,C,G,L,L)
    cb = torch.repeat_interleave(cb, rep, dim=2)                 # (B,C,H,L,L)
    att = cb * ll.permute(0, 2, 1, 3, 4)
    return torch.einsum("bchls,bcshp->bclhp", *_promoted(att, xr))


def _chunk_states(br: torch.Tensor, a_cs: torch.Tensor, xr: torch.Tensor,
                  rep: int) -> torch.Tensor:
    """Each chunk's partial state: sum over its positions of B x, decayed
    to the chunk's end. (B, C, H, P, N)."""
    decay = torch.exp(a_cs[..., -1:] - a_cs)                     # (B,H,C,L)
    brh = torch.repeat_interleave(br, rep, dim=3)                # (B,C,L,H,N)
    brh, decay, xr = _promoted(brh, decay, xr)
    return torch.einsum("bclhn,bclhp->bchpn",
                        brh * decay.permute(0, 2, 3, 1)[..., None], xr)


def _chunk_scan(states: torch.Tensor, chunk_decay: torch.Tensor,
                st0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The recurrence across chunks, the accumulator carried from chunk to
    chunk: (the final state, the state entering each chunk (B, C, H, P,
    N))."""
    carry, prevs = st0, []
    for ci in range(states.shape[1]):
        prevs.append(carry)
        carry = carry * chunk_decay[:, :, ci, None, None] + states[:, ci]
    return carry, torch.stack(prevs, 1)


def _off_chunk(cr: torch.Tensor, prev: torch.Tensor, a_cs: torch.Tensor,
               rep: int, dtype: torch.dtype) -> torch.Tensor:
    """The carried state's share of each chunk position: C times the state
    entering the chunk (rounded to ``dtype``, x's), decayed. (B, C, L, H,
    P)."""
    decay = torch.exp(a_cs)                                      # (B,H,C,L)
    crh = torch.repeat_interleave(cr, rep, dim=3)                # (B,C,L,H,N)
    crh, prev, decay = _promoted(crh, prev.to(dtype), decay)
    y = torch.einsum("bclhn,bchpn->bclhp", crh, prev)
    return y * decay.permute(0, 2, 3, 1)[..., None]


def _gated_norm(p: Params, y: torch.Tensor, z: torch.Tensor, eps: float
                ) -> torch.Tensor:
    return L.norm_apply(p["out_norm"], y * F.silu(z), eps)


# ------------------------------------------------------------------ the scan
def ssd_chunked(x: torch.Tensor, a_dt: torch.Tensor, b_mat: torch.Tensor,
                c_mat: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD scan.

    x: (B, S, H, P), already times dt; a_dt: (B, S, H), dt A (negative);
    b_mat, c_mat: (B, S, G, N), H % G == 0. S is zero-padded to a chunk
    multiple: a padded step has x = 0 (no state contribution) and a_dt = 0
    (decay 1), so the final state and the first S outputs are unchanged.
    Returns (y (B, S, H, P) fp32, final state (B, H, P, N) fp32)."""
    bb, s, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    lc = min(chunk, s)
    pad = (-s) % lc
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a_dt = F.pad(a_dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    s_pad = s + pad
    c = s_pad // lc

    xr = x.reshape(bb, c, lc, h, p)
    ar = a_dt.reshape(bb, c, lc, h).permute(0, 3, 1, 2)         # (B,H,C,L)
    br = b_mat.reshape(bb, c, lc, g, n)
    cr = c_mat.reshape(bb, c, lc, g, n)
    a_cs = torch.cumsum(ar, -1)

    y_diag = _in_chunk(cr, br, ar, xr, rep)
    states = _chunk_states(br, a_cs, xr, rep).float()
    st0 = (torch.zeros((bb, h, p, n), dtype=torch.float32, device=x.device)
           if init_state is None else init_state)
    final, prev = _chunk_scan(states, torch.exp(a_cs[..., -1]), st0)
    y_off = _off_chunk(cr, prev, a_cs, rep, xr.dtype)
    y = (y_diag + y_off).reshape(bb, s_pad, h, p)[:, :s]
    return y, final


def mamba_apply(p: Params, x: torch.Tensor, cfg, *,
                cache: Params | None = None) -> tuple[torch.Tensor, Params | None]:
    """x: (B, S, d). Without a cache, or with S > 1 (a prefill), the chunked
    SSD; with a cache the prefill then writes the last d_conv - 1 inputs of
    the conv (zero rows in front where S is shorter) and the final state
    into it. One token with a cache: the recurrent update, reading and
    writing the cache. Returns (out, cache)."""
    sc = cfg.ssm
    bb, s, _ = x.shape
    d_inner, h, _ = _dims(cfg)
    g, n, pdim = sc.n_groups, sc.d_state, sc.head_dim

    xin, z, bc, dt_raw = _project_in(p, x)
    dt = F.softplus(dt_raw + p["dt_bias"])                      # (B,S,H)
    a = -torch.exp(p["A_log"])                                  # (H,)
    u = torch.cat([xin, bc], -1)                                # (B,S,conv_dim)
    if cache is not None and s == 1:
        window = torch.cat([cache["conv"], u], 1)               # (B,K,C)
        conv_out = _conv_step(window, p["conv_w"], p["conv_b"])
        cache["conv"].copy_(window[:, 1:])
    else:
        conv_out = _causal_conv(u, p["conv_w"], p["conv_b"])
    xc = conv_out[..., :d_inner].reshape(bb, s, h, pdim)
    bcc = conv_out[..., d_inner:]
    b_m = bcc[..., :g * n].reshape(bb, s, g, n)
    c_m = bcc[..., g * n:].reshape(bb, s, g, n)
    x_dt = xc.float() * dt[..., None]
    if cache is not None and s == 1:
        y = _recurrent_step(cache["ssm"], x_dt[:, 0], dt[:, 0] * a, b_m[:, 0],
                            c_m[:, 0], h // g)
        y = (y + p["D"][None, :, None] * xc[:, 0].float())[:, None]
    else:
        y, final = ssd_chunked(x_dt.to(x.dtype), dt * a, b_m, c_m, sc.chunk)
        y = y.float() + p["D"][None, None, :, None] * xc.float()
        if cache is not None:
            k = sc.d_conv - 1
            cache["conv"].copy_(F.pad(u, (0, 0, max(0, k - s), 0))[:, -k:])
            cache["ssm"].copy_(final)
    y = y.reshape(bb, s, d_inner).to(x.dtype)
    return _project_out(p, _gated_norm(p, y, z, cfg.norm_eps)), cache


def _recurrent_step(state: torch.Tensor, x_dt: torch.Tensor,
                    a_dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    rep: int) -> torch.Tensor:
    """One token: state = state exp(dt A) + x_dt B^T (fp32, written into
    ``state``), y = state C. x_dt: (B, H, P); a_dt: (B, H); b, c: (B, G,
    N). Returns y (B, H, P) fp32."""
    b_h = torch.repeat_interleave(b, rep, dim=1).float()       # (B,H,N)
    c_h = torch.repeat_interleave(c, rep, dim=1).float()
    st = (state * torch.exp(a_dt)[..., None, None]
          + x_dt[..., :, None] * b_h[..., None, :])
    state.copy_(st)
    return torch.einsum("bhpn,bhn->bhp", st, c_h)
