"""Mixture of experts of the port (the reference's ``repro/models/moe.py``):
a softmax top-k router with the Switch load-balancing loss, the routed
experts' gated FFN dispatched through capacity buffers (GShard, the
config's default, ``impl="capacity"``) or through grouped products in expert
order (`ragged_dot`, ``impl="ragged"``), and an optional gated shared expert.

Partial sums. With ``parallel`` (`repro_torch.sharding.api.Parallel`) the
routed experts' ff dim is sharded over the tensor-parallel axis: each rank
runs the dispatch and the expert products over its block of ff (wg and wi
column blocks, wo's row block), so its down-projection yields a partial
sum of y, combined across the axis actively (an all-reduce: the sum
happens in the interconnect, the paper's active memory controller) or
passively (an all-gather of every rank's partial into (TP, t, d) and a
local add: the read-back baseline, TP times the bytes). Tokens are split
over the data axes where their count divides, as the reference's
``shard_map`` splits them, and gathered back after the combine, since the
rest of the layer runs replicated on every rank in the port. The router
and the shared expert run replicated. With ``parallel=None`` the same code
runs on one device.

Capture. The capacity path reads no tensor value on the host: its buffer
size depends on the token count alone, the expert counts are a
``scatter_add_`` into E slots (``bincount``'s length would depend on the
data), a dropped row is written to a spare buffer row rather than masked,
and the combine sums each token's k rows in a fixed order rather than with
atomics (``index_add_`` on the card sums in a different order every run).
So a CUDA graph of a step replays it bit for bit. The ragged path reads its
group sizes on the host and runs eagerly only; the compiled steps refuse it
(`check_capturable`) until a grouped GEMM reads group offsets from device
memory (ROADMAP B5).

The expert products are ``torch.bmm`` (capacity) and one ``torch.matmul``
a group (ragged): the reference computes them as XLA einsums and
``jax.lax.ragged_dot``, outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.models import layers as L
from repro_torch.sharding import collectives
from repro_torch.sharding.api import check_parallel

Params = dict[str, Any]


def moe_init(gen, cfg, device) -> Params:
    """The reference's tree: ``router.w`` (d, E) in fp32 whatever the
    config's dtype, ``routed.{wg, wi}`` (E, d, ff) and ``routed.wo``
    (E, ff, d) in the config's dtype, and the gated shared expert with its
    (d, 1) gate where the config has them."""
    mc, d = cfg.moe, cfg.d_model
    dt = L.dtype_of(cfg)
    e, ff = mc.n_routed, mc.expert_ff
    scale = 1.0 / math.sqrt(d)
    p: Params = {
        "router": {"w": L.normal(gen, (d, e), scale, torch.float32, device)},
        "routed": {
            "wg": L.normal(gen, (e, d, ff), scale, dt, device),
            "wi": L.normal(gen, (e, d, ff), scale, dt, device),
            "wo": L.normal(gen, (e, ff, d), 1.0 / math.sqrt(ff), dt, device),
        },
    }
    if mc.n_shared:
        p["shared"] = L.mlp_init(gen, d, mc.shared_ff or ff * mc.n_shared, dt,
                                 device, gated=True)
        if mc.shared_gate:
            p["shared_gate"] = L.dense_init(gen, d, 1, dt, device)
    return p


def check_capturable(cfg) -> None:
    """Raise `ValueError` where a step of ``cfg`` reads a tensor value on
    the host, so that a CUDA graph would bake in stale values: the ragged
    dispatch reads its group sizes."""
    if cfg.moe is not None and cfg.moe.impl != "capacity":
        raise ValueError(
            f"{cfg.name}: MoE impl {cfg.moe.impl!r} reads its group sizes on "
            f"the host and runs eagerly only; a compiled step needs "
            f"impl='capacity' until a grouped GEMM reads them on the device "
            f"(ROADMAP B5)")


def capacity(t: int, mc) -> int:
    """Slots an expert gets for ``t`` tokens: T k cf / E, and at least T k
    for T <= 64 (decode steps never drop). A host integer of T alone."""
    cap = max(1, int((t * mc.top_k * mc.capacity_factor) / mc.n_routed))
    return max(cap, t * mc.top_k) if t <= 64 else cap


def expert_counts(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Rows routed to each of the ``e`` experts: ``bincount(length=e)``
    with a length fixed on the host."""
    return torch.zeros(e, dtype=torch.int64, device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))


def route(w: torch.Tensor, x2: torch.Tensor, mc
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2: (T, d) -> (weights (T, k) fp32, idx (T, k), aux 0-d fp32): the
    fp32 router product, softmax, top-k, the optional renormalisation and
    the Switch loss E * sum_e f_e P_e * router_aux_weight."""
    probs = torch.softmax(x2.float() @ w, -1)                     # (T, E)
    weights, idx = torch.topk(probs, mc.top_k, -1)                # (T, k)
    if mc.norm_topk:
        weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    fe = (expert_counts(idx.reshape(-1), mc.n_routed).float()
          / (x2.shape[0] * mc.top_k))
    aux = mc.n_routed * torch.sum(fe * probs.mean(0)) * mc.router_aux_weight
    return weights, idx, aux


def ragged_dot(x: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor
               ) -> torch.Tensor:
    """``jax.lax.ragged_dot``: x (R, d) in consecutive groups of
    ``group_sizes`` rows (read on the host), group g times w[g] (d, f);
    rows past the last group are 0. Empty groups are allowed."""
    out = x.new_zeros(x.shape[0], w.shape[2])
    start = 0
    for g, n in enumerate(group_sizes.tolist()):
        if n:
            out[start:start + n] = x[start:start + n] @ w[g]
        start += n
    return out


def _grouped_ffn(routed: Params, xs: torch.Tensor, group_sizes: torch.Tensor,
                 act: str) -> torch.Tensor:
    """xs: (T*k, d) in expert order; each expert's gated FFN on its rows."""
    g = ragged_dot(xs, routed["wg"], group_sizes)
    h = ragged_dot(xs, routed["wi"], group_sizes)
    return ragged_dot(L.ACTS[act](g) * h, routed["wo"], group_sizes)


def _expert_products(routed: Params, buf: torch.Tensor, act: str
                     ) -> torch.Tensor:
    """buf: (E, C, d) -> (E, C, d), the gated FFN of each expert on its
    slots: the reference's ``ecd,edf->ecf`` and ``ecf,efd->ecd``."""
    g = torch.bmm(buf, routed["wg"])
    h = torch.bmm(buf, routed["wi"])
    return torch.bmm(L.ACTS[act](g) * h, routed["wo"])


def _dispatch(x: torch.Tensor, idx: torch.Tensor, e: int, cap: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort the T*k routed rows by expert (stable: each expert's rows stay
    in token order) and copy them into a (E * cap, d) buffer, expert i's at
    rows [i cap, i cap + cap). A row past its expert's capacity drops: it
    is written to a spare last row, which is cut off. Returns (buffer,
    order, slot): the sort and each sorted row's buffer row (E * cap where
    it dropped)."""
    t, d = x.shape
    k = idx.shape[1]
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = expert_counts(flat_e, e)
    pos = (torch.arange(t * k, device=x.device)
           - (torch.cumsum(counts, 0) - counts)[sorted_e])        # slot in expert
    slot = torch.where(pos < cap, sorted_e * cap + pos, e * cap)
    buf = x.new_zeros(e * cap + 1, d)
    buf[slot] = x[order // k]
    return buf[:-1], order, slot


def _combine(rows: torch.Tensor, order: torch.Tensor, weights: torch.Tensor
             ) -> torch.Tensor:
    """rows: (T*k, d), the outputs of the routed rows in expert order ->
    (T, d). Each token's k rows go back to token order (a permutation, so
    no two writes meet) and are weighted and summed over k in a fixed
    order."""
    t, k = weights.shape
    back = torch.empty_like(rows).index_copy_(0, order, rows)
    return (back.view(t, k, -1) * weights[..., None]).sum(1)


def _capacity_ffn(routed: Params, mc, x: torch.Tensor, weights: torch.Tensor,
                  idx: torch.Tensor, act: str) -> torch.Tensor:
    """GShard capacity dispatch: per-expert buffers of `capacity` slots,
    batched per-expert products, and the combine; rows past an expert's
    capacity drop (contribute 0)."""
    t, d = x.shape
    e = mc.n_routed
    cap = capacity(t, mc)
    buf, order, slot = _dispatch(x, idx, e, cap)
    out = _expert_products(routed, buf.view(e, cap, d), act).view(e * cap, d)
    rows = torch.where((slot < e * cap)[:, None],
                       out[slot.clamp(max=e * cap - 1)], 0)
    return _combine(rows, order, weights)


def _ragged_ffn(routed: Params, mc, x: torch.Tensor, weights: torch.Tensor,
                idx: torch.Tensor, act: str) -> torch.Tensor:
    """The rows in expert order through `ragged_dot`; no row drops."""
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    out = _grouped_ffn(routed, x[order // mc.top_k],
                       expert_counts(flat_e, mc.n_routed), act)
    return _combine(out, order, weights)


def _tp_block(routed: Params, mc, parallel) -> Params:
    """This rank's block of the routed experts' ff dim: wg and wi (E, d, f)
    by columns, wo (E, f, d) by rows. Weights already cut to the block
    (`repro_torch.sharding.rules.routed_specs`) are taken as they are;
    whole ones are sliced here (a view)."""
    tp, rank = parallel.tp_size, parallel.tp_rank
    ff = mc.expert_ff
    if ff % tp:
        raise ValueError(f"moe_apply: expert ff {ff} does not divide over "
                         f"{tp} tp ranks")
    f_loc = ff // tp
    out = {}
    for name, dim in (("wg", 2), ("wi", 2), ("wo", 1)):
        w = routed[name]
        if w.shape[dim] == ff and tp > 1:
            w = w.narrow(dim, rank * f_loc, f_loc)
        elif w.shape[dim] != f_loc:
            raise ValueError(f"moe_apply: routed {name} {tuple(w.shape)} is "
                             f"neither the whole ff {ff} nor a block of "
                             f"{f_loc}")
        out[name] = w
    return out


def _sharded_ffn(ffn, routed: Params, mc, x: torch.Tensor,
                 weights: torch.Tensor, idx: torch.Tensor, act: str,
                 parallel) -> torch.Tensor:
    """The reference's ``shard_map`` body in explicit SPMD: this rank's
    tokens (its data-axis slice where the count divides, else all of them)
    through ``ffn`` over its ff block, a partial y over the tp axis,
    combined by the parallel's psum_strategy, then the data-axis slices
    gathered back."""
    t, d = x.shape
    dp = parallel.dp_size
    if t % dp:
        # tiny token counts (batch-1 long-context decode) cannot shard over
        # the data axes: replicate the tokens, keep ff tp-sharded
        dp = 1
    t_loc = t // dp
    lo = (parallel.dp_rank if dp > 1 else 0) * t_loc
    y_part = ffn(_tp_block(routed, mc, parallel), mc, x[lo:lo + t_loc],
                 weights[lo:lo + t_loc], idx[lo:lo + t_loc], act)
    if parallel.psum_strategy == "active":
        y = collectives.all_reduce(y_part, parallel.tp_group, site="moe")
    else:
        # passive: gather every rank's partial sums and add them here
        y = collectives.all_gather(y_part, parallel.tp_group,
                                   parallel.tp_size, site="moe").sum(0)
    if dp > 1:
        y = collectives.all_gather(y, parallel.dp_group, dp,
                                   site="moe/data").reshape(t, d)
    return y


def moe_apply(p: Params, x: torch.Tensor, cfg, parallel=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss 0-d fp32). The routing
    weights are cast to x's dtype after normalisation; the shared expert's
    sigmoid gate is computed in fp32. With ``parallel`` the routed experts
    run over this rank's ff block and their partial sums are combined
    across the tp axis (module docstring); anything but a `Parallel` raises
    a TypeError."""
    if parallel is not None:
        check_parallel(parallel, "moe_apply")
    mc = cfg.moe
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    weights, idx, aux = route(p["router"]["w"], x2, mc)
    weights = weights.to(x.dtype)
    ffn = _capacity_ffn if mc.impl == "capacity" else _ragged_ffn
    if parallel is None:
        y2 = ffn(p["routed"], mc, x2, weights, idx, cfg.act)
    else:
        y2 = _sharded_ffn(ffn, p["routed"], mc, x2, weights, idx, cfg.act,
                          parallel)
    if mc.n_shared:
        sh = L.mlp_apply(p["shared"], x2, cfg.act)
        if "shared_gate" in p:
            sh = sh * torch.sigmoid((x2 @ p["shared_gate"]["w"]).float()).to(sh.dtype)
        y2 = y2 + sh
    return y2.reshape(b, s, d), aux
