"""Grid-rate simulation: the epoch-cost model over a whole candidate grid.

``simulate()`` walks one (workload, schedule) pair and builds Python objects
per epoch class (`_Epoch`, `Phase`, `SimReport`): exact, but tens of
microseconds a call, which over a full `ConvExactSpace` grid makes the
``sim_latency``/``sim_energy`` objectives and the netplan beam loop-rate.
This module re-expresses the same arithmetic as closed-form array code over
a `Candidates` grid:

  * every per-candidate quantity (cycles, energy, row hits/misses, bank
    conflicts, exact word totals, peak/avg bandwidth) is one broadcast
    expression, with no per-candidate Python object in the hot path;
  * the epoch classes of the scalar walk become a fixed, small *slot matrix*
    (conv: 2 output-channel splits x {first, bulk-update, remainder-update};
    GEMM: 2 x 2 x {only, first, mid, last} block splits) of shape
    ``(slots, candidates)``, costed in one pass with inactive slots masked to
    zero count;
  * metric columns materialize lazily from the slot matrix, so an objective
    that only reads ``latency_s`` never pays for the energy/row/peak columns;
  * the arithmetic mirrors ``engine._epoch_phase`` / ``engine._dram_cycles``
    operation for operation (same float64 divisions, same ceil points, exact
    integer-valued accumulations), so every metric equals scalar
    ``simulate()`` float for float (`tests/test_torch_sim.py`, both
    controllers, the residency variants);
  * ``spilled_in_words`` may itself be a 1-D array (one entry per residency
    state, e.g. a netplan beam frontier): the slot matrix gains a leading
    states axis and every spill-dependent column comes back as a
    ``(states, candidates)`` matrix. Each row equals the corresponding
    scalar-``spilled`` call because the broadcast performs the same
    elementwise operations.

The array module is numpy by default. ``xp=torch`` with a ``device``
evaluates the same closed form in torch float64 on that device (the card by
default): every quantity is a float64 tensor there, integer-valued ones
included (exact below 2**53), every division is tensor by tensor (torch
divides a tensor by a host scalar on the card as a product with its
reciprocal, which can move the last bit), and every sum is over
integer-valued terms, so its order does not matter. The torch columns equal
the numpy ones; integer columns come back as int64 tensors.
"""

from __future__ import annotations

from functools import cached_property
from typing import Any, Callable

import numpy as np

from repro_torch.plan.schedule import Controller
from repro_torch.plan.space import Candidates
from repro_torch.plan.units import nbytes
from repro_torch.plan.workload import ConvWorkload, MatmulWorkload, Workload
from repro_torch.sim.energy import (ENERGY_PJ_DRAM_BYTE, ENERGY_PJ_DRAM_ROW_ACT,
                                    ENERGY_PJ_INTERCONNECT_BYTE,
                                    ENERGY_PJ_SRAM_BYTE)
from repro_torch.sim.params import DEFAULT_PARAMS, SimParams

__all__ = ["BatchSimResult", "simulate_batch"]

#: a numpy array or a torch tensor: the evaluator is generic over both
Array = Any


class _NumpyOps:
    """The reference's numpy expressions, operation for operation."""

    ceil = staticmethod(np.ceil)
    maximum = staticmethod(np.maximum)
    minimum = staticmethod(np.minimum)
    where = staticmethod(np.where)
    stack = staticmethod(np.stack)
    concatenate = staticmethod(np.concatenate)
    ones_like = staticmethod(np.ones_like)
    zeros_like = staticmethod(np.zeros_like)

    @staticmethod
    def grid(a) -> np.ndarray:
        return np.asarray(a, dtype=np.int64)

    states = grid

    @staticmethod
    def div(a, b):
        return a / b

    @staticmethod
    def f64(a) -> np.ndarray:
        return np.asarray(a, dtype=np.float64)

    @staticmethod
    def i64(a) -> np.ndarray:
        return a.astype(np.int64)

    @staticmethod
    def zeros_i64(n: int) -> np.ndarray:
        return np.zeros(n, dtype=np.int64)

    @staticmethod
    def sum(a, axis: int):
        return a.sum(axis=axis)

    @staticmethod
    def amax(a, axis: int):
        return a.max(axis=axis)


class _TorchOps:
    """The same expressions in torch float64 on one device."""

    def __init__(self, torch, device) -> None:
        self.torch = torch
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"simulate_batch on {self.device}: no CUDA "
                               f"device (torch.cuda.is_available() is False)")
        self.ceil, self.stack = torch.ceil, torch.stack
        self.concatenate = torch.cat
        self.ones_like, self.zeros_like = torch.ones_like, torch.zeros_like

    def _t(self, a):
        """``a`` as a float64 tensor on the device (bool masks stay bool)."""
        torch = self.torch
        if isinstance(a, torch.Tensor):
            return a if a.device == self.device else a.to(self.device)
        if isinstance(a, np.ndarray) and a.dtype == np.bool_:
            return torch.as_tensor(a, device=self.device)
        return torch.as_tensor(np.asarray(a, dtype=np.float64),
                               device=self.device)

    def grid(self, a):
        return self._t(np.asarray(a, dtype=np.int64))

    states = grid

    def div(self, a, b):
        if not isinstance(a, self.torch.Tensor) \
                and not isinstance(b, self.torch.Tensor):
            return a / b
        return self.torch.div(self._t(a), self._t(b))

    def maximum(self, a, b):
        return self.torch.maximum(self._t(a), self._t(b))

    def minimum(self, a, b):
        return self.torch.minimum(self._t(a), self._t(b))

    def where(self, c, a, b):
        return self.torch.where(self._t(c), self._t(a), self._t(b))

    def f64(self, a):
        return self._t(a).to(self.torch.float64)

    def i64(self, a):
        return a.to(self.torch.int64)

    def zeros_i64(self, n: int):
        return self.torch.zeros(n, dtype=self.torch.int64, device=self.device)

    @staticmethod
    def sum(a, axis: int):
        return a.sum(dim=axis)

    @staticmethod
    def amax(a, axis: int):
        return a.amax(dim=axis)


_NUMPY = _NumpyOps()


def _ops(xp: Any, device) -> "_NumpyOps | _TorchOps":
    if xp is np:
        if device is not None:
            raise ValueError("device= is for xp=torch; numpy runs on the host")
        return _NUMPY
    if getattr(xp, "__name__", "") == "torch":
        return _TorchOps(xp, "cuda" if device is None else device)
    raise TypeError(f"simulate_batch takes xp=numpy or xp=torch, got {xp!r}")


def _fetch_side(params: SimParams, fetch_bytes: Array,
                xp: Any) -> tuple[Array, Array, Array]:
    """(fetch cycles, bursts, rows): `engine._dram_cycles` + the bus-in
    bound, elementwise. ``fetch_bytes <= 0`` yields all zeros, as the
    scalar early-out does."""
    d = params.dram
    bursts = xp.ceil(xp.div(fetch_bytes, d.burst_bytes))
    rows = xp.ceil(xp.div(fetch_bytes, d.row_bytes))
    dram_c = bursts * d.t_burst + rows * d.t_row_miss
    bus_in = xp.ceil(xp.div(fetch_bytes, params.bus_bytes_per_cycle))
    return xp.maximum(dram_c, bus_in), bursts, rows


class BatchSimResult:
    """Struct-of-arrays `SimReport`: one entry per candidate schedule.

    Every metric is a parallel array over the `Candidates` grid the batch was
    evaluated on; the scalar ``simulate()`` report for candidate ``i`` holds
    ``metric[i]``. Word totals are exact (the analytical model's integer
    arithmetic); cycles and energy equal the scalar walk's to the last bit
    because both sides perform the same float64 operations.

    Columns are materialized lazily from the internal ``(slots, candidates)``
    epoch matrix and cached, so a latency objective evaluates only the cycle
    chain while a later ``energy_pj`` read on the same result reuses the
    row-activation counts already computed.

    With a vector ``spilled_in_words`` the epoch matrix is
    ``(states, slots, candidates)`` and spill-dependent columns are
    ``(states, candidates)``; spill-independent counters (``bank_conflicts``,
    ``sram_reads``, ``output_words``) stay per-candidate vectors and
    broadcast. Under ``xp=torch`` every column is a tensor on the device.
    """

    def __init__(self, kind: str, controller: Controller, params: SimParams,
                 xp: Any, epochs: dict, totals_fn: Callable[[], dict],
                 fill_row: int) -> None:
        self.kind = kind
        self.controller = controller
        self.params = params
        self._xp = xp
        self._e = epochs          # slot matrices: (slots, candidates)
        self._totals_fn = totals_fn   # lazy exact per-candidate word totals
        # The walk's first epoch lives in this slot row; its fetch time is
        # the `engine._fill_phase` cost (zero when it fetches nothing).
        self._fill_row = fill_row

    @cached_property
    def _totals(self) -> dict:
        return self._totals_fn()

    def __len__(self) -> int:
        return int(self._e["count"].shape[-1])

    # ------------------------------------------------- epoch-matrix pieces
    @cached_property
    def _fetch(self) -> tuple[Array, Array, Array]:
        """(fetch cycles, bursts, rows) of the slot matrix's DMA side."""
        return _fetch_side(self.params, self._e["fetch_bytes"], self._xp)

    @cached_property
    def _phase_cycles(self) -> Array:
        """`engine._epoch_phase` timing over the slot matrix: per-slot
        ``per_epoch * count`` cycles (a zero-count slot is a phase the scalar
        walk does not have)."""
        xp, p, e = self._xp, self.params, self._e
        fetch, _, _ = self._fetch
        compute = xp.ceil(xp.div(e["macs"], p.macs_per_cycle))
        bus_out = xp.ceil(xp.div(e["bus_bytes"], p.bus_bytes_per_cycle))
        wpc = p.sram.words_per_cycle
        sram = xp.ceil(xp.div(e["acc_sram"], wpc))
        if e["engine_sram"] is not None:   # GEMM A/B reads are not metered
            sram = xp.maximum(xp.ceil(xp.div(e["engine_sram"], wpc)), sram)
        proc = xp.maximum(xp.maximum(compute, sram), bus_out)
        if p.dma_double_buffer:
            per_epoch = xp.maximum(fetch, proc)
        else:
            per_epoch = fetch + proc
        return per_epoch * e["count"]

    # ------------------------------------------------------ time / bandwidth
    @cached_property
    def cycles(self) -> Array:
        # axis=-2 is the slot axis for both the (slots, candidates) matrix
        # and the vector-spilled (states, slots, candidates) stack.
        cycles = self._xp.sum(self._phase_cycles, -2)
        if self.params.dma_double_buffer:
            # `engine._fill_phase`: the un-overlapped first fetch of the
            # double-buffered pipeline, time only: its words are already
            # charged to the first epoch (whose fetch bound is the fill
            # cost, and zero when the epoch fetches nothing).
            fill, _, _ = self._fetch
            cycles = cycles + fill[..., self._fill_row, :]
        return cycles

    @property
    def latency_s(self) -> Array:
        return self.cycles * self.params.cycle_s

    @cached_property
    def peak_words_per_cycle(self) -> Array:
        """Max per-phase bus rate. The scalar report divides each phase's
        word total by its cycle total, so this mirrors that quotient."""
        xp, e = self._xp, self._e
        phase_cycles = self._phase_cycles
        phase_words = (e["fetch_words"] + e["bus_words"]) * e["count"]
        safe = xp.where(phase_cycles > 0, phase_cycles, 1.0)
        return xp.amax(xp.where(phase_cycles > 0,
                                xp.div(phase_words, safe), 0.0), -2)

    @property
    def peak_bw_bytes_s(self) -> Array:
        xp = self._xp
        words = xp.where(self.interconnect_words > 0,
                         self.interconnect_words, 1.0)
        word_bytes = xp.where(self.interconnect_words > 0,
                              xp.div(self.interconnect_bytes, words), 0.0)
        return (nbytes(self.peak_words_per_cycle, word_bytes)
                * self.params.clock_ghz * 1e9)

    @property
    def avg_bw_bytes_s(self) -> Array:
        xp = self._xp
        lat = xp.where(self.cycles > 0, self.latency_s, 1.0)
        return xp.where(self.cycles > 0,
                        xp.div(self.interconnect_bytes, lat), 0.0)

    # ------------------------------------------------- second-order counters
    @cached_property
    def row_hits(self) -> Array:
        xp = self._xp
        _, bursts, rows = self._fetch
        return xp.i64(xp.sum((bursts - rows) * self._e["count"], -2))

    @cached_property
    def row_misses(self) -> Array:
        xp = self._xp
        _, _, rows = self._fetch
        return xp.i64(xp.sum(rows * self._e["count"], -2))

    @cached_property
    def bank_conflicts(self) -> Array:
        # Accumulator RMW traffic has no spilled-input dependence, so this
        # column is per-candidate even under a vector spilled_in_words.
        xp, e = self._xp, self._e
        if self.params.sram.ports_per_bank >= 2:
            return xp.zeros_i64(len(self))
        rmw = xp.where(e["first"], 0, e["acc_w"])   # update epochs RMW-pair
        return xp.i64(xp.sum(rmw * e["count"], -2))

    @property
    def row_miss_rate(self) -> Array:
        xp = self._xp
        total = self.row_hits + self.row_misses
        return xp.where(total > 0,
                        xp.div(xp.f64(self.row_misses),
                               xp.f64(xp.where(total > 0, total, 1))), 0.0)

    # ------------------- first-order totals (exact; == the analytical model)
    @cached_property
    def input_words(self) -> Array:
        return self._xp.f64(self._totals["input_words"])

    @cached_property
    def output_words(self) -> Array:
        return self._xp.f64(self._totals["output_words"])

    @cached_property
    def interconnect_words(self) -> Array:
        return self.input_words + self.output_words

    @cached_property
    def sram_reads(self) -> Array:
        return self._xp.f64(self._totals["sram_reads"])

    @cached_property
    def sram_writes(self) -> Array:
        return self._xp.f64(self._totals["sram_writes"])

    @cached_property
    def interconnect_bytes(self) -> Array:
        return self._xp.f64(self._totals["interconnect_bytes"])

    @cached_property
    def dram_words(self) -> Array:
        return self._xp.f64(self._totals["dram_words"])

    @cached_property
    def dram_bytes(self) -> Array:
        return self._xp.f64(self._totals["dram_bytes"])

    # ----------------------------------------------------------------- energy
    @property
    def energy_breakdown(self) -> dict:
        """The four `sim.energy.energy_breakdown` components, as arrays."""
        xp = self._xp
        sram_bytes = xp.f64(self._totals["sram_bytes"])
        return {
            "interconnect": self.interconnect_bytes
            * ENERGY_PJ_INTERCONNECT_BYTE,
            "sram": sram_bytes * ENERGY_PJ_SRAM_BYTE,
            "dram_bytes": self.dram_bytes * ENERGY_PJ_DRAM_BYTE,
            "dram_row_act": xp.f64(self.row_misses) * ENERGY_PJ_DRAM_ROW_ACT,
        }

    @cached_property
    def energy_pj(self) -> Array:
        # sum(dict.values()) order of `SimReport.energy_pj`: left-associated
        # interconnect + sram + dram_bytes + dram_row_act.
        b = self.energy_breakdown
        return (b["interconnect"] + b["sram"] + b["dram_bytes"]
                + b["dram_row_act"])

    # ------------------------------------------------------------------ views
    def metric(self, name: str) -> Array:
        """The per-candidate column for any `SimReport` metric name (e.g.
        ``latency_s``, ``energy_pj``, ``interconnect_words``)."""
        try:
            col = getattr(self, name)
        except AttributeError:
            raise KeyError(f"unknown sim metric {name!r}") from None
        # 1-D = per candidate; 2-D = (states, candidates) under a vector
        # spilled_in_words.
        if not hasattr(col, "ndim") or col.ndim not in (1, 2):
            raise KeyError(f"{name!r} is not a per-candidate metric")
        return col


def _spill_views(spilled: "int | Array") -> "tuple[Any, Any]":
    """(slot-matrix view, totals view) of ``spilled``: a scalar passes
    through; a 1-D states vector is shaped to broadcast against the
    ``(slots, candidates)`` matrix and the ``(candidates,)`` totals."""
    if getattr(spilled, "ndim", 0) == 1:
        return spilled[:, None, None], spilled[:, None]
    return spilled, spilled


def _conv_slots(wl: ConvWorkload, cands: Candidates, active: bool,
                spilled: "int | Array", out_spilled: bool, xp: Any
                ) -> tuple[dict, Callable[[], dict], int]:
    """Vectorized `engine._conv_epochs` + `engine._conv_totals`: the epoch
    slot matrix, the exact totals, and the fill-phase fetch bytes."""
    g = wl.groups
    mg, ng = wl.cin // g, wl.cout // g
    bm = xp.grid(cands.bm)
    bn = xp.grid(cands.bn)
    m_eff = xp.minimum(bm, mg)
    n_eff = xp.minimum(bn, ng)
    sp_slot, sp_total = _spill_views(spilled)
    spill_frac = (xp.div(sp_slot, wl.in_acts) if wl.in_acts
                  else sp_slot * 0.0)
    wb = wl.word_bytes
    hw_in, hw_out = wl.hi * wl.wi, wl.ho * wl.wo
    k2hw = wl.k * wl.k * hw_out

    cc0, c0 = ng // n_eff, n_eff
    c1 = ng % n_eff                       # remainder output split (may be 0)
    p1 = xp.where(c1 > 0, 1, 0)
    mf, m_rem = mg // m_eff, mg % m_eff
    bulk = xp.maximum(mf - 1, 0)
    has_rem = xp.where(m_rem > 0, 1, 0)

    # Slot matrix: {c0, c1} output splits x {first, bulk update, remainder
    # update} input walks, in the scalar enumeration's order. The per-split
    # walk shape is shared, so counts are (walk profile) x (split count).
    walk = xp.stack([xp.ones_like(bulk), bulk, has_rem])
    count = xp.concatenate([walk * (cc0 * g), walk * (p1 * g)])
    s = xp.stack([m_eff, m_eff, m_rem, m_eff, m_eff, m_rem])
    c = xp.stack([c0, c0, c0, c1, c1, c1])
    first = np.asarray([True, False, False, True, False, False])[:, None]

    in_w = s * hw_in
    acc_w = c * hw_out
    acc_w2 = 2 * acc_w
    if not out_spilled:
        psum = xp.zeros_like(acc_w)
    elif active:
        psum = acc_w
    else:
        psum = xp.where(first, acc_w, acc_w2)
    fetch_w = in_w * spill_frac
    epochs = dict(
        count=count, macs=s * c * k2hw,
        fetch_words=fetch_w, fetch_bytes=nbytes(fetch_w, wb),
        bus_words=psum, bus_bytes=nbytes(psum, wb),
        engine_sram=in_w,
        acc_sram=xp.where(first, acc_w, acc_w2),
        first=first, acc_w=acc_w)

    # ---- exact totals: `engine._conv_totals`, elementwise (lazy: a pure
    # time/energy objective never reads them) -------------------------------
    def totals() -> dict:
        out_iters = -(-ng // n_eff)
        in_iters = -(-mg // m_eff)
        writes = in_iters * wl.out_acts
        in_bus = sp_total * out_iters
        if not out_spilled:
            out_bus = xp.zeros_like(writes)
        elif active:
            out_bus = writes
        else:
            out_bus = 2 * writes - wl.out_acts
        sram_reads = wl.in_acts * out_iters + (in_iters - 1) * wl.out_acts
        return dict(
            input_words=in_bus, output_words=out_bus,
            sram_reads=sram_reads, sram_writes=writes, dram_words=in_bus,
            interconnect_bytes=nbytes(in_bus + out_bus, wb),
            dram_bytes=nbytes(in_bus, wb),
            sram_bytes=nbytes(sram_reads + writes, wb))

    # epochs[0] is (c0, m_eff, first): the walk's first epoch, whose fetch
    # bound is the fill-phase cost.
    return epochs, totals, 0


# Canonical GEMM reduction-walk slots: `engine._k_positions` as masks.
_K_SLOTS = ("only", "first", "mid", "last")


def _gemm_slots(wl: MatmulWorkload, cands: Candidates, active: bool,
                spilled: "int | Array", out_spilled: bool, xp: Any
                ) -> tuple[dict, Callable[[], dict], int]:
    """Vectorized `engine._gemm_epochs` + `engine._gemm_totals`."""
    in_size = wl.in_dtype.itemsize
    out_size = wl.out_dtype.itemsize
    acc_size = wl.acc_dtype.itemsize
    bm = xp.grid(cands.bm)
    bn = xp.grid(cands.bn)
    bk = xp.grid(cands.bk)
    sp_slot, sp_total = _spill_views(spilled)
    a_frac = (xp.div(sp_slot, wl.m * wl.k) if wl.m * wl.k
              else sp_slot * 0.0)

    bm_eff = xp.minimum(bm, wl.m)
    bn_eff = xp.minimum(bn, wl.n)
    blk = xp.minimum(bk, wl.k)
    gk_eff = -(-wl.k // blk)
    k_rem = wl.k % blk

    # (size, count) per axis split; the remainder split has count 0 when the
    # axis divides evenly, dropping the scalar walk's missing epoch.
    one = xp.ones_like(blk)
    m_splits = ((bm_eff, wl.m // bm_eff),
                (wl.m % bm_eff, xp.where(wl.m % bm_eff > 0, 1, 0)))
    n_splits = ((bn_eff, wl.n // bn_eff),
                (wl.n % bn_eff, xp.where(wl.n % bn_eff > 0, 1, 0)))
    k_sizes = {"only": wl.k * one, "first": blk, "mid": blk,
               "last": xp.where(k_rem > 0, k_rem, blk)}
    k_counts = {"only": xp.where(gk_eff == 1, 1, 0),
                "first": xp.where(gk_eff > 1, 1, 0),
                "mid": xp.maximum(gk_eff - 2, 0),
                "last": xp.where(gk_eff > 1, 1, 0)}

    # Slot matrix: 2 x 2 x 4 block splits in the scalar triple-loop order.
    rows = [(si, sj, k_sizes[pos], ci * cj * k_counts[pos],
             pos in ("first", "only"), pos in ("last", "only"))
            for si, ci in m_splits for sj, cj in n_splits for pos in _K_SLOTS]
    si = xp.stack([r[0] * one for r in rows])
    sj = xp.stack([r[1] * one for r in rows])
    sk = xp.stack([r[2] for r in rows])
    count = xp.stack([r[3] for r in rows])
    first = np.asarray([r[4] for r in rows])[:, None]
    last = np.asarray([r[5] for r in rows])[:, None]

    acc_w = si * sj
    acc_w2 = 2 * acc_w
    if not out_spilled:
        c_bus = xp.zeros_like(acc_w)
        c_bytes = c_bus
    elif active:
        c_bus = xp.where(last, acc_w, 0)
        c_bytes = nbytes(c_bus, out_size)
    else:
        c_bus = xp.where(first, acc_w, acc_w2)
        c_bytes = nbytes(c_bus, acc_size)
    fetch_w = si * sk * a_frac + sk * sj
    epochs = dict(
        count=count, macs=si * sj * sk,
        fetch_words=fetch_w, fetch_bytes=nbytes(fetch_w, in_size),
        bus_words=c_bus, bus_bytes=c_bytes,
        engine_sram=None,        # A/B block reads are not metered
        acc_sram=xp.where(first, acc_w, acc_w2),
        first=first, acc_w=acc_w)

    # ---- exact totals: `engine._gemm_totals`, elementwise (lazy) -----------
    def totals() -> dict:
        gi = -(-wl.m // bm)
        gj = -(-wl.n // bn)
        gk = -(-wl.k // bk)
        a_bus = sp_total * gj
        b_bus = gi * (wl.k * wl.n)
        acc_words = wl.m * wl.n
        if not out_spilled:
            c_bus_t = xp.zeros_like(gk)
            c_bytes_t = c_bus_t
        elif active:
            c_bus_t = acc_words * xp.ones_like(gk)
            c_bytes_t = nbytes(c_bus_t, out_size)
        else:
            c_bus_t = (2 * gk - 1) * acc_words
            c_bytes_t = nbytes(c_bus_t, acc_size)
        return dict(
            input_words=a_bus + b_bus, output_words=c_bus_t,
            sram_reads=(gk - 1) * acc_words, sram_writes=gk * acc_words,
            dram_words=a_bus + b_bus,
            interconnect_bytes=nbytes(a_bus + b_bus, in_size) + c_bytes_t,
            dram_bytes=nbytes(a_bus + b_bus, in_size),
            sram_bytes=nbytes((gk - 1) * acc_words + gk * acc_words,
                              acc_size))

    # The walk's first epoch is the (first m-split, first n-split) block at
    # the first reduction position; its fetch is sized min(bk, k) whether
    # the walk has one k block or many, which is the "first" slot (row 1):
    # when gk == 1 that row's bytes equal the "only" row's.
    return epochs, totals, 1


def simulate_batch(workload: Workload, cands: Candidates,
                   controller: "Controller | str" = Controller.PASSIVE,
                   params: SimParams | None = None, *,
                   spilled_in_words: "int | Array | None" = None,
                   out_spilled: bool = True,
                   xp: Any = np, device=None) -> BatchSimResult:
    """Simulate every candidate schedule of a grid in one array pass.

    The batched analogue of ``engine.simulate``: ``cands`` supplies the block
    sizes (`Candidates` struct-of-arrays), ``controller`` applies to the whole
    grid, and ``spilled_in_words`` / ``out_spilled`` carry the residency
    convention of `repro_torch.plan.netplan` unchanged. Every returned column
    equals the scalar report's value for that candidate.

    ``spilled_in_words`` may also be a 1-D integer array (one residency state
    per entry): spill-dependent metric columns then come back as
    ``(states, candidates)`` matrices, each row equal to the
    scalar-``spilled`` call for that state.

    ``xp=torch`` evaluates in torch float64 on ``device`` (default
    ``"cuda"``; a CUDA device without a GPU raises `RuntimeError`), and every
    column is a tensor there; ``xp=numpy``, the default, on the host.
    """
    ops = _ops(xp, device)
    params = DEFAULT_PARAMS if params is None else params
    controller = Controller.coerce(controller)
    active = controller is Controller.ACTIVE
    if isinstance(workload, ConvWorkload):
        if cands.kind != "conv":
            raise ValueError(
                f"conv workload needs conv candidates: {cands.kind}")
        wl_in = workload.in_acts
        builder = _conv_slots
    elif isinstance(workload, MatmulWorkload):
        if cands.kind != "matmul":
            raise ValueError(
                f"matmul workload needs matmul candidates: {cands.kind}")
        wl_in = workload.m * workload.k
        builder = _gemm_slots
    else:
        raise TypeError(f"unknown workload type {type(workload).__name__}")
    spilled = wl_in if spilled_in_words is None else spilled_in_words
    if isinstance(spilled, (int, np.integer)):
        if not 0 <= spilled <= wl_in:
            raise ValueError(
                f"spilled_in_words {spilled} outside [0, {wl_in}]")
    else:
        spilled = np.asarray(spilled, dtype=np.int64)
        if spilled.ndim != 1:
            raise ValueError(
                f"vector spilled_in_words must be 1-D, got {spilled.ndim}-D")
        if spilled.size and not (
                (0 <= spilled.min()) and (spilled.max() <= wl_in)):
            raise ValueError(
                f"spilled_in_words entries outside [0, {wl_in}]")
        spilled = ops.states(spilled)

    epochs, totals_fn, fill_row = builder(workload, cands, active, spilled,
                                          out_spilled, ops)
    return BatchSimResult(kind=cands.kind, controller=controller,
                          params=params, xp=ops, epochs=epochs,
                          totals_fn=totals_fn, fill_row=fill_row)
