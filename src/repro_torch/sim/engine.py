"""Epoch-driven, cycle-approximate simulation of one scheduled workload.

The simulator walks the same iteration structure the instrumented AMC loop
nest executes (``core.amc`` for convs, the blocked-GEMM
grid of ``plan.gemm_model`` for matmuls), but instead of touching data it
accounts, per iteration **epoch**:

  * the input-block DMA fetch — DRAM channel occupancy with burst and
    open-page (row-buffer) costs, plus interconnect occupancy;
  * the MAC-array compute time at ``params.macs_per_cycle``;
  * the partial-sum update at the controller SRAM — the passive controller
    round-trips the old value over the interconnect, the active controller
    does the read-modify-write locally so only new psums cross the bus;
  * banked-SRAM service time for the engine-side input buffer and the
    controller-side accumulator.

Epochs with identical block shapes and psum behaviour cost the same, so the
walk aggregates them into `Phase` classes (at most a handful per workload)
and the whole simulation is O(classes), not O(iterations) — cheap enough to
run inside a DSE objective over a full candidate grid.

Word-count semantics are **exactly** the analytical model's (ceil iteration
counts, eqs 2-3 + the Section III active-controller variant, the blocked-GEMM
A/B/C traffic): the report's totals are computed with the same integer
arithmetic as `repro_torch.plan.traffic` / ``netplan.network_report`` and are
cross-validated word-for-word by the test suite. The timing layered on top is
approximate by design (see README for what is deliberately not modelled).
"""

from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Sequence

from repro_torch.plan.schedule import Controller, Schedule
from repro_torch.plan.units import nbytes
from repro_torch.plan.workload import ConvWorkload, MatmulWorkload, Workload
from repro_torch.sim.energy import energy_breakdown
from repro_torch.sim.params import DEFAULT_PARAMS, SimParams
from repro_torch.sim.report import Phase, SimReport

if TYPE_CHECKING:
    from repro_torch.faults.models import Fault

__all__ = ["simulate", "epoch_count"]


@dataclasses.dataclass(frozen=True)
class _Epoch:
    """One epoch class: identical iterations aggregated under a count."""

    name: str
    count: int
    compute_macs: int        # MACs issued per epoch
    fetch_words: float       # words DMA'd from DRAM over the bus per epoch
    fetch_bytes: float
    proc_bus_words: int      # psum/output words on the bus during compute
    proc_bus_bytes: float
    engine_sram_words: int   # input-buffer accesses per epoch
    acc_sram_words: int      # accumulator-SRAM accesses per epoch
    rmw_words: int           # read-modify-write pairs (bank-conflict source)


def _dram_cycles(params: SimParams, size: float) -> tuple[float, int, int]:
    """(cycles, bursts, row_activations) to move ``size`` bytes from the DRAM
    channel: bursts at ``t_burst`` each, plus a row activation whenever the
    stream crosses an open-page boundary (and one to open it)."""
    if size <= 0:
        return 0.0, 0, 0
    d = params.dram
    bursts = math.ceil(size / d.burst_bytes)
    rows = math.ceil(size / d.row_bytes)
    return float(bursts * d.t_burst + rows * d.t_row_miss), bursts, rows


def _epoch_phase(params: SimParams, ep: _Epoch, layer: str) -> Phase:
    """Cost one epoch class and expand to a `Phase` (count * per-epoch).

    Bound classification is deterministic with a documented tie-break: a
    degenerate epoch (``per_epoch == 0``, i.e. no work at all) is ``"idle"``;
    otherwise, when the processing side is the bottleneck (``proc >= fetch``,
    fetch winning ties because the overlap hides the equal fetch), the
    tie-break precedence among the processing terms is
    compute > sram > bus; on the fetch side a DRAM-channel time equal to the
    bus-transfer time reads ``"dram"`` (the channel is the scarcer resource).
    """
    dram_c, bursts, rows = _dram_cycles(params, ep.fetch_bytes)
    bus_in = math.ceil(ep.fetch_bytes / params.bus_bytes_per_cycle)
    fetch = max(dram_c, bus_in)

    compute = math.ceil(ep.compute_macs / params.macs_per_cycle)
    bus_out = math.ceil(ep.proc_bus_bytes / params.bus_bytes_per_cycle)
    sram = max(math.ceil(ep.engine_sram_words / params.sram.words_per_cycle),
               math.ceil(ep.acc_sram_words / params.sram.words_per_cycle))
    proc = max(compute, sram, bus_out)

    if params.dma_double_buffer:
        per_epoch = max(fetch, proc)     # prefetch next block during compute
    else:
        per_epoch = fetch + proc

    if per_epoch == 0:
        bound = "idle"
    elif proc >= fetch:
        bound = ("compute" if proc == compute
                 else "sram" if proc == sram else "bus")
    else:
        bound = "dram" if dram_c >= bus_in else "dma"

    conflicts = (ep.rmw_words if params.sram.ports_per_bank < 2 else 0)
    return Phase(
        name=f"{layer}/{ep.name}", count=ep.count,
        cycles=float(per_epoch * ep.count), bound=bound,
        interconnect_words=(ep.fetch_words + ep.proc_bus_words) * ep.count,
        dram_words=ep.fetch_words * ep.count,
        sram_reads=float((ep.engine_sram_words + ep.rmw_words) * ep.count),
        sram_writes=float((ep.acc_sram_words - ep.rmw_words) * ep.count),
        row_hits=(bursts - rows) * ep.count, row_misses=rows * ep.count,
        bank_conflicts=conflicts * ep.count)


def _fill_phase(params: SimParams, first: _Epoch, layer: str) -> Phase | None:
    """The un-overlapped first DMA fetch of a double-buffered pipeline.
    Carries time only — its words are already charged to the first epoch."""
    if not params.dma_double_buffer or first.fetch_bytes <= 0:
        return None
    dram_c, _, rows = _dram_cycles(params, first.fetch_bytes)
    bus_in = math.ceil(first.fetch_bytes / params.bus_bytes_per_cycle)
    return Phase(name=f"{layer}/fill", count=1,
                 cycles=float(max(dram_c, bus_in)),
                 bound="dram" if dram_c >= bus_in else "dma",
                 interconnect_words=0.0, dram_words=0.0,
                 sram_reads=0.0, sram_writes=0.0,
                 row_hits=0, row_misses=0, bank_conflicts=0)


def _dim_splits(total: int, block: int) -> list[tuple[int, int]]:
    """(block size, count) splits of a dimension under ceil tiling."""
    block = min(block, total)
    splits = [(block, total // block)]
    if total % block:
        splits.append((total % block, 1))
    return splits


# ------------------------------------------------------------------ conv walk
def _conv_epochs(wl: ConvWorkload, schedule: Schedule, active: bool,
                 spilled_in_words: int, out_spilled: bool) -> list[_Epoch]:
    g = wl.groups
    mg, ng = wl.cin // g, wl.cout // g
    m_eff, n_eff = min(schedule.m, mg), min(schedule.n, ng)
    spill_frac = spilled_in_words / wl.in_acts if wl.in_acts else 0.0
    wb = wl.word_bytes

    co_splits = _dim_splits(ng, n_eff)
    mf, m_rem = mg // m_eff, mg % m_eff

    def epoch(c: int, s: int, first: bool, count: int) -> _Epoch:
        in_w = s * wl.hi * wl.wi
        acc_w = c * wl.ho * wl.wo
        if not out_spilled:
            psum_bus = 0
        elif first:
            psum_bus = acc_w
        else:
            psum_bus = acc_w if active else 2 * acc_w
        fetch_words = in_w * spill_frac
        return _Epoch(
            name=f"co{c}.ci{s}.{'first' if first else 'update'}",
            count=count,
            compute_macs=s * c * wl.k * wl.k * wl.ho * wl.wo,
            fetch_words=fetch_words, fetch_bytes=nbytes(fetch_words, wb),
            proc_bus_words=psum_bus, proc_bus_bytes=nbytes(psum_bus, wb),
            engine_sram_words=in_w,
            acc_sram_words=acc_w if first else 2 * acc_w,
            rmw_words=0 if first else acc_w)

    epochs: list[_Epoch] = []
    for c, cc in co_splits:
        epochs.append(epoch(c, m_eff, True, cc * g))
        if mf > 1:
            epochs.append(epoch(c, m_eff, False, (mf - 1) * cc * g))
        if m_rem:
            epochs.append(epoch(c, m_rem, False, cc * g))
    return epochs


def _conv_totals(wl: ConvWorkload, schedule: Schedule, active: bool,
                 spilled_in_words: int, out_spilled: bool) -> dict:
    """Exact integer totals — the same arithmetic as ``conv_traffic`` /
    ``netplan._node_bus_report`` (ceil iteration counts)."""
    g = wl.groups
    mg, ng = wl.cin // g, wl.cout // g
    out_iters = math.ceil(ng / min(schedule.n, ng))
    in_iters = math.ceil(mg / min(schedule.m, mg))
    writes = in_iters * wl.out_acts
    in_bus = spilled_in_words * out_iters
    if not out_spilled:
        out_bus = 0
    elif active:
        out_bus = writes
    else:
        out_bus = 2 * writes - wl.out_acts
    return dict(
        input_words=in_bus, output_words=out_bus,
        sram_reads=wl.in_acts * out_iters + (in_iters - 1) * wl.out_acts,
        sram_writes=writes, dram_words=in_bus,
        interconnect_bytes=nbytes(in_bus + out_bus, wl.word_bytes),
        dram_bytes=nbytes(in_bus, wl.word_bytes),
        sram_bytes=nbytes(wl.in_acts * out_iters + (in_iters - 1) * wl.out_acts
                          + writes, wl.word_bytes))


# ------------------------------------------------------------------ gemm walk
def _k_positions(total: int, block: int) -> list[tuple[int, str, int]]:
    """(block size, first/mid/last/only position, count) along the reduction
    walk — psum behaviour depends on the position in the k sequence."""
    block = min(block, total)
    gk = math.ceil(total / block)
    if gk == 1:
        return [(total, "only", 1)]
    k_rem = total % block
    out = [(block, "first", 1)]
    if gk > 2:
        out.append((block, "mid", gk - 2))
    out.append((k_rem if k_rem else block, "last", 1))
    return out


def _gemm_epochs(wl: MatmulWorkload, schedule: Schedule, active: bool,
                 spilled_in_words: int, out_spilled: bool) -> list[_Epoch]:
    a_frac = spilled_in_words / (wl.m * wl.k) if wl.m * wl.k else 0.0
    epochs: list[_Epoch] = []
    for si, ci in _dim_splits(wl.m, schedule.bm):
        for sj, cj in _dim_splits(wl.n, schedule.bn):
            for sk, pos, ck in _k_positions(wl.k, schedule.bk):
                acc_w = si * sj
                first = pos in ("first", "only")
                last = pos in ("last", "only")
                if not out_spilled:
                    c_bus, c_bytes = 0, 0.0
                elif active:
                    c_bus = acc_w if last else 0
                    c_bytes = nbytes(c_bus, wl.out_dtype.itemsize)
                else:
                    c_bus = acc_w if first else 2 * acc_w
                    c_bytes = nbytes(c_bus, wl.acc_dtype.itemsize)
                fetch_words = si * sk * a_frac + sk * sj
                fetch_bytes = nbytes(fetch_words, wl.in_dtype.itemsize)
                epochs.append(_Epoch(
                    name=f"i{si}.j{sj}.k{sk}.{pos}",
                    count=ci * cj * ck,
                    compute_macs=si * sj * sk,
                    fetch_words=fetch_words, fetch_bytes=fetch_bytes,
                    proc_bus_words=c_bus, proc_bus_bytes=c_bytes,
                    engine_sram_words=0,     # A/B block reads are not metered
                    acc_sram_words=acc_w if first else 2 * acc_w,
                    rmw_words=0 if first else acc_w))
    return epochs


def _gemm_totals(wl: MatmulWorkload, schedule: Schedule, active: bool,
                 spilled_in_words: int, out_spilled: bool) -> dict:
    """Exact integer totals — the blocked-GEMM model of ``plan.gemm_model``
    (A-side bus reads scale with the spilled share, B/weight reads always
    stream from DRAM, C per the controller policy)."""
    gi = math.ceil(wl.m / schedule.bm)
    gj = math.ceil(wl.n / schedule.bn)
    gk = math.ceil(wl.k / schedule.bk)
    a_bus = spilled_in_words * gj
    b_bus = gi * wl.k * wl.n
    acc = wl.m * wl.n
    if not out_spilled:
        c_bus, c_bytes = 0, 0
    elif active:
        c_bus, c_bytes = acc, nbytes(acc, wl.out_dtype.itemsize)
    else:
        c_bus = (2 * gk - 1) * acc
        c_bytes = nbytes(c_bus, wl.acc_dtype.itemsize)
    return dict(
        input_words=a_bus + b_bus, output_words=c_bus,
        sram_reads=(gk - 1) * acc, sram_writes=gk * acc,
        dram_words=a_bus + b_bus,
        interconnect_bytes=nbytes(a_bus + b_bus, wl.in_dtype.itemsize) + c_bytes,
        dram_bytes=nbytes(a_bus + b_bus, wl.in_dtype.itemsize),
        sram_bytes=nbytes((gk - 1) * acc + gk * acc, wl.acc_dtype.itemsize))


# ------------------------------------------------------- transient faults
def _params_at(params: SimParams, faults: "Sequence[Fault]", epoch: int,
               n_epochs: int) -> SimParams:
    """``params`` with every fault whose window covers ``epoch`` applied, in
    schedule order. Faults whose sim projection is the identity (plan- or
    serve-level kinds) return ``params`` unchanged, object-identical."""
    for f in faults:
        lo, hi = f.window(n_epochs)
        if lo <= epoch < hi:
            params = f.apply_params(params)
    return params


def _faulted_phases(params: SimParams, faults: "Sequence[Fault]",
                    epochs: "list[_Epoch]", layer: str,
                    n_epochs: int) -> "list[Phase]":
    """The epoch walk with transient fault windows threaded in.

    Each epoch class spans a contiguous range of the global epoch index; the
    range is cut at every fault-window boundary and each segment is costed
    with the `SimParams` in force there. Segments whose params actually
    changed are name-suffixed ``~fault`` so degraded time is attributable in
    the timeline. Per-epoch word/row/conflict columns are unchanged by the
    split (they only multiply by the count), so every word total — and, for
    params-preserving faults, every second-order counter — is invariant.
    """
    bounds = sorted({b for f in faults for b in f.window(n_epochs)})
    out: "list[Phase]" = []
    base = 0
    for ep in epochs:
        lo, hi = base, base + ep.count
        cuts = [lo] + [b for b in bounds if lo < b < hi] + [hi]
        for a, b in zip(cuts, cuts[1:]):
            seg_params = _params_at(params, faults, a, n_epochs)
            phase = _epoch_phase(seg_params,
                                 dataclasses.replace(ep, count=b - a), layer)
            if seg_params is not params:
                phase = dataclasses.replace(phase, name=phase.name + "~fault")
            out.append(phase)
        base = hi
    return out


def epoch_count(workload: Workload, schedule: Schedule) -> int:
    """Total iteration epochs of one (workload, schedule) walk — the unit
    fault windows are expressed in. Independent of residency (spill shares
    scale words per epoch, never the epoch structure)."""
    if isinstance(workload, ConvWorkload):
        epochs = _conv_epochs(workload, schedule, False, workload.in_acts,
                              True)
    elif isinstance(workload, MatmulWorkload):
        epochs = _gemm_epochs(workload, schedule, False,
                              workload.m * workload.k, True)
    else:
        raise TypeError(f"unknown workload type {type(workload).__name__}")
    return sum(ep.count for ep in epochs)


# ------------------------------------------------------------------- simulate
def simulate(workload: Workload, schedule: Schedule,
             params: SimParams | None = None, *,
             spilled_in_words: int | None = None,
             out_spilled: bool = True,
             name: str | None = None, checked: bool = False,
             faults: "Sequence[Fault] | None" = None) -> SimReport:
    """Simulate one (workload, schedule) pair on the modelled SoC.

    ``spilled_in_words`` is the share of the input words that must stream
    from the DRAM channel over the interconnect (defaults to all of them;
    the network simulator passes the non-resident share). ``out_spilled=False``
    keeps the output/psum traffic in the engine-side residency buffer —
    the fused-edge convention of `repro_torch.plan.netplan`.

    ``faults`` injects transient machine faults (`repro_torch.faults.models`): each
    fault's ``[start_epoch, start_epoch + duration_epochs)`` window selects a
    span of the iteration walk to cost under its degraded `SimParams`
    transform. Faults change timing and energy only — the report's word
    totals are computed from the workload/schedule arithmetic before any
    fault is applied and are bit-for-bit the un-faulted totals (the chaos
    harness and test suite pin this).

    Word totals are exact (the analytical model's arithmetic); timing is
    cycle-approximate (see module docstring). ``checked=True`` statically
    verifies the (workload, schedule) pair through `repro_torch.check` first and
    raises `repro_torch.check.CheckError` instead of simulating an infeasible
    schedule.
    """
    if checked:
        from repro_torch.check import verify      # deferred: check imports plan
        verify((workload, schedule),
               context=f"simulate({name or workload!r}) failed verification")
    params = DEFAULT_PARAMS if params is None else params
    active = schedule.controller is Controller.ACTIVE
    if isinstance(workload, ConvWorkload):
        if schedule.kind != "conv":
            raise ValueError(f"conv workload needs a conv schedule: {schedule}")
        spilled = wl_in = workload.in_acts
        if spilled_in_words is not None:
            spilled = spilled_in_words
        if not 0 <= spilled <= wl_in:
            raise ValueError(f"spilled_in_words {spilled} outside [0, {wl_in}]")
        epochs = _conv_epochs(workload, schedule, active, spilled, out_spilled)
        totals = _conv_totals(workload, schedule, active, spilled, out_spilled)
    elif isinstance(workload, MatmulWorkload):
        if schedule.kind != "matmul":
            raise ValueError(
                f"matmul workload needs a matmul schedule: {schedule}")
        spilled = wl_in = workload.m * workload.k
        if spilled_in_words is not None:
            spilled = spilled_in_words
        if not 0 <= spilled <= wl_in:
            raise ValueError(f"spilled_in_words {spilled} outside [0, {wl_in}]")
        epochs = _gemm_epochs(workload, schedule, active, spilled, out_spilled)
        totals = _gemm_totals(workload, schedule, active, spilled, out_spilled)
    else:
        raise TypeError(f"unknown workload type {type(workload).__name__}")

    layer = name if name is not None else getattr(workload, "name", "workload")
    faults = tuple(faults) if faults else ()
    n_epochs = sum(ep.count for ep in epochs)
    phases: list[Phase] = []
    fill = _fill_phase(_params_at(params, faults, 0, n_epochs), epochs[0],
                       layer)
    if fill is not None:
        phases.append(fill)
    if faults:
        phases.extend(_faulted_phases(params, faults, epochs, layer,
                                      n_epochs))
    else:
        phases.extend(_epoch_phase(params, ep, layer) for ep in epochs)

    breakdown = energy_breakdown(
        interconnect_bytes=totals["interconnect_bytes"],
        sram_bytes=totals["sram_bytes"],
        dram_bytes=totals["dram_bytes"],
        row_activations=sum(p.row_misses for p in phases))
    return SimReport(
        name=layer, controller=schedule.controller, params=params,
        phases=tuple(phases),
        interconnect_words=float(totals["input_words"]
                                 + totals["output_words"]),
        input_words=float(totals["input_words"]),
        output_words=float(totals["output_words"]),
        sram_reads=float(totals["sram_reads"]),
        sram_writes=float(totals["sram_writes"]),
        interconnect_bytes=float(totals["interconnect_bytes"]),
        dram_words=float(totals["dram_words"]),
        dram_bytes=float(totals["dram_bytes"]),
        row_hits=sum(p.row_hits for p in phases),
        row_misses=sum(p.row_misses for p in phases),
        bank_conflicts=sum(p.bank_conflicts for p in phases),
        cycles=sum(p.cycles for p in phases),
        energy_breakdown=breakdown)
