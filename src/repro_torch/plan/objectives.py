"""`Objective`: registrable cost functions over candidate grids.

An objective maps ``(workload, Candidates, controller) -> float64 cost
array``, one cost per candidate, computed with array code so an exact
search is a single masked argmin. Register custom objectives with
``@register_objective("name")``; they drive ``plan()`` (through a
``dse.register_strategy`` preset) and ``dse.sweep(objective=...)``.

Built-ins:

  interconnect_words  the paper's BW (eqs 2+3 for convs, the blocked-GEMM
                      A/B/C word traffic for matmuls): the default, and the
                      objective every built-in search Strategy minimizes
  sram_accesses       accesses at the memory that owns the accumulator,
                      as `plan.traffic` counts them
  energy_bytes        energy-weighted bytes (pJ): an interconnect byte costs
                      8x an SRAM byte (the shared table of
                      `repro_torch.roofline.constants`), so this trades bus
                      words against local accesses
  roofline_latency    max(compute, memory) seconds at the H100's dense bf16
                      peak and HBM rate (`repro_torch.roofline.constants`):
                      latency, not traffic, as the target

All use ceil iteration counts (the executable semantics). The simulator's
``sim_latency`` and ``sim_energy`` register themselves when
`repro_torch.sim` is imported, which `get_objective` does for a ``sim_*``
name.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np

from repro_torch.plan import conv_model, gemm_model
from repro_torch.plan.schedule import Controller
from repro_torch.plan.space import Candidates
from repro_torch.plan.units import nbytes
from repro_torch.plan.workload import ConvWorkload, MatmulWorkload, Workload
from repro_torch.roofline.constants import (HBM_BW, PEAK_FLOPS_BF16,
                                            PJ_INTERCONNECT_BYTE, PJ_SRAM_BYTE)

ObjectiveFn = Callable[[Workload, Candidates, Controller], np.ndarray]
Objective = Union[str, ObjectiveFn]

OBJECTIVES: dict[str, ObjectiveFn] = {}


def register_objective(name: str) -> Callable[[ObjectiveFn], ObjectiveFn]:
    """Register a vectorized cost function under ``name``."""
    def deco(fn: ObjectiveFn) -> ObjectiveFn:
        if name in OBJECTIVES:
            raise ValueError(f"objective {name!r} already registered")
        OBJECTIVES[name] = fn
        return fn
    return deco


def get_objective(objective: Objective) -> ObjectiveFn:
    if callable(objective):
        return objective
    if isinstance(objective, str) and objective.startswith("sim_") \
            and objective not in OBJECTIVES:
        import repro_torch.sim  # noqa: F401  (registers sim_latency / sim_energy)
    if objective in OBJECTIVES:
        return OBJECTIVES[objective]
    raise KeyError(f"unknown objective {objective!r}; "
                   f"registered: {sorted(OBJECTIVES)}")


def _kind_error(fn_name: str, wl) -> TypeError:
    return TypeError(f"objective {fn_name} got unsupported workload "
                     f"{type(wl).__name__}")


@register_objective("interconnect_words")
def interconnect_words(wl: Workload, cands: Candidates,
                       controller: Controller) -> np.ndarray:
    """Words crossing the interconnect / device memory: the paper's BW."""
    if isinstance(wl, ConvWorkload):
        b_i, b_o = conv_model.conv_bandwidth_grid(
            wl, cands.bm, cands.bn, controller, exact_iters=True)
        return b_i + b_o
    if isinstance(wl, MatmulWorkload):
        return gemm_model.matmul_traffic_grid(
            wl.m, wl.n, wl.k, cands.bm, cands.bn, cands.bk,
            controller)["total"]
    raise _kind_error("interconnect_words", wl)


def _conv_sram(wl: ConvWorkload, cands: Candidates, controller: Controller
               ) -> tuple[np.ndarray, np.ndarray]:
    """(reads, writes) at the accumulator SRAM, `plan.traffic`'s count
    vectorized. The same for both controllers: the active controller moves
    work off the bus, it does not remove it."""
    b_i, _ = conv_model.conv_bandwidth_grid(
        wl, cands.bm, cands.bn, controller, exact_iters=True)
    mg = wl.cin // wl.groups
    m_eff = np.minimum(np.asarray(cands.bm, np.int64), mg)
    in_iters = -(-mg // m_eff)
    out_acts = wl.out_acts
    reads = b_i + (in_iters - 1) * out_acts
    writes = (in_iters * out_acts).astype(np.float64)
    return reads, writes


def _matmul_sram(wl: MatmulWorkload, cands: Candidates
                 ) -> tuple[np.ndarray, np.ndarray]:
    gk = -(-wl.k // np.asarray(cands.bk, np.int64))
    acc = wl.m * wl.n
    return (((gk - 1) * acc).astype(np.float64),
            (gk * acc).astype(np.float64))


@register_objective("sram_accesses")
def sram_accesses(wl: Workload, cands: Candidates,
                  controller: Controller) -> np.ndarray:
    """Total accumulator-memory accesses (reads + writes)."""
    if isinstance(wl, ConvWorkload):
        reads, writes = _conv_sram(wl, cands, controller)
        return reads + writes
    if isinstance(wl, MatmulWorkload):
        reads, writes = _matmul_sram(wl, cands)
        return reads + writes
    raise _kind_error("sram_accesses", wl)


@register_objective("energy_bytes")
def energy_bytes(wl: Workload, cands: Candidates,
                 controller: Controller) -> np.ndarray:
    """Energy-weighted bytes (pJ): interconnect bytes at 8x the cost of SRAM
    bytes. Unlike a word count this charges the passive controller's
    read-back twice (once on the bus, once in SRAM)."""
    if isinstance(wl, ConvWorkload):
        ic_bytes = nbytes(interconnect_words(wl, cands, controller),
                          wl.word_bytes)
        reads, writes = _conv_sram(wl, cands, controller)
        sram_bytes = nbytes(reads + writes, wl.word_bytes)
    elif isinstance(wl, MatmulWorkload):
        ic_bytes = gemm_model.traffic_model_bytes_grid(
            wl.m, wl.n, wl.k, cands.bm, cands.bn, cands.bk, controller,
            in_bytes=wl.in_dtype.itemsize, out_bytes=wl.out_dtype.itemsize,
            acc_bytes=wl.acc_dtype.itemsize)
        reads, writes = _matmul_sram(wl, cands)
        sram_bytes = nbytes(reads + writes, wl.acc_dtype.itemsize)
    else:
        raise _kind_error("energy_bytes", wl)
    return (ic_bytes * PJ_INTERCONNECT_BYTE + sram_bytes * PJ_SRAM_BYTE)


@register_objective("roofline_latency")
def roofline_latency(wl: Workload, cands: Candidates,
                     controller: Controller) -> np.ndarray:
    """max(compute, memory) seconds on the H100's roofline
    (`repro_torch.roofline.constants`). Compute time does not depend on the
    schedule, so this objective is flat wherever the workload is
    compute-bound and minimizes bytes where it is bandwidth-bound."""
    if isinstance(wl, ConvWorkload):
        flops = 2.0 * wl.macs
        moved = nbytes(interconnect_words(wl, cands, controller),
                       wl.word_bytes)
    elif isinstance(wl, MatmulWorkload):
        flops = float(wl.flops)
        moved = gemm_model.traffic_model_bytes_grid(
            wl.m, wl.n, wl.k, cands.bm, cands.bn, cands.bk, controller,
            in_bytes=wl.in_dtype.itemsize, out_bytes=wl.out_dtype.itemsize,
            acc_bytes=wl.acc_dtype.itemsize)
    else:
        raise _kind_error("roofline_latency", wl)
    return np.maximum(flops / PEAK_FLOPS_BF16, moved / HBM_BW)
