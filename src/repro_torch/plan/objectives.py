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

Both use ceil iteration counts (the executable semantics). The reference's
byte-weighted objectives are not here yet: `get_objective` names the
ROADMAP item each waits for (`WAITING`).
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np

from repro_torch.plan import conv_model, gemm_model
from repro_torch.plan.schedule import Controller
from repro_torch.plan.space import Candidates
from repro_torch.plan.workload import ConvWorkload, MatmulWorkload, Workload

ObjectiveFn = Callable[[Workload, Candidates, Controller], np.ndarray]
Objective = Union[str, ObjectiveFn]

OBJECTIVES: dict[str, ObjectiveFn] = {}

#: the reference's objectives this package does not have yet, and what each
#: waits for
WAITING = {
    "energy_bytes": "the byte models (ROADMAP A4)",
    "roofline_latency": "the H100 roofline constants (ROADMAP A10)",
}
_SIM_WAITS_FOR = "the SoC simulator, repro.sim (ROADMAP A10)"


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
    if objective in OBJECTIVES:
        return OBJECTIVES[objective]
    waits = WAITING.get(objective)
    if waits is None and isinstance(objective, str) and objective.startswith("sim_"):
        waits = _SIM_WAITS_FOR
    if waits is not None:
        raise KeyError(f"objective {objective!r} is not ported yet: it waits "
                       f"for {waits}")
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
