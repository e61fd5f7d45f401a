"""`SearchSpace`: first-class candidate grids for design-space exploration.

A space maps ``(workload, budget) -> Candidates``, a struct-of-arrays view of
every schedule the search may pick (conv (m, n) channel partitions or GEMM
(bm, bn, bk) blocks), so constraints and objectives score the whole grid
with array code instead of a Python loop per candidate.

Built-in spaces:

  ConvExactSpace    every integer m with the greedy eq-(5) n: the exact
                    search's candidate set, in its iteration order
  ConvGridSpace     the full (m, n) integer rectangle (pair with a
                    `dse.MacBudget` constraint; for custom objectives whose
                    optimum is off the greedy-n curve)
  AlignedBlockSpace aligned (bm, bn, bk) GEMM blocks (pair with
                    `dse.VmemBudget`)
  ClosedFormSpace   a single candidate from a closed-form rule (eq 7 and the
                    paper's baselines become one-point spaces, which is how
                    every non-search Strategy is expressed as a preset)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Protocol, runtime_checkable

import numpy as np

from repro_torch.plan import conv_model, gemm_model
from repro_torch.plan.schedule import Controller, Schedule
from repro_torch.plan.workload import ConvWorkload, MatmulWorkload, Workload


@dataclasses.dataclass(frozen=True, eq=False)
class Candidates:
    """Struct-of-arrays candidate set: parallel int64 arrays of block sizes.

    ``bm``/``bn`` are the two partitioned-axis block sizes (conv: m input
    maps, n output maps), ``bk`` the GEMM reduction block (all zeros for
    convs), mirroring the `Schedule` field convention.
    """

    kind: str                  # "conv" | "matmul"
    bm: np.ndarray
    bn: np.ndarray
    bk: np.ndarray

    def __len__(self) -> int:
        return int(self.bm.size)

    def schedule_at(self, i: int,
                    controller: Controller = Controller.PASSIVE) -> Schedule:
        return Schedule(kind=self.kind, bm=int(self.bm[i]), bn=int(self.bn[i]),
                        bk=int(self.bk[i]), controller=controller)

    @classmethod
    def single(cls, kind: str, bm: int, bn: int, bk: int = 0) -> "Candidates":
        def one(v):
            return np.asarray([v], dtype=np.int64)
        return cls(kind=kind, bm=one(bm), bn=one(bn), bk=one(bk))


@runtime_checkable
class SearchSpace(Protocol):
    """Anything that enumerates candidates for a budgeted workload."""

    def __call__(self, workload: Workload, budget: int) -> Candidates: ...


@dataclasses.dataclass(frozen=True)
class ConvExactSpace:
    """The exact search's space: m in [1, min(M/g, P/K^2)], n greedy."""

    def __call__(self, wl: ConvWorkload, budget: int) -> Candidates:
        m, n = conv_model.conv_exact_candidates(wl, budget)
        return Candidates(kind="conv", bm=m, bn=n, bk=np.zeros_like(m))

    def fallback(self, wl: ConvWorkload, budget: int) -> Candidates:
        # Budget below one K^2 MAC column (eq 1 unsatisfiable): degrade to
        # (1, 1), the scalar loop's initial best.
        return Candidates.single("conv", 1, 1)


@dataclasses.dataclass(frozen=True)
class ConvGridSpace:
    """The full (m, n) rectangle [1, M/g] x [1, N/g]. Infeasible pairs are
    left in: filter with `dse.MacBudget`."""

    def __call__(self, wl: ConvWorkload, budget: int) -> Candidates:
        g = wl.groups
        mg, ng = wl.cin // g, wl.cout // g
        m, n = np.meshgrid(np.arange(1, mg + 1, dtype=np.int64),
                           np.arange(1, ng + 1, dtype=np.int64), indexing="ij")
        m, n = m.ravel(), n.ravel()
        return Candidates(kind="conv", bm=m, bn=n, bk=np.zeros_like(m))

    def fallback(self, wl: ConvWorkload, budget: int) -> Candidates:
        return Candidates.single("conv", 1, 1)


@dataclasses.dataclass(frozen=True)
class AlignedBlockSpace:
    """Aligned GEMM blocks (powers-of-two multiples of the alignments up to
    ``max_block``), bm-major, then bn, then bk."""

    max_block: int = 4096

    def __call__(self, wl: MatmulWorkload, budget: int) -> Candidates:
        bm, bn, bk = gemm_model.aligned_block_candidates(
            wl.m, wl.n, wl.k, self.max_block)
        return Candidates(kind="matmul", bm=bm, bn=bn, bk=bk)

    def fallback(self, wl: MatmulWorkload, budget: int) -> Candidates:
        # Budget smaller than one minimal tile: take the minimum tile.
        return Candidates.single("matmul", gemm_model.SUBLANE * 16,
                                 gemm_model.LANE, gemm_model.LANE)


@dataclasses.dataclass(frozen=True)
class ClosedFormSpace:
    """One-point space from a closed-form rule ``(workload, budget) ->
    (bm, bn, bk)``: how eq (7) and the paper's baselines join the search."""

    kind: str
    rule: Callable[[Workload, int], tuple[int, int, int]]

    def __call__(self, wl: Workload, budget: int) -> Candidates:
        bm, bn, bk = self.rule(wl, budget)
        return Candidates.single(self.kind, bm, bn, bk)
