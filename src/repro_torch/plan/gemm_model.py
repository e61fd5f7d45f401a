"""The paper's traffic model generalized to blocked GEMMs under an on-chip
byte budget.

The objective is the paper's first-order traffic model with the constraint
swapped (eq 1's P MACs -> the bytes one block may hold on chip):

  paper:  K^2 * m * n                                          <= P MACs
  here :  2*(bm*bk + bk*bn)*|in| + bm*bn*|acc|                 <= budget

Traffic in words for C[M,N] = A[M,K] @ B[K,N] with grid (M/bm, N/bn, K/bk):

  A reads:  ceil(N/bn) * M * K          (each A block re-read per N block)
  B reads:  ceil(M/bm) * K * N
  C,active: M * N                        (accumulator resident across k)
  C,passive: (2*ceil(K/bk) - 1) * M * N  (spill + read-back per k step)

The byte models weigh those words by element width: `traffic_model_bytes`
(operands in the input type, passive spills in the accumulator's fp32, the
active final write in the output type) and `MatmulBlocks.vmem_bytes` /
`vmem_bytes_grid` (the working set the budget bounds). Every words -> bytes
product goes through `units.nbytes`.

On an H100 the budget is one thread block's shared memory (`SMEM_BUDGET`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.plan.schedule import Controller, Schedule, Strategy
from repro_torch.plan.units import nbytes
from repro_torch.plan.workload import MatmulWorkload

#: shared memory one H100 thread block may use (NVIDIA Hopper tuning guide)
SMEM_BUDGET = 232_448
LANE = 128      # block sizes are multiples of these two alignments
SUBLANE = 8


@dataclasses.dataclass(frozen=True)
class MatmulBlocks:
    """A GEMM's (bm, bn, bk) blocks without a controller."""

    bm: int
    bn: int
    bk: int

    def vmem_bytes(self, in_bytes: int = 2, acc_bytes: int = 4,
                   double_buffer: bool = True) -> int:
        """The planner's working set: the operand blocks (twice when
        double-buffered) plus the accumulator tile."""
        buffers = 2 if double_buffer else 1
        return (nbytes(buffers * (self.bm * self.bk + self.bk * self.bn), in_bytes)
                + nbytes(self.bm * self.bn, acc_bytes))


def matmul_traffic(m: int, n: int, k: int, blocks, controller="active"
                   ) -> dict[str, float]:
    """Device-memory traffic in *words* for the blocked GEMM. `blocks` is
    anything with bm/bn/bk (a matmul `Schedule`)."""
    controller = Controller.coerce(controller)
    gi = math.ceil(m / blocks.bm)
    gj = math.ceil(n / blocks.bn)
    gk = math.ceil(k / blocks.bk)
    a_reads = gj * m * k
    b_reads = gi * k * n
    if controller is Controller.ACTIVE:
        c_traffic = m * n
    else:
        c_traffic = (2 * gk - 1) * m * n
    return {"a_reads": float(a_reads), "b_reads": float(b_reads),
            "c_traffic": float(c_traffic),
            "total": float(a_reads + b_reads + c_traffic)}


def _aligned_candidates(dim: int, align: int, cap: int) -> list[int]:
    """Aligned block sizes for a dimension: powers-of-two multiples of
    `align`, capped at min(dim rounded up, cap)."""
    top = min(((dim + align - 1) // align) * align, cap)
    cands = []
    c = align
    while c <= top:
        cands.append(c)
        c *= 2
    if top not in cands:
        cands.append(top)
    return sorted(set(cands))


def aligned_block_candidates(m: int, n: int, k: int, max_block: int = 4096
                             ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The exhaustive search's (bm, bn, bk) grid as flat int64 arrays,
    bm-major, then bn, then bk."""
    bm, bn, bk = np.meshgrid(
        np.asarray(_aligned_candidates(m, SUBLANE * 16, max_block), np.int64),
        np.asarray(_aligned_candidates(n, LANE, max_block), np.int64),
        np.asarray(_aligned_candidates(k, LANE, max_block), np.int64),
        indexing="ij")
    return bm.ravel(), bn.ravel(), bk.ravel()


def working_set_bytes(wl: MatmulWorkload, bm, bn, bk,
                      double_buffer: bool = True) -> np.ndarray:
    """`vmem_bytes_grid` at the workload's operand and accumulator types."""
    return vmem_bytes_grid(bm, bn, bk, wl.in_dtype.itemsize,
                           wl.acc_dtype.itemsize, double_buffer)


def vmem_bytes_grid(bm, bn, bk, in_bytes: int = 2, acc_bytes: int = 4,
                    double_buffer: bool = True) -> np.ndarray:
    """Vectorized `MatmulBlocks.vmem_bytes` over candidate arrays."""
    bm = np.asarray(bm, np.int64)
    bn = np.asarray(bn, np.int64)
    bk = np.asarray(bk, np.int64)
    buffers = 2 if double_buffer else 1
    return (nbytes(buffers * (bm * bk + bk * bn), in_bytes)
            + nbytes(bm * bn, acc_bytes))


def matmul_traffic_grid(m: int, n: int, k: int, bm, bn, bk,
                        controller="active") -> dict[str, np.ndarray]:
    """Vectorized `matmul_traffic` over candidate block arrays, entry for
    entry equal to the scalar evaluator (exact int64 arithmetic, one final
    float conversion)."""
    controller = Controller.coerce(controller)
    bm = np.asarray(bm, np.int64)
    bn = np.asarray(bn, np.int64)
    bk = np.asarray(bk, np.int64)
    gi = -(-m // bm)
    gj = -(-n // bn)
    gk = -(-k // bk)
    a_reads = gj * (m * k)
    b_reads = gi * (k * n)
    if controller is Controller.ACTIVE:
        c_traffic = np.full_like(a_reads, m * n)
    else:
        c_traffic = (2 * gk - 1) * (m * n)
    return {"a_reads": a_reads.astype(np.float64),
            "b_reads": b_reads.astype(np.float64),
            "c_traffic": c_traffic.astype(np.float64),
            "total": (a_reads + b_reads + c_traffic).astype(np.float64)}


def traffic_model_bytes_grid(m: int, n: int, k: int, bm, bn, bk, controller,
                             in_bytes: int = 2, out_bytes: int = 2,
                             acc_bytes: int = 4) -> np.ndarray:
    """Vectorized `traffic_model_bytes` over candidate block arrays, entry
    for entry equal to the scalar model."""
    controller = Controller.coerce(controller)
    t = matmul_traffic_grid(m, n, k, bm, bn, bk, controller)
    io = nbytes(t["a_reads"] + t["b_reads"], in_bytes)
    if controller is Controller.ACTIVE:
        return io + float(nbytes(m * n, out_bytes))
    gk = -(-k // np.asarray(bk, np.int64))
    return io + nbytes(((gk - 1) * 2 + 1) * (m * n), acc_bytes)


def traffic_model_bytes(m: int, n: int, k: int, blocks, controller,
                        in_bytes: int = 2, out_bytes: int = 2,
                        acc_bytes: int = 4) -> float:
    """Device-memory traffic in bytes, with separate input, output and
    accumulator widths: passive spills move fp32 partial sums, the active
    final write is the output type (a saving the word model hides)."""
    controller = Controller.coerce(controller)
    t = matmul_traffic(m, n, k, blocks, controller)
    io = nbytes(t["a_reads"] + t["b_reads"], in_bytes)
    if controller is Controller.ACTIVE:
        c = nbytes(m * n, out_bytes)
    else:
        gk = math.ceil(k / blocks.bk)
        c = nbytes(((gk - 1) * 2 + 1) * m * n, acc_bytes)   # spills are fp32
    return io + c


def plan_matmul_blocks_scalar(m: int, n: int, k: int, *,
                              in_dtype: torch.dtype = torch.bfloat16,
                              acc_dtype: torch.dtype = torch.float32,
                              budget: int = SMEM_BUDGET, controller="active",
                              max_block: int = 4096) -> MatmulBlocks:
    """The exhaustive search as a triple Python loop over the aligned
    candidates, bm-major: the parity oracle of the vectorized
    `plan_matmul_blocks` (the same blocks, ties to the first candidate).
    A budget below the smallest tile takes the smallest tile. Do not
    optimise."""
    controller = Controller.coerce(controller)
    best: MatmulBlocks | None = None
    best_t = float("inf")
    for bm in _aligned_candidates(m, SUBLANE * 16, max_block):
        for bn in _aligned_candidates(n, LANE, max_block):
            for bk in _aligned_candidates(k, LANE, max_block):
                b = MatmulBlocks(bm, bn, bk)
                if b.vmem_bytes(in_dtype.itemsize, acc_dtype.itemsize) > budget:
                    continue
                t = matmul_traffic(m, n, k, b, controller)["total"]
                if t < best_t:
                    best, best_t = b, t
    if best is None:
        best = MatmulBlocks(SUBLANE * 16, LANE, LANE)
    return best


def plan_matmul_blocks(m: int, n: int, k: int, *,
                       in_dtype: torch.dtype = torch.bfloat16,
                       acc_dtype: torch.dtype = torch.float32,
                       budget: int = SMEM_BUDGET, controller="active",
                       max_block: int = 4096) -> Schedule:
    """Exact search over aligned block shapes for the fewest words under the
    byte budget, as one masked argmin over the aligned candidate grid
    (`repro_torch.plan.dse`; ties go to the first candidate). A budget
    below the smallest tile takes the smallest tile."""
    from repro_torch.plan import dse, space
    wl = MatmulWorkload(m=m, n=n, k=k, in_dtype=in_dtype, acc_dtype=acc_dtype)
    res = dse.search(wl, budget, space=space.AlignedBlockSpace(max_block),
                     constraints=(dse.VmemBudget(),),
                     objective="interconnect_words",
                     controller=Controller.coerce(controller))
    return res.schedule


def first_order_block(wl: MatmulWorkload, budget: int,
                      max_block: int = 4096) -> tuple[int, int, int]:
    """Closed-form analogue of the paper's eq (7) for a GEMM: with the input
    terms dominating, minimize 1/bm + 1/bn s.t. bk*(bm+bn)*|in| <= budget
    -> bm = bn (the 'square block' rule), bk as large as the leftover
    allows; every block a multiple of `LANE`. Returns (bm, bn, bk)."""
    side = min(int(math.sqrt(budget / nbytes(4, wl.in_dtype.itemsize))),
               max_block)
    bm = max(LANE, (min(side, wl.m) // LANE) * LANE)
    bn = max(LANE, (min(side, wl.n) // LANE) * LANE)
    bk_budget = budget // nbytes(2 * (bm + bn), wl.in_dtype.itemsize)
    bk = max(LANE, (min(bk_budget, wl.k) // LANE) * LANE)
    return bm, bn, bk


def plan_gemm(wl: MatmulWorkload, budget: int, strategy: Strategy,
              controller: Controller, max_block: int = 4096) -> Schedule:
    """Strategy dispatch for GEMM workloads: ``exhaustive_vmem`` /
    ``exact_opt`` run the exact aligned search, ``first_order`` /
    ``paper_opt`` / ``equal`` the closed-form square-block rule. The
    conv-only ``max_input`` / ``max_output`` have no GEMM meaning and raise.
    Every strategy is a `repro_torch.plan.dse` preset."""
    from repro_torch.plan import dse
    return dse.plan_with_strategy(wl, budget, strategy, controller,
                                  max_block=max_block)
