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

On an H100 the budget is one thread block's shared memory (`SMEM_BUDGET`).
"""

from __future__ import annotations

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
    """On-chip bytes one block holds: the A/B blocks in the operand type
    (twice when double-buffered) plus the accumulator tile, over candidate
    arrays."""
    bm = np.asarray(bm, np.int64)
    bn = np.asarray(bn, np.int64)
    bk = np.asarray(bk, np.int64)
    buffers = 2 if double_buffer else 1
    return (nbytes(buffers * (bm * bk + bk * bn), wl.in_dtype.itemsize)
            + nbytes(bm * bn, wl.acc_dtype.itemsize))


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
