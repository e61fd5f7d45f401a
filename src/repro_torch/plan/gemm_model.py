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

from repro_torch.plan.schedule import Controller, Schedule, Strategy
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


def working_set_bytes(wl: MatmulWorkload, bm, bn, bk) -> np.ndarray:
    """On-chip bytes one block holds: double-buffered A/B blocks in the
    operand type plus the accumulator tile, over candidate arrays."""
    bm = np.asarray(bm, np.int64)
    bn = np.asarray(bn, np.int64)
    bk = np.asarray(bk, np.int64)
    in_size = wl.in_dtype.itemsize
    acc_size = wl.acc_dtype.itemsize
    return 2 * (bm * bk + bk * bn) * in_size + bm * bn * acc_size


def matmul_traffic_total_grid(m: int, n: int, k: int, bm, bn, bk,
                              controller: Controller) -> np.ndarray:
    """Vectorized `matmul_traffic`'s ``total`` over candidate block arrays
    (exact int64 arithmetic, one final float conversion)."""
    gi = -(-m // bm)
    gj = -(-n // bn)
    gk = -(-k // bk)
    a_reads = gj * (m * k)
    b_reads = gi * (k * n)
    if controller is Controller.ACTIVE:
        c_traffic = np.full_like(a_reads, m * n)
    else:
        c_traffic = (2 * gk - 1) * (m * n)
    return (a_reads + b_reads + c_traffic).astype(np.float64)


def plan_gemm(wl: MatmulWorkload, budget: int, strategy: Strategy,
              controller: Controller, max_block: int = 4096) -> Schedule:
    """Exhaustive search over aligned block shapes for the fewest words under
    the byte budget (``exhaustive_vmem`` / ``exact_opt``): one masked argmin
    whose ties go to the first candidate. A budget below the smallest tile
    takes the smallest tile."""
    strategy = Strategy.coerce(strategy)
    controller = Controller.coerce(controller)
    if strategy not in (Strategy.EXHAUSTIVE_VMEM, Strategy.EXACT_OPT):
        raise ValueError(f"strategy {strategy.value} is not ported for matmuls")
    bm, bn, bk = aligned_block_candidates(wl.m, wl.n, wl.k, max_block)
    fits = working_set_bytes(wl, bm, bn, bk) <= budget
    if not fits.any():
        return Schedule(kind="matmul", bm=SUBLANE * 16, bn=LANE, bk=LANE,
                        controller=controller)
    cost = matmul_traffic_total_grid(wl.m, wl.n, wl.k, bm, bn, bk, controller)
    best = int(np.argmin(np.where(fits, cost, np.inf)))
    return Schedule(kind="matmul", bm=int(bm[best]), bn=int(bn[best]),
                    bk=int(bk[best]), controller=controller)
