"""Blocked matmul with partial-sum accumulation, in two schedules.

* ``active``  — the fp32 accumulator tile stays on chip (registers) for the
  whole K loop and the fused activation epilogue writes C once, in the input
  type: the paper's active memory controller plus its ACT command.
* ``passive`` — every k-step sends the fp32 C tile through device memory
  (read, update, write back), exactly the paper's "partial sums must be read
  before being updated", charged ``(2*gk - 1) * M * N`` words by
  `repro_torch.plan.gemm_model`. The activation runs afterwards.

On a CUDA tensor both run the hand-written kernels in ``csrc/psum_matmul.cu``
(the passive one launches once per k-step); `matmul_launch_plan` picks one of
two bodies from the dtype and the blocks, and the plan names it:

  ``tc_bf16``    bfloat16 with bm, bn <= TILE and bn, bk multiples of 8
                 (TMA copies boxes whose first column and rows lie on 16-byte
                 boundaries): wgmma tensor cores, operands staged by TMA in
                 k-chunks of TC_KC through a ring of TC_STAGES.
  ``cuda_core``  float32, and bfloat16 outside those constraints: the fp32
                 CUDA cores (TF32 would not hold float32's tolerance).

On a CPU tensor they run `matmul_plain`, the same k-block loop in plain
PyTorch, for either body: bf16 products are exact in fp32, so the bodies
differ from it only in the order of the sums.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, launch

ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "none": lambda x: x,
    "relu": torch.relu,
    "silu": F.silu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),  # as jax.nn.gelu
}
ACT_CODES = {"none": 0, "relu": 1, "silu": 2, "gelu": 3}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

TILE = 128        # the kernels' register tile: bm, bn <= TILE
THREADS = 256     # cuda_core: 16 x 16 threads of 8 x 8 outputs
KERNEL_SOURCE = "psum_matmul"
BODY_CODES = {"cuda_core": 0, "tc_bf16": 1}
# tc_bf16: one consumer warpgroup per 64 rows of the block and a producer
# warp; k-chunks of TC_KC (128 bytes of bf16) in a ring of TC_STAGES
TC_KC = 64
TC_STAGES = 3
TMA_ELEMS = 8     # bf16 elements in TMA's 16-byte unit

_C_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


@functools.cache
def _entry_point():
    """The library's C entry point, built and typed once per process."""
    fn = _build.load(KERNEL_SOURCE).psum_matmul_launch
    fn.argtypes, fn.restype = _C_ARGS, ctypes.c_int
    return fn


def tc_tile(bm: int, bn: int) -> tuple[int, int]:
    """The wgmma tile a tc_bf16 block computes for a bm x bn block: 64 rows
    per consumer warpgroup, n64 or n128 (``tc::Cfg<WGS, BN>``)."""
    return (64 if bm <= 64 else 128), (64 if bn <= 64 else 128)


def tc_smem_bytes(bm: int, bn: int) -> int:
    """Shared memory of one tc_bf16 block (``tc::Cfg<WGS, BN>::SMEM``): 1024
    bytes to align to the swizzle pattern, TC_STAGES stages of an X chunk
    (rows x TC_KC) and a W chunk (TC_KC x cols) in bf16, and a full and an
    empty mbarrier per stage."""
    rows, cols = tc_tile(bm, bn)
    return 1024 + TC_STAGES * 2 * TC_KC * (rows + cols) + 16 * TC_STAGES


def matmul_body(*, kp: int, np_: int, bm: int, bn: int, bk: int,
                dtype: torch.dtype | None) -> str:
    """The kernel body a launch takes: tc_bf16 for bfloat16 where its
    constraints hold, cuda_core otherwise. tc_bf16 needs bm, bn <= TILE,
    and TMA needs every box to start on a 16-byte boundary: the rows of x
    (kp) and w (np_), and the first column of each block of w (multiples of
    bn) and of each k-step of x (multiples of bk)."""
    if (dtype == torch.bfloat16 and bm <= TILE and bn <= TILE
            and all(v % TMA_ELEMS == 0 for v in (kp, np_, bn, bk))):
        return "tc_bf16"
    return "cuda_core"


def matmul_plain(xp: torch.Tensor, wp: torch.Tensor, *, bk: int,
                 controller: str = "active", act: str = "none") -> torch.Tensor:
    """The plain version: the same k-block loop over padded operands with an
    fp32 accumulator. Active returns act(C) in the input type; passive
    returns the fp32 partial sums (the caller applies the activation)."""
    acc = torch.zeros(xp.shape[0], wp.shape[1], dtype=torch.float32,
                      device=xp.device)
    for k0 in range(0, xp.shape[1], bk):
        acc += xp[:, k0:k0 + bk].float() @ wp[k0:k0 + bk].float()
    if controller == "passive":
        return acc
    return ACTIVATIONS[act](acc).to(xp.dtype)


def _matmul_cuda(xp: torch.Tensor, wp: torch.Tensor, *, name: str, bm: int,
                 bn: int, bk: int, controller: str, act: str,
                 body: str = "cuda_core",
                 dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch the Hopper kernel: once (active) or once per k-step (passive).
    ``dtype``, where given, is the dtype the launch plan chose its body for:
    operands of another dtype raise, as does an operand the body cannot
    take, before any library is loaded."""
    launch.check_operands(name, xp, wp, dtypes=DTYPE_CODES)
    if dtype is not None and xp.dtype != dtype:
        raise ValueError(f"{name}: the plan chose its body for {dtype}, got "
                         f"{xp.dtype} operands")
    if bm > TILE or bn > TILE:
        raise ValueError(f"{name}: blocks {bm}x{bn} exceed the kernel's "
                         f"{TILE}x{TILE} register tile; plan with the card's "
                         f"shared-memory budget")
    mp, kp = xp.shape
    np_ = wp.shape[1]
    if body == "tc_bf16":
        if xp.dtype != torch.bfloat16:
            raise ValueError(f"{name}: tc_bf16 takes bfloat16, got {xp.dtype}")
        if any(v % TMA_ELEMS for v in (kp, np_, bn, bk)):
            raise ValueError(f"{name}: tc_bf16 needs rows of x ({kp}) and w "
                             f"({np_}) and blocks bn ({bn}) and bk ({bk}) "
                             f"that are multiples of {TMA_ELEMS} elements "
                             f"(16 bytes)")
        if xp.data_ptr() % 16 or wp.data_ptr() % 16:
            raise ValueError(f"{name}: tc_bf16 operands must start on 16-byte "
                             f"boundaries")
    elif body != "cuda_core":
        raise ValueError(f"{name}: unknown body {body!r}")
    fn = _entry_point()
    lib = _build.load(KERNEL_SOURCE)
    passive = controller == "passive"
    out = torch.empty(mp, np_, dtype=torch.float32 if passive else xp.dtype,
                      device=xp.device)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    steps = [(k0, min(k0 + bk, kp)) for k0 in range(0, kp, bk)] if passive \
        else [(0, kp)]
    with torch.cuda.device(xp.device):
        for k_begin, k_end in steps:
            rc = fn(xp.data_ptr(), wp.data_ptr(), out.data_ptr(),
                    DTYPE_CODES[xp.dtype], BODY_CODES[body], int(passive),
                    ACT_CODES[act], mp, np_, kp, bm, bn, k_begin, k_end, stream)
            _build.check(lib, rc, name)
            launch.count_launch(name)
    return out


def matmul_launch_plan(*, m: int, k: int, n: int, bm: int, bn: int, bk: int,
                       controller: str = "active", act: str = "none",
                       dtype: torch.dtype | None = None) -> launch.LaunchPlan:
    """The launch `psum_matmul` executes for one controller, from plain
    integers: shapes padded to block multiples exactly as the entry pads,
    the body picked by `matmul_body` for ``dtype`` (float32 when None). The
    grid is one block per bm x bn output tile for both bodies; the loops
    inside a block are the schedule's k-blocks (cuda_core, active) or the
    k-chunks of TC_KC that the block walks (tc_bf16)."""
    if controller not in ("active", "passive"):
        raise ValueError(f"unknown controller {controller!r}")
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}; known: {sorted(ACTIVATIONS)}")
    mp = m + (-m) % bm
    kp = k + (-k) % bk
    np_ = n + (-n) % bn
    gm, gn, gk = mp // bm, np_ // bn, kp // bk
    name = f"psum_matmul/{controller}"
    passive = controller == "passive"
    body = matmul_body(kp=kp, np_=np_, bm=bm, bn=bn, bk=bk, dtype=dtype)
    scratch = (launch.ScratchPlan("acc", (bm, bn), "registers"),)
    if body == "tc_bf16":
        rows, cols = tc_tile(bm, bn)
        # a warpgroup per 64 rows and the producer warp
        threads, smem = 128 * (rows // 64) + 32, tc_smem_bytes(bm, bn)
        loops = (("k", -(-(bk if passive else kp) // TC_KC)),)
        scratch += (launch.ScratchPlan("x_ring", (TC_STAGES, rows, TC_KC), "shared"),
                    launch.ScratchPlan("w_ring", (TC_STAGES, TC_KC, cols), "shared"))
    else:
        threads, smem = THREADS, 0
        loops = () if passive else (("k", gk),)
    return launch.LaunchPlan(
        name=name,
        grid=(gn, gm),
        threads=threads,
        smem_bytes=smem,
        launches=gk if passive else 1,
        loops=loops,
        inputs=(launch.OperandPlan("x", (mp, kp), (bm, bk)),
                launch.OperandPlan("w", (kp, np_), (bk, bn))),
        outputs=(launch.OperandPlan("out", (mp, np_), (bm, bn)),),
        scratch=scratch,
        cuda=functools.partial(_matmul_cuda, name=name, bm=bm, bn=bn, bk=bk,
                               controller=controller, act=act, body=body,
                               dtype=dtype),
        plain=functools.partial(matmul_plain, bk=bk, controller=controller,
                                act=act),
        body=body,
    )


def _pad_to(x: torch.Tensor, mult0: int, mult1: int) -> torch.Tensor:
    p0 = (-x.shape[0]) % mult0
    p1 = (-x.shape[1]) % mult1
    if p0 or p1:
        x = F.pad(x, (0, p1, 0, p0))
    return x.contiguous()


def psum_matmul(x: torch.Tensor, w: torch.Tensor, *, schedule=None,
                bm: int = 128, bn: int = 128, bk: int = 128, act: str = "none",
                controller: str = "active") -> torch.Tensor:
    """C = act(x @ w) with an explicit partial-sum schedule.

    x: (M, K), w: (K, N), float32 or bfloat16; the result has x's type.
    Shapes are zero-padded to block multiples and the result is sliced back.
    A `repro_torch.plan.Schedule` (kind="matmul") passed as ``schedule=``
    overrides ``bm``/``bn``/``bk`` and ``controller``.
    """
    if schedule is not None:
        if schedule.kind != "matmul":
            raise ValueError(f"psum_matmul needs a matmul schedule, got {schedule}")
        bm, bn, bk = schedule.bm, schedule.bn, schedule.bk
        controller = schedule.controller.value
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {tuple(x.shape)} @ {tuple(w.shape)}")
    plan = matmul_launch_plan(m=m, k=k, n=n, bm=bm, bn=bn, bk=bk,
                              controller=controller, act=act, dtype=x.dtype)
    out = launch.run(plan, _pad_to(x, bm, bk), _pad_to(w, bk, bn))
    if controller == "passive":
        # Passive engines apply the activation after reading the final psums
        # back: an extra device-memory round trip the active schedule fuses.
        out = ACTIVATIONS[act](out).to(x.dtype)
    return out[:m, :n]
