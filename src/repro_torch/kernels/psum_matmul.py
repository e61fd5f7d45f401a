"""Blocked matmul with partial-sum accumulation, in two schedules.

* ``active``  — the fp32 accumulator tile stays on chip (registers) for the
  whole K loop and the fused activation epilogue writes C once, in the input
  type: the paper's active memory controller plus its ACT command.
* ``passive`` — every k-step sends the fp32 C tile through device memory
  (read, update, write back), exactly the paper's "partial sums must be read
  before being updated", charged ``(2*gk - 1) * M * N`` words by
  `repro_torch.plan.gemm_model`. The activation runs afterwards.

On a CUDA tensor both run the hand-written kernel in ``csrc/psum_matmul.cu``
(the passive one launches once per k-step); on a CPU tensor they run
`matmul_plain`, the same k-block loop in plain PyTorch.
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

TILE = 128        # the CUDA kernel's register tile: bm, bn <= TILE
THREADS = 256
KERNEL_SOURCE = "psum_matmul"

_C_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


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
                 bn: int, bk: int, controller: str, act: str) -> torch.Tensor:
    """Launch the Hopper kernel: once (active) or once per k-step (passive)."""
    launch.check_operands(name, xp, wp, dtypes=DTYPE_CODES)
    if bm > TILE or bn > TILE:
        raise ValueError(f"{name}: blocks {bm}x{bn} exceed the kernel's "
                         f"{TILE}x{TILE} register tile; plan with the card's "
                         f"shared-memory budget")
    lib = _build.load(KERNEL_SOURCE)
    fn = lib.psum_matmul_launch
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    mp, kp = xp.shape
    np_ = wp.shape[1]
    passive = controller == "passive"
    out = torch.empty(mp, np_, dtype=torch.float32 if passive else xp.dtype,
                      device=xp.device)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    steps = [(k0, min(k0 + bk, kp)) for k0 in range(0, kp, bk)] if passive \
        else [(0, kp)]
    with torch.cuda.device(xp.device):
        for k_begin, k_end in steps:
            rc = fn(xp.data_ptr(), wp.data_ptr(), out.data_ptr(),
                    DTYPE_CODES[xp.dtype], int(passive), ACT_CODES[act],
                    mp, np_, kp, bm, bn, k_begin, k_end, stream)
            _build.check(lib, rc, name)
            launch.count_launch(name)
    return out


def matmul_launch_plan(*, m: int, k: int, n: int, bm: int, bn: int, bk: int,
                       controller: str = "active",
                       act: str = "none") -> launch.LaunchPlan:
    """The launch `psum_matmul` executes for one controller, from plain
    integers: shapes padded to block multiples exactly as the entry pads."""
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
    return launch.LaunchPlan(
        name=name,
        grid=(gn, gm),
        threads=THREADS,
        smem_bytes=0,
        launches=gk if passive else 1,
        loops=() if passive else (("k", gk),),
        inputs=(launch.OperandPlan("x", (mp, kp), (bm, bk)),
                launch.OperandPlan("w", (kp, np_), (bk, bn))),
        outputs=(launch.OperandPlan("out", (mp, np_), (bm, bn)),),
        scratch=(launch.ScratchPlan("acc", (bm, bn), "registers"),),
        cuda=functools.partial(_matmul_cuda, name=name, bm=bm, bn=bn, bk=bk,
                               controller=controller, act=act),
        plain=functools.partial(matmul_plain, bk=bk, controller=controller,
                                act=act),
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
                              controller=controller, act=act)
    out = launch.run(plan, _pad_to(x, bm, bk), _pad_to(w, bk, bn))
    if controller == "passive":
        # Passive engines apply the activation after reading the final psums
        # back: an extra device-memory round trip the active schedule fuses.
        out = ACTIVATIONS[act](out).to(x.dtype)
    return out[:m, :n]
