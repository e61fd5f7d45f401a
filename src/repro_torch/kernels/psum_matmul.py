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
three bodies from the dtype and the blocks, and the plan names it:

  ``tc_bf16``    bfloat16 with bm, bn <= TILE and bn, bk multiples of 8
                 (TMA copies boxes whose first column and rows lie on 16-byte
                 boundaries): wgmma tensor cores, operands staged by TMA in
                 k-chunks of TC_KC through a ring of TC_STAGES.
  ``tc_3xtf32``  float32 with bm, bn <= TILE and kp, bk multiples of 4: TF32
                 wgmma tensor cores in three passes. One TF32 pass keeps 11
                 significant bits of each operand and misses float32's 1e-3
                 tolerance at the main path's K; a pack pass (one launch a
                 call, counted as ``psum_matmul/pack``) splits each operand
                 into hi + lo (`tf32_split`) and lays W out transposed, and
                 the body sums lo*hi + hi*lo + hi*hi, which holds it.
  ``cuda_core``  bfloat16 and float32 outside those constraints, or asked for
                 by name (``body=`` of `matmul_launch_plan`): the fp32 CUDA
                 cores.

On a CPU tensor they run `matmul_plain`, the same k-block loop in plain
PyTorch, for every body.
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
BODY_CODES = {"cuda_core": 0, "tc_bf16": 1, "tc_3xtf32": 2}
# tc_bf16: one consumer warpgroup per 64 rows of the block and a producer
# warp; k-chunks of TC_KC (128 bytes of bf16) in a ring of TC_STAGES
TC_KC = 64
TC_STAGES = 3
TMA_ELEMS = 8     # bf16 elements in TMA's 16-byte unit
# tc_3xtf32: the same block shape; k-chunks of TF_KC (128 bytes of fp32) of
# four operand boxes (X_hi, X_lo, Wt_hi, Wt_lo) in a ring of TF_STAGES
TF_KC = 32
TF_STAGES = 3
TF_ELEMS = 4      # fp32 elements in TMA's 16-byte unit
TF32_DROP = 13    # low mantissa bits a TF32 operand loses

_C_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


@functools.cache
def _entry_point():
    """The library's C entry point, built and typed once per process."""
    fn = _build.load(KERNEL_SOURCE).psum_matmul_launch
    fn.argtypes, fn.restype = _C_ARGS, ctypes.c_int
    return fn


@functools.cache
def _pack_entry_point():
    """The pack pass's C entry point, built and typed once per process."""
    fn = _build.load(KERNEL_SOURCE).psum_matmul_pack
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _round_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: to nearest at
    the low TF32_DROP bits, ties away from zero (an add on the bits, which
    hold sign and magnitude). A NaN stays NaN."""
    half = 1 << (TF32_DROP - 1)
    bits = (v.view(torch.int32) + half) & -(1 << TF32_DROP)
    return torch.where(torch.isnan(v), v, bits.view(torch.float32))


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The pack pass's split, in plain PyTorch: hi = tf32(x), lo = tf32(x -
    hi), where x - hi is exact in float32 (lo = 0 where hi is infinite).
    For a normal x, |hi + lo - x| <= 2^-22 |x|. Used by the tests and by
    chip_smoke.py to hold the pack pass bit for bit; the CUDA path never
    calls it."""
    hi = _round_tf32(x.float())
    lo = _round_tf32(torch.where(torch.isinf(hi), torch.zeros_like(hi), x - hi))
    return hi, lo


def tf32_pack(xp: torch.Tensor, wp: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """tc_3xtf32's pack pass over padded float32 operands: x (mp, kp) ->
    (2, mp, kp) = X_hi, X_lo; w (kp, np) -> (2, np, kp) = Wt_hi, Wt_lo, W
    transposed. A CUDA tensor runs the pass's kernel (one launch, counted as
    ``psum_matmul/pack``); a CPU tensor its plain version, `tf32_split`."""
    mp, kp = xp.shape
    np_ = wp.shape[1]
    if xp.device.type == "cpu":
        return torch.stack(tf32_split(xp)), torch.stack(tf32_split(wp.t()))
    name = "psum_matmul/pack"
    launch.check_operands(name, xp, wp, dtypes=(torch.float32,))
    if kp % TF_ELEMS or xp.data_ptr() % 16:
        raise ValueError(f"{name}: needs rows of x of a multiple of "
                         f"{TF_ELEMS} elements ({kp}) starting on 16-byte "
                         f"boundaries")
    fn = _pack_entry_point()
    xs = torch.empty(2, mp, kp, dtype=torch.float32, device=xp.device)
    wts = torch.empty(2, np_, kp, dtype=torch.float32, device=xp.device)
    with torch.cuda.device(xp.device):
        rc = fn(xp.data_ptr(), wp.data_ptr(), xs.data_ptr(), wts.data_ptr(),
                mp, np_, kp, torch.cuda.current_stream(xp.device).cuda_stream)
        _build.check(_build.load(KERNEL_SOURCE), rc, name)
        launch.count_launch(name)
    return xs, wts


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


def tf_smem_bytes(bm: int, bn: int) -> int:
    """Shared memory of one tc_3xtf32 block (``tf::Cfg<WGS, BN>::SMEM``):
    1024 bytes to align to the swizzle pattern, TF_STAGES stages of an X_hi
    and an X_lo chunk (rows x TF_KC) and a Wt_hi and a Wt_lo chunk (cols x
    TF_KC) in fp32, and a full and an empty mbarrier per stage."""
    rows, cols = tc_tile(bm, bn)
    return 1024 + TF_STAGES * 2 * 4 * TF_KC * (rows + cols) + 16 * TF_STAGES


def matmul_body(*, kp: int, np_: int, bm: int, bn: int, bk: int,
                dtype: torch.dtype | None) -> str:
    """The kernel body a launch takes: tc_bf16 for bfloat16 and tc_3xtf32
    for float32 (the default) where their constraints hold, cuda_core
    otherwise. Both need bm, bn <= TILE, and TMA needs every box to start
    on a 16-byte boundary. tc_bf16 reads x and w as they are: the rows of x
    (kp) and w (np_), and the first column of each block of w (multiples of
    bn) and of each k-step of x (multiples of bk). tc_3xtf32 reads the
    pack's X and Wt, both with rows of kp: the rows and each k-step's first
    column (multiples of bk)."""
    if bm > TILE or bn > TILE:
        return "cuda_core"
    if (dtype == torch.bfloat16
            and all(v % TMA_ELEMS == 0 for v in (kp, np_, bn, bk))):
        return "tc_bf16"
    if (dtype in (None, torch.float32)
            and all(v % TF_ELEMS == 0 for v in (kp, bk))):
        return "tc_3xtf32"
    return "cuda_core"


def matmul_plain(xp: torch.Tensor, wp: torch.Tensor, *, bk: int,
                 controller: str = "active", act: str = "none") -> torch.Tensor:
    """The plain version: the same k-block loop over padded operands with an
    fp32 accumulator. Active returns act(C) in the input type; passive
    returns the fp32 partial sums (the caller applies the activation).
    tc_bf16 and cuda_core differ from it only in the order of the sums (bf16
    products are exact in fp32). tc_3xtf32 also drops lo*lo and what the
    split leaves, 2^-22 of each operand (about 1e-5 at K = 1536 and unit
    normal operands), and its tensor cores' sums truncate until they are
    folded into fp32 every 128 of k: 2.3e-4 from this version at the main
    GEMM on an H100, where SGEMM is 3.7e-4 from it."""
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
    if body == "tc_3xtf32":
        if xp.dtype != torch.float32:
            raise ValueError(f"{name}: tc_3xtf32 takes float32, got {xp.dtype}")
        if kp % TF_ELEMS or bk % TF_ELEMS:
            raise ValueError(f"{name}: tc_3xtf32 needs rows of x ({kp}) and "
                             f"a block bk ({bk}) that are multiples of "
                             f"{TF_ELEMS} elements (16 bytes)")
        if xp.data_ptr() % 16:
            raise ValueError(f"{name}: tc_3xtf32 operands must start on "
                             f"16-byte boundaries")
    elif body == "tc_bf16":
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
    a, b = xp, wp
    if body == "tc_3xtf32":
        a, b = tf32_pack(xp, wp)            # once, before every k-step
    passive = controller == "passive"
    out = torch.empty(mp, np_, dtype=torch.float32 if passive else xp.dtype,
                      device=xp.device)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    steps = [(k0, min(k0 + bk, kp)) for k0 in range(0, kp, bk)] if passive \
        else [(0, kp)]
    with torch.cuda.device(xp.device):
        for k_begin, k_end in steps:
            rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                    DTYPE_CODES[xp.dtype], BODY_CODES[body], int(passive),
                    ACT_CODES[act], mp, np_, kp, bm, bn, k_begin, k_end, stream)
            _build.check(lib, rc, name)
            launch.count_launch(name)
    return out


def matmul_launch_plan(*, m: int, k: int, n: int, bm: int, bn: int, bk: int,
                       controller: str = "active", act: str = "none",
                       dtype: torch.dtype | None = None,
                       body: str | None = None) -> launch.LaunchPlan:
    """The launch `psum_matmul` executes for one controller, from plain
    integers: shapes padded to block multiples exactly as the entry pads,
    the body picked by `matmul_body` for ``dtype`` (float32 when None), or
    ``body`` where given: cuda_core, or the body `matmul_body` picks (any
    other raises). The grid is one block per bm x bn output tile for every
    body; the loops inside a block are the schedule's k-blocks (cuda_core,
    active) or the k-chunks of TC_KC (tc_bf16) or TF_KC (tc_3xtf32) that
    the block walks. tc_3xtf32 adds its pack pass: one launch more a call,
    and four device arrays."""
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
    chosen = matmul_body(kp=kp, np_=np_, bm=bm, bn=bn, bk=bk, dtype=dtype)
    if body is None:
        body = chosen
    elif body not in ("cuda_core", chosen):
        raise ValueError(f"{name}: body {body!r} does not take this launch; "
                         f"it takes cuda_core or {chosen}")
    scratch = (launch.ScratchPlan("acc", (bm, bn), "registers"),)
    packs = 0
    if body in ("tc_bf16", "tc_3xtf32"):
        rows, cols = tc_tile(bm, bn)
        # a warpgroup per 64 rows and the producer warp
        threads = 128 * (rows // 64) + 32
    if body == "tc_bf16":
        smem = tc_smem_bytes(bm, bn)
        loops = (("k", -(-(bk if passive else kp) // TC_KC)),)
        scratch += (launch.ScratchPlan("x_ring", (TC_STAGES, rows, TC_KC), "shared"),
                    launch.ScratchPlan("w_ring", (TC_STAGES, TC_KC, cols), "shared"))
    elif body == "tc_3xtf32":
        smem, packs = tf_smem_bytes(bm, bn), 1
        loops = (("k", -(-(bk if passive else kp) // TF_KC)),)
        scratch += (launch.ScratchPlan("x_ring", (TF_STAGES, 2, rows, TF_KC), "shared"),
                    launch.ScratchPlan("wt_ring", (TF_STAGES, 2, cols, TF_KC), "shared"),
                    launch.ScratchPlan("x_hi", (mp, kp), "device"),
                    launch.ScratchPlan("x_lo", (mp, kp), "device"),
                    launch.ScratchPlan("wt_hi", (np_, kp), "device"),
                    launch.ScratchPlan("wt_lo", (np_, kp), "device"))
    else:
        threads, smem = THREADS, 0
        loops = () if passive else (("k", gk),)
    return launch.LaunchPlan(
        name=name,
        grid=(gn, gm),
        threads=threads,
        smem_bytes=smem,
        launches=(gk if passive else 1) + packs,
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
