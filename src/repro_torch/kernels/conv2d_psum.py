"""Channel-partitioned conv2d: the paper's loop nest with on-chip partial sums.

The paper's accelerator processes m input maps x n output maps per iteration
(eq 1: K^2*m*n <= P). The schedule's (m, n) set the channel blocks; the input
channels (the reduction) are walked block by block in order while the fp32
partial sums of the n-channel output block stay on chip, and the activation
is fused into the final store (the active controller and its ACT command).

On a CUDA tensor this runs the hand-written kernel in ``csrc/conv2d_psum.cu``,
which adds a parallel spatial-tile axis beside the cout-block axis because a
whole map of fp32 accumulators does not fit one block. On a CPU tensor it
runs `conv_plain`, the same cin-block / K x K loop nest in plain PyTorch.

Layout: x (Cin, Hp, Wp) spatially pre-padded, w (Cout, Cin, K, K) (OIHW),
one image, as in the reference package.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, launch
from repro_torch.kernels.psum_matmul import ACT_CODES, ACTIVATIONS, DTYPE_CODES

THREADS = 256              # most threads a block takes
CPT = 4                    # output channels per thread
PPT = 8                    # output positions per thread
SMEM_CAP = 96 * 1024       # dynamic shared memory one block may take
MIN_BLOCKS = 2 * 132       # two blocks per streaming multiprocessor of an H100
KERNEL_SOURCE = "conv2d_psum"
NAME = "conv2d_psum"

_C_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 20 + [ctypes.c_void_p]


def conv_plain(x: torch.Tensor, w: torch.Tensor, *, kk: int, stride: int,
               bm: int, act: str = "none") -> torch.Tensor:
    """The plain version: for each cin block of m channels, in order, a
    K x K unroll of (Cout x m) @ (m x Ho*Wo) products into an fp32
    accumulator, then the activation. All output blocks at once: they are
    independent, so the arithmetic per output is the kernel's."""
    cin_p, hp, wp = x.shape
    ho = (hp - kk) // stride + 1
    wo = (wp - kk) // stride + 1
    acc = torch.zeros(w.shape[0], ho, wo, dtype=torch.float32, device=x.device)
    for c0 in range(0, cin_p, bm):
        xs = x[c0:c0 + bm].float()
        ws = w[:, c0:c0 + bm].float()
        for ky in range(kk):
            for kx in range(kk):
                patch = xs[:, ky:ky + (ho - 1) * stride + 1:stride,
                           kx:kx + (wo - 1) * stride + 1:stride]
                acc += torch.einsum("nm,mhw->nhw", ws[:, :, ky, kx], patch)
    return ACTIVATIONS[act](acc).to(x.dtype)


def tile_geometry(*, hp: int, wp: int, ho: int, wo: int, kk: int, stride: int,
                  bm: int, bn: int, n_co: int) -> dict[str, int]:
    """How the CUDA kernel tiles one cout block: g_c channel groups of CPT
    channels x g_s lanes of PPT positions per block (``threads`` rounds
    g_c * g_s up to whole warps), ``tile`` output positions per block, the
    input rows a tile's slab may span (halo included), and ``mc`` input
    channels staged in shared memory per chunk. Spatial tiles halve until
    the grid has `MIN_BLOCKS` blocks or g_s is down to 8 lanes or fewer."""
    g_c = -(-bn // CPT)
    g_s = max(1, THREADS // g_c)
    while g_s > 8 and -(-ho * wo // (g_s * PPT)) * n_co < MIN_BLOCKS:
        g_s //= 2
    tile = g_s * PPT
    span_rows = min(ho, (tile + wo - 2) // wo + 1)
    rows_in = (span_rows - 1) * stride + kk
    per_channel = rows_in * wp + kk * kk * g_c * CPT
    mc = min(bm, (SMEM_CAP // 4 - 4) // per_channel)
    smem_words = -(-mc * rows_in * wp // 4) * 4 + mc * kk * kk * g_c * CPT
    return {"g_c": g_c, "g_s": g_s, "threads": -(-g_c * g_s // 32) * 32,
            "tile": tile, "rows_in": rows_in, "mc": mc,
            "smem_bytes": 4 * smem_words, "n_tiles": -(-ho * wo // tile)}


def _conv_cuda(x: torch.Tensor, w: torch.Tensor, *, kk: int, stride: int,
               bm: int, bn: int, act: str, geo: dict[str, int]) -> torch.Tensor:
    """Launch the Hopper kernel once over (spatial tiles, cout blocks)."""
    launch.check_operands(NAME, x, w, dtypes=DTYPE_CODES)
    if geo["threads"] > THREADS or geo["mc"] < 1:
        raise ValueError(f"{NAME}: an output block of {bn} channels over a "
                         f"{x.shape[1]}x{x.shape[2]} input does not fit one "
                         f"thread block")
    cin_p, hp, wp = x.shape
    cout_p = w.shape[0]
    ho = (hp - kk) // stride + 1
    wo = (wp - kk) // stride + 1
    lib = _build.load(KERNEL_SOURCE)
    fn = lib.conv2d_psum_launch
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    out = torch.empty(cout_p, ho, wo, dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), DTYPE_CODES[x.dtype],
                cin_p, hp, wp, cout_p, ho, wo, kk, stride, bm, bn,
                geo["g_c"], geo["g_s"], geo["threads"], geo["tile"],
                geo["rows_in"], geo["mc"], geo["smem_bytes"], geo["n_tiles"],
                ACT_CODES[act], stream)
        _build.check(lib, rc, NAME)
        launch.count_launch(NAME)
    return out


def conv_launch_plan(*, cin: int, hp: int, wp: int, cout: int, kk: int,
                     stride: int = 1, block_m: int = 32, block_n: int = 32,
                     act: str = "none") -> launch.LaunchPlan:
    """The launch `conv2d_psum` executes, from plain integers: the same
    clamping and channel padding as the reference's entry point."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}; known: {sorted(ACTIVATIONS)}")
    ho = (hp - kk) // stride + 1
    wo = (wp - kk) // stride + 1
    bm = max(1, min(block_m, cin))
    bn = max(1, min(block_n, cout))
    cin_p = cin + (-cin) % bm
    cout_p = cout + (-cout) % bn
    geo = tile_geometry(hp=hp, wp=wp, ho=ho, wo=wo, kk=kk, stride=stride,
                        bm=bm, bn=bn, n_co=cout_p // bn)
    return launch.LaunchPlan(
        name=NAME,
        grid=(geo["n_tiles"], cout_p // bn),
        threads=geo["threads"],
        smem_bytes=geo["smem_bytes"],
        launches=1,
        loops=(("cin", cin_p // bm), ("chunk", -(-bm // max(1, geo["mc"]))),
               ("tap", kk * kk)),
        inputs=(launch.OperandPlan("x", (cin_p, hp, wp), (bm, hp, wp)),
                launch.OperandPlan("w", (cout_p, cin_p, kk, kk), (bn, bm, kk, kk))),
        outputs=(launch.OperandPlan("out", (cout_p, ho, wo), (bn, ho, wo)),),
        scratch=(launch.ScratchPlan("acc", (bn, geo["tile"]), "registers"),
                 launch.ScratchPlan("slab", (geo["mc"], geo["rows_in"], wp),
                                    "shared"),
                 launch.ScratchPlan("wblock", (bn, geo["mc"], kk, kk), "shared")),
        cuda=functools.partial(_conv_cuda, kk=kk, stride=stride, bm=bm, bn=bn,
                               act=act, geo=geo),
        plain=functools.partial(conv_plain, kk=kk, stride=stride, bm=bm, act=act),
    )


def conv2d_psum(x: torch.Tensor, w: torch.Tensor, *, schedule=None,
                block_m: int = 32, block_n: int = 32, stride: int = 1,
                act: str = "none") -> torch.Tensor:
    """Partitioned conv for a single image: x (Cin, Hp, Wp) already padded,
    w (Cout, Cin, K, K). A `repro_torch.plan.Schedule` (kind="conv") passed
    as ``schedule=`` sets the (m, n) channel blocks (the partial sums always
    stay on chip, i.e. the active controller)."""
    if schedule is not None:
        if schedule.kind != "conv":
            raise ValueError(f"conv2d_psum needs a conv schedule, got {schedule}")
        block_m, block_n = schedule.m, schedule.n
    cin, hp, wp = x.shape
    cout, cin2, kk, _ = w.shape
    if cin != cin2:
        raise ValueError(f"input has {cin} channels, weights expect {cin2}")
    plan = conv_launch_plan(cin=cin, hp=hp, wp=wp, cout=cout, kk=kk,
                            stride=stride, block_m=block_m, block_n=block_n,
                            act=act)
    # pad channels to block multiples (zero channels contribute zero psums)
    cin_p = plan.inputs[0].array_shape[0]
    cout_p = plan.outputs[0].array_shape[0]
    if cin_p != cin:
        x = F.pad(x, (0, 0, 0, 0, 0, cin_p - cin))
        w = F.pad(w, (0, 0, 0, 0, 0, cin_p - cin))
    if cout_p != cout:
        w = F.pad(w, (0, 0, 0, 0, 0, 0, 0, cout_p - cout))
    out = launch.run(plan, x.contiguous(), w.contiguous())
    return out[:cout]
