"""Channel-partitioned conv2d: the paper's loop nest with on-chip partial sums.

The paper's accelerator processes m input maps x n output maps per iteration
(eq 1: K^2*m*n <= P). The schedule's (m, n) set the channel blocks; the input
channels (the reduction) are walked block by block in order while the fp32
partial sums of the n-channel output block stay on chip, and the activation
is fused into the final store (the active controller and its ACT command).

On a CUDA tensor this runs the hand-written kernels in
``csrc/conv2d_psum.cu``, which add a parallel spatial-tile axis beside the
cout-block axis because a whole map of fp32 accumulators does not fit one
block. `conv_launch_plan` picks one of two bodies from the dtype and the
geometry each body computes here in plain Python, and the plan names it:

  ``tc_bf16``    bfloat16 whose `tc_geometry` fits the card: an implicit GEMM
                 on wgmma tensor cores. M is a tile of output positions, N the
                 block's output channels (rounded up to a built wgmma width),
                 K the cin block's channels (padded to multiples of TC_KG) x
                 K^2 taps, tap-major; A comes from registers, gathered from a
                 channel-innermost input slab in shared memory.
  ``cuda_core``  float32, and bfloat16 that `tc_geometry` refuses: the fp32
                 CUDA cores, each thread a register tile of CORE_NC channels x
                 CORE_R consecutive output columns of one row, its inputs
                 loaded once per (channel, kernel row) and reused across the
                 kernel's columns (`core_geometry`).

Neither body splits the cin reduction across thread blocks: that would send
partial sums through device memory, the passive schedule. A cout block wider
than one thread block holds is split along N over several thread blocks
instead, each keeping its share of the block's partial sums in registers
for the whole cin walk. A plan no body takes raises before anything runs.

On the card each call is two launches: a pack pass lays x and w out as the
body reads them (device scratch, counted as ``conv2d_psum/pack``), and the
body then pulls each chunk of a thread block's slab and weights with
one-dimensional bulk copies (TMA) into a double-buffered stage, so the next
chunk lands while this one is multiplied.

On a CPU tensor it runs `conv_plain`, the same cin-block / K x K loop nest in
plain PyTorch, for either body.

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

KERNEL_SOURCE = "conv2d_psum"
NAME = "conv2d_psum"
SMS = 132                  # streaming multiprocessors of an H100 SXM
MIN_BLOCKS = 2 * SMS       # thread blocks that put work on every SM twice
SMEM_LIMIT = 232_448       # shared memory one block may take on the card
# cuda_core: a thread holds CORE_NC channels x CORE_R columns of one row;
# items (an output row's run of CORE_R columns) go CORE_TI_MAX or fewer to a
# block per channel group, and a block takes CORE_SMEM bytes or fewer so that
# several share an SM
CORE_NC = 8
CORE_R = 4
CORE_TI_MAX = 128
CORE_THREADS = 256
CORE_MIN_THREADS = 64
CORE_SMEM = 48 * 1024
# tc_bf16: K steps of TC_KG channels (one wgmma k16); wgmma widths built for
# N; a block takes TC_SMEM bytes or fewer
TC_KG = 16
TC_WIDTHS = (8, 16, 24, 32, 48, 64, 96, 128)
TC_N_MAX = 128             # rows of N one thread block holds
TC_GROUPS = (8, 4, 2)      # cout blocks a thread block may take, widest first
TC_ROWS_M = 64             # output positions per thread block (one warpgroup)
TC_MIN_BLOCKS = SMS        # a grid of fewer blocks leaves SMs idle
TC_SMEM = 96 * 1024
BODIES = ("cuda_core", "tc_bf16")

_C_ARGS = {
    "conv2d_psum_core_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 20
                               + [ctypes.c_void_p],
    "conv2d_psum_tc_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 19
                             + [ctypes.c_void_p],
}
BARRIER_BYTES = 16         # the two stages' mbarriers


@functools.cache
def _entry_points() -> dict:
    """The library's C entry points, built and typed once per process."""
    lib = _build.load(KERNEL_SOURCE)
    fns = {}
    for name, argtypes in _C_ARGS.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


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


def _slab_rows(span: int, *, ho: int, wo: int, kk: int, stride: int) -> int:
    """Input rows (halo included) under `span` consecutive output positions
    in raster order, wherever the run starts."""
    out_rows = min(ho, (span + wo - 2) // wo + 1)
    return (out_rows - 1) * stride + kk


def _balanced(total: int, most: int) -> int:
    """The chunk size that walks `total` in as few chunks of at most `most`
    as possible, all but the last equal and none much smaller; 0 where
    `most` < 1."""
    if most < 1:
        return 0
    return -(-total // -(-total // most))


def core_geometry(*, hp: int, wp: int, ho: int, wo: int, kk: int, stride: int,
                  bm: int, bn: int, n_co: int) -> dict[str, int] | None:
    """How the cuda_core body tiles one cout block, or None where no block
    fits in CORE_SMEM.

    A thread owns CORE_NC channels x CORE_R consecutive output columns of
    one row (an item). The block's n channels (padded to CORE_NC) form
    ``groups`` channel groups, ``gpb`` of them per thread block and
    ``n_split`` thread blocks along N; each channel group runs ``ti`` items
    (a multiple of 32, so a warp shares its weights). ti halves, then gpb,
    while the grid has fewer than MIN_BLOCKS blocks and the block keeps
    CORE_MIN_THREADS threads. The input slab of a block's items is staged
    ``mc`` channels at a time (chunks as even as `_balanced` makes them),
    rows ``pitch`` floats apart (a multiple of 4,
    wide enough for the last item's reads), in two stages."""
    groups = -(-bn // CORE_NC)
    gpb = min(groups, CORE_THREADS // 32)
    ti = max(32, min(CORE_TI_MAX, CORE_THREADS // gpb) // 32 * 32)
    cols = -(-wo // CORE_R)
    items = ho * cols

    def blocks(ti_, gpb_):
        return -(-items // ti_) * n_co * -(-groups // gpb_)

    while blocks(ti, gpb) < MIN_BLOCKS:
        if ti > 32 and (ti // 2) * gpb >= CORE_MIN_THREADS:
            ti //= 2
        elif gpb > 1 and ti * -(-gpb // 2) >= CORE_MIN_THREADS:
            gpb = -(-gpb // 2)
        else:
            break
    rows_in = min(hp, _slab_rows(ti, ho=ho, wo=cols, kk=kk, stride=stride))
    need = (cols * CORE_R - 1) * stride + kk
    pitch = -(-max(wp, need) // 4) * 4
    ncb = gpb * CORE_NC
    per_channel = rows_in * pitch + kk * kk * ncb
    mc = _balanced(bm, (CORE_SMEM - BARRIER_BYTES) // (8 * per_channel))
    if mc < 1:
        return None
    return {"ti": ti, "gpb": gpb, "n_split": -(-groups // gpb),
            "n_cos": n_co * -(-groups // gpb), "cols": cols,
            "rows_in": rows_in, "pitch": pitch, "mc": mc,
            "threads": ti * gpb,
            "smem_bytes": 8 * mc * per_channel + BARRIER_BYTES,
            "n_tiles": -(-items // ti)}


def tc_width(n: int) -> int | None:
    """The narrowest built wgmma width that holds n channels."""
    return next((w for w in TC_WIDTHS if w >= n), None)


def tc_geometry(*, hp: int, wp: int, ho: int, wo: int, kk: int, stride: int,
                bm: int, bn: int, n_co: int) -> dict[str, int] | None:
    """How the tc_bf16 body tiles the cout blocks, or None where no block
    fits in TC_SMEM.

    A thread block is one warpgroup over TC_ROWS_M output positions (M).
    Its N holds ``cpb`` whole cout blocks, ``nb`` rows apart (n rounded up
    to 8), each with its own accumulator columns for its own cin walk; or,
    where n exceeds TC_N_MAX, a share of ``nt`` channels of one cout block,
    ``n_split`` thread blocks along N. The widest cpb of TC_GROUPS whose
    grid has TC_MIN_BLOCKS blocks and whose stages fit is taken (wgmma's
    cost grows slower than its width), else one cout block a thread block. ``nw`` is the narrowest
    built wgmma width that holds the rows; ``n_cos`` thread blocks cover the
    cout blocks. Each cin block is padded to ``kg`` groups of TC_KG channels
    (K = kg x TC_KG x K^2, tap-major), staged ``gcs`` groups at a time in
    two stages: the input slab (``rows_in`` rows of the padded map,
    channel-innermost) and the (K x nw) weights."""
    n_tiles = -(-ho * wo // TC_ROWS_M)
    rows_in = min(hp, _slab_rows(TC_ROWS_M, ho=ho, wo=wo, kk=kk, stride=stride))
    kg = -(-bm // TC_KG)

    def chunk_groups(nw):
        per_group = 2 * TC_KG * (rows_in * wp + kk * kk * nw)
        return _balanced(kg, (TC_SMEM - BARRIER_BYTES) // (2 * per_group)), per_group

    if bn > TC_N_MAX:
        n_split = -(-bn // TC_N_MAX)
        nt = -(-bn // n_split)
        nb = tc_width(-(-nt // 8) * 8)
        cpb = 1
    else:
        n_split, nt, nb = 1, bn, -(-bn // 8) * 8
        cpb = next((c for c in TC_GROUPS if c * nb <= TC_N_MAX and c <= n_co
                    and n_tiles * -(-n_co // c) >= TC_MIN_BLOCKS
                    and chunk_groups(tc_width(c * nb))[0] >= 1), 1)
    nw = tc_width(cpb * nb)
    gcs, per_group = chunk_groups(nw)
    if gcs < 1:
        return None
    return {"cpb": cpb, "nb": nb, "nt": nt, "nw": nw, "n_split": n_split,
            "n_cos": -(-n_co // cpb) * n_split, "rows_in": rows_in, "kg": kg,
            "gcs": gcs, "threads": 128,
            "smem_bytes": 2 * gcs * per_group + BARRIER_BYTES,
            "n_tiles": n_tiles}


def scratch_bytes(body: str, geo: dict[str, int], *, cin_p: int, hp: int,
                  kk: int, bm: int, wp: int) -> int:
    """Device scratch the pack pass writes for one call, x's layout then
    w's. cuda_core: x as (cin_p, hp, pitch) fp32 and w as (thread block,
    cin_p, K^2, gpb x CORE_NC) fp32. tc_bf16: x as (cin block, kg, 2,
    hp x wp, 8) bf16 and w as (thread block, cin block, kg, K^2, 2, nw, 8)
    bf16."""
    n_cos = geo["n_cos"]
    if body == "tc_bf16":
        groups = cin_p // bm * geo["kg"] * TC_KG
        return 2 * groups * (hp * wp + n_cos * kk * kk * geo["nw"])
    ncb = geo["gpb"] * CORE_NC
    return 4 * cin_p * (hp * geo["pitch"] + n_cos * kk * kk * ncb)


def conv_body(*, hp: int, wp: int, ho: int, wo: int, kk: int, stride: int,
              bm: int, bn: int, n_co: int, dtype: torch.dtype | None
              ) -> tuple[str, dict[str, int]] | None:
    """The body a launch takes and its geometry: tc_bf16 for bfloat16 where
    `tc_geometry` fits, cuda_core for float32 and for bfloat16 that
    tc_bf16 refuses (an input slab too wide for TC_SMEM), None where neither
    fits."""
    kw = dict(hp=hp, wp=wp, ho=ho, wo=wo, kk=kk, stride=stride, bm=bm, bn=bn,
              n_co=n_co)
    if dtype == torch.bfloat16:
        geo = tc_geometry(**kw)
        if geo is not None:
            return "tc_bf16", geo
    geo = core_geometry(**kw)
    return None if geo is None else ("cuda_core", geo)


def _conv_cuda(x: torch.Tensor, w: torch.Tensor, *, kk: int, stride: int,
               bm: int, bn: int, act: str, geo: dict[str, int],
               body: str = "cuda_core",
               dtype: torch.dtype | None = None) -> torch.Tensor:
    """Launch the pack pass, then the Hopper kernel once over (spatial
    tiles, cout blocks x N splits). ``dtype``, where given, is the dtype the plan chose its body
    for: operands of another dtype raise, as does a tc_bf16 launch of
    anything but bfloat16, before any library is loaded."""
    launch.check_operands(NAME, x, w, dtypes=DTYPE_CODES)
    if dtype is not None and x.dtype != dtype:
        raise ValueError(f"{NAME}: the plan chose its body for {dtype}, got "
                         f"{x.dtype} operands")
    if body == "tc_bf16" and x.dtype != torch.bfloat16:
        raise ValueError(f"{NAME}: tc_bf16 takes bfloat16, got {x.dtype}")
    if body not in BODIES:
        raise ValueError(f"{NAME}: unknown body {body!r}")
    cin_p, hp, wp = x.shape
    cout_p = w.shape[0]
    ho = (hp - kk) // stride + 1
    wo = (wp - kk) // stride + 1
    fns, lib = _entry_points(), _build.load(KERNEL_SOURCE)
    out = torch.empty(cout_p, ho, wo, dtype=x.dtype, device=x.device)
    scratch = torch.empty(
        scratch_bytes(body, geo, cin_p=cin_p, hp=hp, kk=kk, bm=bm, wp=wp),
        dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    shape = (cin_p, hp, wp, cout_p, ho, wo, kk, stride, bm, bn)
    ptrs = (x.data_ptr(), w.data_ptr(), out.data_ptr(), scratch.data_ptr())
    with torch.cuda.device(x.device):
        if body == "tc_bf16":
            rc = fns["conv2d_psum_tc_launch"](
                *ptrs, *shape, geo["cpb"], geo["nb"], geo["nt"], geo["nw"],
                geo["n_split"], geo["rows_in"], geo["gcs"], geo["smem_bytes"],
                ACT_CODES[act], stream)
        else:
            rc = fns["conv2d_psum_core_launch"](
                *ptrs, DTYPE_CODES[x.dtype],
                *shape, geo["ti"], geo["gpb"], geo["n_split"], geo["rows_in"],
                geo["pitch"], geo["mc"], geo["smem_bytes"], geo["n_tiles"],
                ACT_CODES[act], stream)
        _build.check(lib, rc, NAME)
        launch.count_launch(f"{NAME}/pack")
        launch.count_launch(NAME)
    return out


def conv_refusal(*, cin: int, hp: int, wp: int, cout: int, kk: int,
                 stride: int = 1, block_m: int = 32, block_n: int = 32,
                 dtype: torch.dtype | None = None) -> str | None:
    """Why no body takes this launch, or None where one does."""
    ho = (hp - kk) // stride + 1
    wo = (wp - kk) // stride + 1
    if min(ho, wo) < 1:
        return f"a {kk}x{kk} kernel over a {hp}x{wp} input has no output"
    bm = max(1, min(block_m, cin))
    bn = max(1, min(block_n, cout))
    n_co = -(-cout // bn)
    if conv_body(hp=hp, wp=wp, ho=ho, wo=wo, kk=kk, stride=stride, bm=bm,
                 bn=bn, n_co=n_co, dtype=dtype) is None:
        return (f"no kernel body holds one input channel of a {hp}x{wp} "
                f"map ({kk}x{kk}, stride {stride}) in a block's shared memory")
    return None


@functools.lru_cache(maxsize=1024)
def conv_launch_plan(*, cin: int, hp: int, wp: int, cout: int, kk: int,
                     stride: int = 1, block_m: int = 32, block_n: int = 32,
                     act: str = "none", dtype: torch.dtype | None = None
                     ) -> launch.LaunchPlan:
    """The launch `conv2d_psum` executes, from plain integers: the same
    clamping and channel padding as the reference's entry point, and the
    body `conv_body` picks for ``dtype`` (float32 when None). The grid is
    (spatial tiles, thread blocks along N: ``n_cos`` of the geometry);
    inside a block the loops walk
    the schedule's cin blocks, the staged chunks of each and the taps (for
    tc_bf16, the k16 steps of a chunk). The pack pass's layouts of x and w
    are device scratch (two launches a call). Raises where no body takes
    it. A plan is a pure function of these arguments and is cached: a
    network's layers are planned once, not once an image."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}; known: {sorted(ACTIVATIONS)}")
    refusal = conv_refusal(cin=cin, hp=hp, wp=wp, cout=cout, kk=kk,
                           stride=stride, block_m=block_m, block_n=block_n,
                           dtype=dtype)
    if refusal:
        raise ValueError(f"{NAME}: {refusal}")
    ho = (hp - kk) // stride + 1
    wo = (wp - kk) // stride + 1
    bm = max(1, min(block_m, cin))
    bn = max(1, min(block_n, cout))
    cin_p = cin + (-cin) % bm
    cout_p = cout + (-cout) % bn
    n_co = cout_p // bn
    body, geo = conv_body(hp=hp, wp=wp, ho=ho, wo=wo, kk=kk, stride=stride,
                          bm=bm, bn=bn, n_co=n_co, dtype=dtype)
    if body == "tc_bf16":
        loops = (("cin", cin_p // bm), ("chunk", -(-geo["kg"] // geo["gcs"])),
                 ("k16", geo["gcs"] * kk * kk))
        scratch = (launch.ScratchPlan("acc", (TC_ROWS_M, geo["nw"]), "registers"),
                   launch.ScratchPlan("slab", (geo["gcs"] * TC_KG, geo["rows_in"], wp),
                                      "shared"),
                   launch.ScratchPlan("wblock", (kk * kk * geo["gcs"] * TC_KG,
                                                 geo["nw"]), "shared"))
        packed = ((cin_p // bm * geo["kg"] * TC_KG, hp, wp),
                  (geo["n_cos"], cin_p // bm * geo["kg"] * TC_KG, kk * kk,
                   geo["nw"]))
    else:
        loops = (("cin", cin_p // bm), ("chunk", -(-bm // geo["mc"])),
                 ("tap", kk * kk))
        scratch = (launch.ScratchPlan("acc", (geo["gpb"] * CORE_NC,
                                              geo["ti"] * CORE_R), "registers"),
                   launch.ScratchPlan("slab", (geo["mc"], geo["rows_in"], geo["pitch"]),
                                      "shared"),
                   launch.ScratchPlan("wblock", (geo["mc"], kk * kk,
                                                 geo["gpb"] * CORE_NC), "shared"))
        packed = ((cin_p, hp, geo["pitch"]),
                  (n_co * geo["n_split"], cin_p, kk * kk, geo["gpb"] * CORE_NC))
    scratch += (launch.ScratchPlan("x_packed", packed[0], "device"),
                launch.ScratchPlan("w_packed", packed[1], "device"))
    return launch.LaunchPlan(
        name=NAME,
        grid=(geo["n_tiles"], geo["n_cos"]),
        threads=geo["threads"],
        smem_bytes=geo["smem_bytes"],
        launches=2,                         # the pack pass, then the body
        loops=loops,
        inputs=(launch.OperandPlan("x", (cin_p, hp, wp), (bm, hp, wp)),
                launch.OperandPlan("w", (cout_p, cin_p, kk, kk), (bn, bm, kk, kk))),
        outputs=(launch.OperandPlan("out", (cout_p, ho, wo), (bn, ho, wo)),),
        scratch=scratch,
        cuda=functools.partial(_conv_cuda, kk=kk, stride=stride, bm=bm, bn=bn,
                               act=act, body=body, geo=geo, dtype=dtype),
        plain=functools.partial(conv_plain, kk=kk, stride=stride, bm=bm, act=act),
        body=body,
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
                            act=act, dtype=x.dtype)
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
