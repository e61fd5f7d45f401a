"""Flash attention: the paper's active-accumulation principle applied to
attention. The (running max m, running denominator l, weighted-value
accumulator acc) triple is the partial sum; it stays on chip across the kv
blocks instead of materialising S = QK^T in device memory (which would be the
passive schedule).

On a CUDA tensor `flash_attention` runs the hand-written kernels in
``csrc/flash_attention.cu``; `flash_launch_plan` picks one of four bodies
from the dtype and the shape, and the plan names it:

  ``tc_bf16``    bfloat16, one pass: 128 q rows per block, QK^T and PV on
                 the tensor cores (wgmma), K/V tiles staged by TMA; P is
                 rounded to bf16 before PV (the reference keeps it fp32).
  ``tc_3xtf32``  float32, one pass at head dims up to TF_MAX_D: tc_bf16's
                 block on TF32 tensor cores in three passes. One TF32 pass
                 keeps 11 significant bits of each operand and misses
                 float32's 2e-4; a pack pass (one launch a call, counted as
                 ``flash_attention/pack``) splits K and V into hi + lo
                 (`tf32_split`) and lays V out transposed with its keys
                 permuted (`tf32_pack_kv`), the block splits Q and P itself,
                 and QK^T and PV each sum lo*hi + hi*lo + hi*hi.
  ``cuda_core``  float32, one pass on the fp32 cores: 32 q rows per block;
                 wider head dims (256), or asked for by name (``body=`` of
                 `flash_launch_plan`).
  ``split_kv``   either dtype, when the one-pass grid would not fill the
                 card (at most SPLIT_ROWS rows of a kv head and fewer
                 one-pass blocks than SMS): the keys are cut into ranges, a
                 block per (kv head, range) writes its fp32 (m, l, acc) to
                 device memory, and a second kernel combines them. That
                 round trip is the passive half of the trade, on the split
                 axis only; the plan lists it as device scratch.

A device position: a serving step captured as a CUDA graph cannot read its
position on the host, so `flash_attention` also takes ``q_offset`` and
``kv_valid_len`` as int32 tensors on the device, the reference's traced
``pos`` and ``pos + s`` in ``chunked_attention``. K and V are then the whole
cache, unpadded; the plan is made from its capacity (``device_pos``) and
takes split_kv, whose first pass reads the two values from device memory
when it starts. A split past the valid length sees no key and gets weight
0 in the combine, so one launch serves every position of a request.

On a CPU tensor it runs `flash_plain`, the reference's kv-block loop in
plain PyTorch, with the same key ranges and combine as ``split_kv`` when the
plan splits.

Head dims: the CUDA kernels are built for HEAD_DIMS. A call at another d up
to the widest (StableLM-12B's 160) is zero-padded in the wrapper to the next
built dim (`built_head_dim`) and the output sliced back; the softmax scale
stays 1/sqrt(d) of the logical d, and zero columns add nothing to q k^T or
to the output's kept columns. The plan lists the padded copies as device
scratch. At d = 160 that costs 256 / 160 = 1.6 x the arithmetic.

GQA: k and v may carry fewer heads than q. With ``kv_group = g`` query head
``bh`` reads kv head ``bh // g``; for a (B, Hq) head layout with Hq = g * Hkv
that is head ``h // g`` of the same batch row, so no kv head is copied.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, launch
from repro_torch.kernels.psum_matmul import tf32_split
from repro_torch.plan.gemm_model import SMEM_BUDGET
from repro_torch.plan.units import nbytes

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)     # head dims the CUDA kernels are built for
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_SOURCE = "flash_attention"
SMS = 132                          # streaming multiprocessors of an H100 SXM

# cuda_core: 32 q rows per block, 8 row groups x 16 key / column groups
QT = 32
THREADS = 128
# tc_bf16: 128 q rows per block, two consumer warpgroups and a producer warp
TC_QT = 128
TC_THREADS = 288
TC_STAGES = 2
# tc_3xtf32: tc_bf16's block over tiles of TF_KT keys of K_hi, K_lo, Vt_hi
# and Vt_lo, head dims up to TF_MAX_D; the pack stores each group of 8 keys
# of V^T in TF_KEY_ORDER
TF_KT = 32
TF_MAX_D = 128
TF_KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
# split_kv: a block serves at most SPLIT_ROWS rows of one kv head; its keys
# are staged SPLIT_KT at a time, and a split holds about SPLIT_UNIT keys or
# more
SPLIT_ROWS = 64
SPLIT_THREADS = 128
SPLIT_KT = 32
SPLIT_UNIT = 64

_C_ARGS = {
    "flash_attention_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                               + [ctypes.c_float, ctypes.c_void_p]),
    "flash_tf32_launch": ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                          + [ctypes.c_float, ctypes.c_void_p]),
    "flash_attention_pack": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    "flash_split_launch": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 11
                           + [ctypes.c_float, ctypes.c_void_p]),
    "flash_combine_launch": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                             + [ctypes.c_void_p]),
}


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


def built_head_dim(d: int) -> int:
    """The head dim the CUDA kernels run a call of head dim d at: the
    narrowest of HEAD_DIMS that holds it, or d itself past the widest
    (which the wrapper then refuses)."""
    return next((b for b in HEAD_DIMS if b >= d), d)


def smem_floats(d: int) -> int:
    """fp32 values of shared memory one cuda_core block uses: the q tile, one
    K and one V tile of kt keys (rows padded by 4 against bank conflicts) and
    the p tile; as ``Tile<D>`` in the CUDA source."""
    kt = 32 if d > 128 else 64
    return QT * (d + 4) + 2 * kt * (d + 4) + QT * (kt + 4)


def tc_keys(d: int) -> int:
    """Keys per K/V tile of the tc_bf16 body (``tc::Cfg<D>::KT``): at
    D = 256 the O accumulator alone holds 128 fp32 registers of the 168 a
    thread gets, so the S tile shrinks to 32 keys."""
    return 32 if d > 128 else 128


def tc_smem_bytes(d: int) -> int:
    """Shared memory of one tc_bf16 block (``tc::Cfg<D>::SMEM``): 1024 bytes
    to align to the swizzle pattern, the bf16 q tile, TC_STAGES K and V
    tiles, and the mbarriers."""
    return 1024 + 2 * d * (TC_QT + 2 * TC_STAGES * tc_keys(d)) + 8 * (1 + 3 * TC_STAGES)


def tf_stages(d: int) -> int:
    """Stages of K_hi, K_lo, Vt_hi and Vt_lo tiles in a tc_3xtf32 block
    (``tf::Cfg<D>::STAGES``): two where they fit beside Q_hi and Q_lo in
    one block's shared memory, else one (at d = 128)."""
    fixed = 1024 + 2 * 4 * TC_QT * d
    return 2 if fixed + 2 * 16 * TF_KT * d + 8 * 9 <= SMEM_BUDGET else 1


def tf_smem_bytes(d: int) -> int:
    """Shared memory of one tc_3xtf32 block (``tf::Cfg<D>::SMEM``): 1024
    bytes to align to the swizzle pattern, the fp32 Q_hi and Q_lo tiles of
    TC_QT rows, `tf_stages` stages of four fp32 tiles of TF_KT keys, and
    the mbarriers (q_full, and a full and an empty one for K and for V^T
    per stage)."""
    stages = tf_stages(d)
    return (1024 + 2 * 4 * TC_QT * d + stages * 4 * 4 * TF_KT * d
            + 8 * (1 + 4 * stages))


def tf_key_order(n: int) -> torch.Tensor:
    """The key tc_3xtf32's pack stores at each of n positions of a V^T row:
    each group of 8 keys in TF_KEY_ORDER, so that the S accumulator's
    registers of a group are wgmma's TF32 A fragment as they stand."""
    pos = torch.arange(n)
    return (pos & ~7) + torch.tensor(TF_KEY_ORDER)[pos & 7]


def tf32_pack_kv(kp: torch.Tensor, vp: torch.Tensor, *, skv_t: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """tc_3xtf32's pack pass over padded float32 k and v (hkv, skv_p, d):
    ks (2, hkv, skv_p, d) = K_hi, K_lo; vts (2, hkv, d, skv_t) = Vt_hi,
    Vt_lo, V transposed, zero-padded to skv_t keys, each group of 8 keys in
    `tf_key_order`. A CUDA tensor runs the pass's kernel (one launch,
    counted as ``flash_attention/pack``); a CPU tensor its plain version,
    `tf32_split`."""
    hkv, skv_p, d = kp.shape
    if kp.device.type == "cpu":
        vt = F.pad(vp.transpose(1, 2), (0, skv_t - skv_p))[..., tf_key_order(skv_t)]
        return torch.stack(tf32_split(kp)), torch.stack(tf32_split(vt))
    name = "flash_attention/pack"
    launch.check_operands(name, kp, vp, dtypes=(torch.float32,))
    if d % 32 or skv_t % TF_KT or skv_t < skv_p or kp.data_ptr() % 16:
        raise ValueError(f"{name}: needs a head dim ({d}) that is a multiple "
                         f"of 32, {skv_t} >= {skv_p} keys in whole tiles of "
                         f"{TF_KT}, and k on a 16-byte boundary")
    fn = _entry_points()["flash_attention_pack"]
    ks = torch.empty(2, hkv, skv_p, d, dtype=torch.float32, device=kp.device)
    vts = torch.empty(2, hkv, d, skv_t, dtype=torch.float32, device=kp.device)
    with torch.cuda.device(kp.device):
        rc = fn(kp.data_ptr(), vp.data_ptr(), ks.data_ptr(), vts.data_ptr(), hkv,
                skv_p, skv_t, d, torch.cuda.current_stream(kp.device).cuda_stream)
        _build.check(_build.load(KERNEL_SOURCE), rc, name)
        launch.count_launch(name)
    return ks, vts


def split_smem_bytes(d: int, rows: int, dtype: torch.dtype) -> int:
    """Shared memory of one split_kv block (``split::Cfg<T, D>::smem``): fp32
    q rows, p rows and (m, l, alpha) per row, and two stages of K and V
    tiles whose rows carry 16 bytes of padding."""
    return (4 * rows * (d + 4 + SPLIT_KT + 4 + 3)
            + 4 * SPLIT_KT * (nbytes(d, dtype.itemsize) + 16))


def split_keys(*, hkv: int, rows: int, skv: int, d: int) -> tuple[int, int]:
    """(splits, keys per split) of a split_kv launch, from integers alone.

    As many splits as make the hkv x splits blocks one wave of SMS, with at
    least SPLIT_UNIT keys in each; but no more than keep a split's partials
    (rows x (d + 2) fp32 words, written once and read once) within half the
    bytes of the bf16 K and V it reads (2 x keys x d values), that is at
    least 4 x rows x (d + 2) / d keys a split. The ranges cut [0, skv)
    evenly and none is empty."""
    units = -(-skv // SPLIT_UNIT)
    wave = -(-SMS // hkv)
    bounded = skv * d // (4 * rows * (d + 2))
    split_len = -(-skv // max(1, min(units, wave, bounded)))
    return -(-skv // split_len), split_len


def one_pass_body(dtype: torch.dtype, d_run: int) -> str:
    """The one-pass body of a dtype at the built head dim d_run: tc_bf16
    for bfloat16; tc_3xtf32 for float32 up to TF_MAX_D, where its O tile
    and its Q_hi and Q_lo tiles fit (at 256 a 64-row O tile alone takes
    128 registers a thread), cuda_core past it."""
    if dtype == torch.bfloat16:
        return "tc_bf16"
    return "tc_3xtf32" if d_run <= TF_MAX_D else "cuda_core"


def flash_body(*, bh: int, sq_p: int, kv_group: int, dtype: torch.dtype,
               d_run: int, device_pos: bool = False) -> str:
    """The kernel body a call takes: split_kv when its one-pass grid would
    not fill the card and a block can hold all rows of a kv head (rows of
    a block counted as TC_QT in bfloat16 and QT in float32), else
    `one_pass_body`. A device position takes split_kv, the one body that
    reads it, whatever the grid; more rows than a block holds raise."""
    rows = sq_p * kv_group
    if device_pos:
        if rows > SPLIT_ROWS:
            raise ValueError(
                f"flash_attention: a device position takes the split_kv "
                f"body, which serves at most {SPLIT_ROWS} rows of a kv head, "
                f"got {kv_group} heads x {sq_p} positions; the one-pass "
                f"bodies take an integer q_offset")
        return "split_kv"
    rows_per_block = TC_QT if dtype == torch.bfloat16 else QT
    if rows <= SPLIT_ROWS and bh * -(-sq_p // rows_per_block) < SMS:
        return "split_kv"
    return one_pass_body(dtype, d_run)


def _partials(q, kp, vp, q_ids, *, k_begin: int, k_end: int, bk: int,
              causal: bool, skv, scale: float):
    """The reference kernel's kv-block loop over keys [k_begin, k_end) from
    its initial state: per q row an fp32 running max m, sum l and acc. A
    key is masked past ``skv`` (an int, or a 0-d tensor: the valid length
    of a cache) and, when causal, past the row's q id (q_ids may be a
    tensor on the device); a masked key gets p = 0, as in
    ``chunked_attention``."""
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((*q.shape[:-1], 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    for k0 in range(k_begin, k_end, bk):
        kb = kp[:, k0:min(k0 + bk, k_end)].float()
        vb = vp[:, k0:min(k0 + bk, k_end)].float()
        s = torch.einsum("hgiqd,hkd->hgiqk", q, kb) * scale
        k_ids = k0 + torch.arange(kb.shape[1], device=q.device)
        mask = k_ids < skv
        if causal:
            mask = mask & (q_ids >= k_ids)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - m_new), 0.0)
        alpha = torch.exp(m - m_new)           # rescale the old partial sums
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("hgiqk,hkd->hgiqd", p, vb)
        m = m_new
    return m, l, acc


def fold_splits(m_s: torch.Tensor, l_s: torch.Tensor, acc_s: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The partials of splits stacked on dim 0, folded into one (m, l, acc):
    m* = max m_s, weights exp(m_s - m*), l and acc their weighted sums, as
    split_kv's second pass folds them. A split that saw no key (m_s =
    NEG_INF, l_s = 0) gets weight 0; if none saw a key, m* = NEG_INF and l =
    acc = 0."""
    m = m_s.amax(0)
    w = torch.exp(m_s - m)
    return m, (l_s * w).sum(0), (acc_s * w).sum(0)


def flash_plain(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor, *,
                bq: int, bk: int, causal: bool, q_offset: int,
                skv: int, splits: int = 1,
                pos: torch.Tensor | None = None, partials: bool = False):
    """The plain version: the reference kernel's kv-block loop over padded
    operands, every (head, q block) at once. qp: (BH, Sq_p, D); kp/vp:
    (BH / g, Skv_p, D). Per q row it carries an fp32 acc, m and l.

    tc_3xtf32 differs from it in what three TF32 passes drop: lo*lo and
    the split's residue (2^-22 of each operand, in QK^T and in PV), and the
    tensor cores' sums, which truncate rather than round (O is summed by
    them over the whole walk); cuda_core and split_kv only in the order of
    the sums, tc_bf16 also in P rounded to bf16.

    With ``splits > 1`` the keys [0, skv) are cut into ranges of
    ceil(skv / splits), as split_kv cuts them: each range runs the loop from
    its own initial state, and the partials combine as split_kv's second
    pass does (m* = max m_s, weights exp(m_s - m*)). ``splits = 1`` is the
    reference's single walk over all Skv_p keys.

    ``pos``, where given, is split_kv's device position: int32 (q_offset,
    valid length) on the operands' device, read in place of ``q_offset``
    and ``skv`` in the masks (``skv`` is then the capacity the ranges cut),
    with no host read.

    ``partials``: return the unnormalised fp32 (m, l, acc) of every row,
    shaped (BH, Sq_p, 1), (BH, Sq_p, 1) and (BH, Sq_p, D), in place of the
    output (a row that saw no key: m = NEG_INF, l = acc = 0), for a
    caller that combines them with other ranks' (flash decoding)."""
    bh, sq_p, d = qp.shape
    hkv, skv_p, _ = kp.shape
    g, gq = bh // hkv, sq_p // bq
    q = qp.float().reshape(hkv, g, gq, bq, d)
    valid = skv
    if pos is not None:
        q_offset, valid = pos[0], pos[1]
    q_ids = (torch.arange(gq, device=qp.device)[:, None] * bq
             + torch.arange(bq, device=qp.device)[None, :] + q_offset)[..., None]
    kw = dict(bk=bk, causal=causal, skv=valid, scale=1.0 / math.sqrt(d))
    if splits == 1:
        m, l, acc = _partials(q, kp, vp, q_ids, k_begin=0, k_end=skv_p, **kw)
    else:
        split_len = -(-skv // splits)
        ms, ls, accs = zip(*(_partials(q, kp, vp, q_ids, k_begin=b,
                                       k_end=min(skv, b + split_len), **kw)
                             for b in range(0, splits * split_len, split_len)))
        m, l, acc = fold_splits(torch.stack(ms), torch.stack(ls),
                                torch.stack(accs))
    if partials:
        return (m.reshape(bh, sq_p, 1), l.reshape(bh, sq_p, 1),
                acc.reshape(bh, sq_p, d))
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(bh, sq_p, d).to(qp.dtype)


def _flash_cuda(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor, *,
                causal: bool, q_offset: int, skv: int, splits: int = 0,
                dtype: torch.dtype | None = None, body: str | None = None,
                pos: torch.Tensor | None = None, partials: bool = False):
    """Launch the Hopper kernels at the built head dim of the operands' d:
    zero-pad q, k and v to it, keep the scale of the logical d, and slice
    the output back. ``dtype``, where given, is the dtype the launch plan
    chose its body for: operands of another dtype raise, before any copy or
    library load. ``body`` is the plan's; None takes split_kv when
    ``splits`` is given, else `one_pass_body`. ``pos`` is split_kv's device
    position (`flash_plain`). ``partials``: split_kv's pass 1 alone, its
    (m, l, acc) folded over the splits and handed back (`flash_plain`)."""
    name = "flash_attention"
    launch.check_operands(name, qp, kp, vp, dtypes=DTYPE_CODES)
    if dtype is not None and qp.dtype != dtype:
        raise ValueError(f"{name}: the plan chose its body for {dtype}, got "
                         f"{qp.dtype} operands")
    d = qp.shape[-1]
    d_run = built_head_dim(d)
    if body is None:
        body = "split_kv" if splits else one_pass_body(qp.dtype, d_run)
    kw = dict(causal=causal, q_offset=q_offset, skv=skv, splits=splits, d=d,
              body=body)
    if pos is not None:
        kw["pos"] = pos
    if partials:
        kw["partials"] = True
    if d_run == d:
        return _flash_launch(qp, kp, vp, **kw)
    qp, kp, vp = (F.pad(t, (0, d_run - d)) for t in (qp, kp, vp))
    out = _flash_launch(qp, kp, vp, **kw)
    if partials:
        m, l, acc = out
        return m, l, acc[..., :d]
    return out[..., :d]


def _flash_launch(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor, *,
                  causal: bool, q_offset: int, skv: int, splits: int,
                  d: int, body: str, pos: torch.Tensor | None = None,
                  partials: bool = False):
    """Launch the Hopper kernels of ``body`` over padded operands: one pass
    on cuda_core (float32) or tc_bf16 (bfloat16); tc_3xtf32 (float32) after
    its pack pass (`tf32_pack_kv`); or split_kv, pass 1 over `splits` key
    ranges into fp32 partials allocated here, then the combine (counted as
    ``flash_attention/combine``). ``d`` is the logical head dim, whose
    1/sqrt(d) scales the scores; the operands may be zero-padded past it.
    ``pos`` (split_kv only) is the device position: two int32 on the
    operands' device, read by pass 1 in place of ``q_offset`` and ``skv``.
    ``partials`` (split_kv only): no combine; pass 1's partials are folded
    over the splits here (`fold_splits`) and handed back as fp32 (m, l,
    acc), (BH, Sq_p, 1), (BH, Sq_p, 1) and (BH, Sq_p, d_run).
    Everything a body cannot take raises before any library is loaded."""
    name = "flash_attention"
    bh, sq_p, d_run = qp.shape
    hkv, skv_p, _ = kp.shape
    if d_run not in HEAD_DIMS or d > d_run:
        raise ValueError(f"{name}: head dim {d}; the kernel is built for "
                         f"{HEAD_DIMS} and pads up to the widest")
    if bh % hkv or tuple(vp.shape) != tuple(kp.shape):
        raise ValueError(f"{name}: q heads {bh} over k {tuple(kp.shape)}, "
                         f"v {tuple(vp.shape)}")
    takes = {"cuda_core": torch.float32, "tc_3xtf32": torch.float32,
             "tc_bf16": torch.bfloat16, "split_kv": qp.dtype}
    if body not in takes or (body == "split_kv") != bool(splits):
        raise ValueError(f"{name}: body {body!r} with splits={splits}")
    if partials and body != "split_kv":
        raise ValueError(f"{name}: partials come from split_kv's pass 1, "
                         f"not from body {body!r}")
    if qp.dtype != takes[body]:
        raise ValueError(f"{name}: {body} takes {takes[body]}, got {qp.dtype}")
    if body == "tc_3xtf32" and d_run > TF_MAX_D:
        raise ValueError(f"{name}: tc_3xtf32 takes head dims up to "
                         f"{TF_MAX_D}, got {d_run}")
    group = bh // hkv
    if splits and group * sq_p > SPLIT_ROWS:
        raise ValueError(f"{name}: split_kv serves at most {SPLIT_ROWS} rows "
                         f"of a kv head, got {group} heads x {sq_p} positions")
    if pos is not None and (not splits or pos.dtype != torch.int32
                            or tuple(pos.shape) != (2,)
                            or pos.device != qp.device):
        raise ValueError(f"{name}: a device position is two int32 on the "
                         f"operands' device, read by split_kv only; got "
                         f"{pos.dtype} {tuple(pos.shape)} on {pos.device} "
                         f"for body {body}")
    out = torch.empty_like(qp)
    if any(t.data_ptr() % 16 for t in (qp, kp, vp, out)):
        raise ValueError(f"{name}: operands must start on 16-byte boundaries")
    fns, lib = _entry_points(), _build.load(KERNEL_SOURCE)
    code, scale = DTYPE_CODES[qp.dtype], 1.0 / math.sqrt(d)
    stream = torch.cuda.current_stream(qp.device).cuda_stream
    with torch.cuda.device(qp.device):
        if body == "tc_3xtf32":
            skv_t = skv_p + (-skv_p) % TF_KT
            ks, vts = tf32_pack_kv(kp, vp, skv_t=skv_t)
            rc = fns["flash_tf32_launch"](
                qp.data_ptr(), ks.data_ptr(), vts.data_ptr(), out.data_ptr(), bh,
                sq_p, skv_p, skv_t, skv, d_run, group, int(causal), q_offset,
                scale, stream)
            _build.check(lib, rc, name)
            launch.count_launch(name)
            return out
        if not splits:
            rc = fns["flash_attention_launch"](
                qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
                code, bh, sq_p, skv_p, skv, d_run, group, int(causal), q_offset,
                scale, stream)
            _build.check(lib, rc, name)
            launch.count_launch(name)
            return out
        # the partials in one buffer: acc (hkv, splits, rows, d_run), then
        # (m, l) (hkv, splits, rows, 2); d_run >= 32 keeps the second
        # 16-byte aligned
        n_acc = hkv * splits * group * sq_p * d_run
        part = torch.empty(n_acc + 2 * n_acc // d_run, dtype=torch.float32,
                           device=qp.device)
        acc_ptr, ml_ptr = part.data_ptr(), part[n_acc:].data_ptr()
        rc = fns["flash_split_launch"](
            qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), acc_ptr, ml_ptr,
            None if pos is None else pos.data_ptr(), code, bh, sq_p, skv_p, skv,
            d_run, group, int(causal), q_offset, splits, -(-skv // splits),
            scale, stream)
        _build.check(lib, rc, name)
        launch.count_launch(name)
        if partials:
            acc = part[:n_acc].view(hkv, splits, group, sq_p, d_run)
            ml = part[n_acc:].view(hkv, splits, group, sq_p, 2)
            m, l, acc = fold_splits(ml[..., :1].transpose(0, 1),
                                    ml[..., 1:].transpose(0, 1),
                                    acc.transpose(0, 1))
            return (m.reshape(bh, sq_p, 1), l.reshape(bh, sq_p, 1),
                    acc.reshape(bh, sq_p, d_run))
        rc = fns["flash_combine_launch"](
            acc_ptr, ml_ptr, out.data_ptr(), code, hkv, sq_p, d_run, group, splits,
            stream)
        _build.check(lib, rc, f"{name}/combine")
        launch.count_launch(f"{name}/combine")
    return out


@functools.lru_cache(maxsize=1024)
def flash_launch_plan(*, bh: int, sq: int, skv: int, d: int, bq: int = 128,
                      bk: int = 128, causal: bool = True, q_offset: int = 0,
                      kv_group: int = 1, dtype: torch.dtype | None = None,
                      body: str | None = None, device_pos: bool = False,
                      partials: bool = False) -> launch.LaunchPlan:
    """The launch `flash_attention` executes, from plain integers: blocks
    clamped and sequences padded exactly as the reference does, the body
    picked by `flash_body` for ``dtype`` (float32 when None), or ``body``
    where given: the body `flash_body` picks, or cuda_core for a float32
    call (any other raises). The grid, threads, shared memory and in-block
    loops are the body's:

      tc_bf16    grid (BH, q tiles of TC_QT); loop over the kv tiles of
                 `tc_keys(d)` keys that the longest block walks
      tc_3xtf32  tc_bf16's grid; loop over the kv tiles of TF_KT keys; its
                 pack pass is one launch more, and K_hi, K_lo, Vt_hi and
                 Vt_lo are device scratch
      cuda_core  grid (q tiles of QT, BH); loop over the reference's kv
                 blocks
      split_kv   grid (splits, BH / g), then the combine, grid (g x Sq_p,
                 BH / g); loops: kv tiles of SPLIT_KT per split, and the
                 splits; the fp32 partials are device scratch

    Each body runs at `built_head_dim(d)`; where that is wider than d, the
    zero-padded copies of q, k and v are device scratch too.

    ``device_pos``: the call passes its position on the device (``pos`` to
    either callable, see `flash_plain`). ``skv`` is then the capacity of a
    cache, which the plan takes unpadded (split_kv's loads mask the tail)
    and the splits cut; ``q_offset`` must be 0, and the body is split_kv.

    ``partials``: split_kv's pass 1 alone, one launch, whose fp32 (m, l,
    acc) per row, folded over the splits, are the outputs in place of out
    (`flash_plain`); the caller combines them (flash decoding over a
    sequence-sharded cache, `repro_torch.sharding.flash_decode`). It takes
    a device position, so that a rank whose block lies past the position
    sees no key.

    A plan is a pure function of these arguments and is cached: the layers
    of a serving step, which share a shape, build it once.
    """
    dtype = torch.float32 if dtype is None else dtype
    bq = max(1, min(bq, sq))
    bk = max(1, min(bk, skv))
    if device_pos and q_offset:
        raise ValueError(f"flash_attention: q_offset={q_offset} with a device "
                         f"position; the position is read on the device")
    if partials and not device_pos:
        raise ValueError("flash_attention: partials come from split_kv's "
                         "pass 1, which a device position takes")
    sq_p = sq + (-sq) % bq
    skv_p = skv if device_pos else skv + (-skv) % bk
    gk = -(-skv_p // bk)
    hkv = bh // kv_group
    rows = kv_group * sq_p
    d_run = built_head_dim(d)
    chosen = flash_body(bh=bh, sq_p=sq_p, kv_group=kv_group, dtype=dtype,
                        d_run=d_run, device_pos=device_pos)
    if body is None:
        body = chosen
    elif body != chosen and not (body == "cuda_core" and dtype == torch.float32):
        raise ValueError(f"flash_attention: body {body!r} does not take this "
                         f"launch; it takes {chosen}"
                         + (" or cuda_core" if dtype == torch.float32 else ""))
    splits, packs = 0, 0
    scratch = (launch.ScratchPlan("acc", (bq, d_run), "registers"),
               launch.ScratchPlan("m", (bq, 1), "registers"),
               launch.ScratchPlan("l", (bq, 1), "registers"))
    kv_end = min(skv, q_offset + sq_p) if causal else skv
    if body == "split_kv":
        splits, split_len = split_keys(hkv=hkv, rows=rows, skv=skv, d=d_run)
        grid, threads = (splits, hkv), SPLIT_THREADS
        smem = split_smem_bytes(d_run, rows, dtype)
        loops = (("kv", -(-split_len // SPLIT_KT)), ("splits", splits))
        scratch = (launch.ScratchPlan("acc", (rows, d_run), "registers"),
                   launch.ScratchPlan("m", (rows, 1), "shared"),
                   launch.ScratchPlan("l", (rows, 1), "shared"),
                   launch.ScratchPlan("part_acc", (hkv, splits, rows, d_run), "device"),
                   launch.ScratchPlan("part_ml", (hkv, splits, rows, 2), "device"))
    elif body == "tc_bf16":
        grid, threads = (bh, -(-sq_p // TC_QT)), TC_THREADS
        smem, loops = tc_smem_bytes(d_run), (("kv", -(-kv_end // tc_keys(d_run))),)
    elif body == "tc_3xtf32":
        grid, threads = (bh, -(-sq_p // TC_QT)), TC_THREADS
        smem, loops = tf_smem_bytes(d_run), (("kv", -(-kv_end // TF_KT)),)
        packs, skv_t = 1, skv_p + (-skv_p) % TF_KT
        scratch += (launch.ScratchPlan("q_tiles", (2, TC_QT, d_run), "shared"),
                    launch.ScratchPlan("kv_ring", (tf_stages(d_run), 4, TF_KT, d_run),
                                       "shared"),
                    launch.ScratchPlan("k_hi", (hkv, skv_p, d_run), "device"),
                    launch.ScratchPlan("k_lo", (hkv, skv_p, d_run), "device"),
                    launch.ScratchPlan("vt_hi", (hkv, d_run, skv_t), "device"),
                    launch.ScratchPlan("vt_lo", (hkv, d_run, skv_t), "device"))
    else:
        grid, threads = (-(-sq_p // QT), bh), THREADS
        smem, loops = 4 * smem_floats(d_run), (("kv", gk),)
    kv_shape = (hkv, skv_p, d)
    outputs = (launch.OperandPlan("out", (bh, sq_p, d), (1, bq, d)),)
    if partials:
        outputs = (launch.OperandPlan("m", (bh, sq_p, 1), (1, bq, 1)),
                   launch.OperandPlan("l", (bh, sq_p, 1), (1, bq, 1)),
                   launch.OperandPlan("acc", (bh, sq_p, d), (1, bq, d)))
    if d_run != d:
        scratch += (launch.ScratchPlan("q_padded", (bh, sq_p, d_run), "device"),
                    launch.ScratchPlan("k_padded", (hkv, skv_p, d_run), "device"),
                    launch.ScratchPlan("v_padded", (hkv, skv_p, d_run), "device"))
    return launch.LaunchPlan(
        name="flash_attention",
        grid=grid,
        threads=threads,
        smem_bytes=smem,
        launches=(2 if splits and not partials else 1) + packs,
        loops=loops,
        inputs=(launch.OperandPlan("q", (bh, sq_p, d), (1, bq, d)),
                launch.OperandPlan("k", kv_shape, (1, bk, d)),
                launch.OperandPlan("v", kv_shape, (1, bk, d))),
        outputs=outputs,
        scratch=scratch,
        cuda=functools.partial(_flash_cuda, causal=causal, q_offset=q_offset,
                               skv=skv, splits=splits, dtype=dtype, body=body,
                               partials=partials),
        plain=functools.partial(flash_plain, bq=bq, bk=bk, causal=causal,
                                q_offset=q_offset, skv=skv,
                                splits=max(1, splits), partials=partials),
        body=body,
    )


def device_position(q_offset: int | torch.Tensor,
                    kv_valid_len: torch.Tensor | None, capacity: int
                    ) -> torch.Tensor:
    """split_kv's device position: (q_offset, valid length) as two int32 on
    the device of the tensor given, built there with no host read. An
    integer offset is filled in on the device; a missing valid length is
    the capacity (every key valid)."""
    like = q_offset if isinstance(q_offset, torch.Tensor) else kv_valid_len
    off = (q_offset if isinstance(q_offset, torch.Tensor)
           else torch.full_like(like, q_offset))
    valid = (kv_valid_len if kv_valid_len is not None
             else torch.full_like(like, capacity))
    return torch.stack([t.reshape(()).to(torch.int32) for t in (off, valid)])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128, bk: int = 128,
                    q_offset: int | torch.Tensor = 0,
                    kv_valid_len: torch.Tensor | None = None,
                    partials: bool = False):
    """q: (BH, Sq, D); k/v: (BH / g, Skv, D) for a whole g >= 1 (g = 1 is
    the reference's layout), float32 or bfloat16. q_offset shifts the causal
    ids for decode (q positions start at q_offset). q, k and v are
    zero-padded to block multiples; padded keys are masked (``k_ids < skv``)
    when causal, and the non-causal padded case is rejected before launch.

    With ``q_offset`` a 0-d integer tensor, or ``kv_valid_len`` given (keys
    at or past it are masked: a cache's tail), the position is read on the
    device and never on the host, as the reference's ``chunked_attention``
    takes a traced one: k and v are a cache of Skv = its capacity, passed
    without a pad or a copy, and the call takes split_kv (`flash_body`).

    ``partials`` (a device position only): the fp32 (m, l, acc) of every
    row, (BH, Sq, 1), (BH, Sq, 1) and (BH, Sq, D), unnormalised, from
    split_kv's pass 1 alone (`flash_launch_plan`), in place of the output.

    Before its plan is built the call is pre-flighted by
    `repro_torch.check`: a host position runs the launch checks and the
    word-count certificate once per geometry (`preflight_flash_dataflow`),
    a device position its shape checks alone. A refusal raises
    `repro_torch.check.CheckError`, a `ValueError`."""
    from repro_torch import check       # deferred: check imports this module
    bh, sq, d = q.shape
    hkv, skv, _ = k.shape
    device_pos = isinstance(q_offset, torch.Tensor) or kv_valid_len is not None
    if device_pos:
        check.preflight_flash_launch(bh, sq, skv, d, bq, bk, causal,
                                     device_pos=True)
    if hkv < 1 or bh % hkv or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} over k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not device_pos:
        check.preflight_flash_dataflow(bh, sq, skv, d, bq, bk, causal,
                                       q_offset, kv_group=bh // hkv,
                                       dtype=q.dtype)
    plan = flash_launch_plan(bh=bh, sq=sq, skv=skv, d=d, bq=bq, bk=bk,
                             causal=causal,
                             q_offset=0 if device_pos else q_offset,
                             kv_group=bh // hkv, dtype=q.dtype,
                             device_pos=device_pos, partials=partials)
    pq = plan.inputs[0].array_shape[1] - sq
    pk = plan.inputs[1].array_shape[1] - skv
    q, k, v = (F.pad(t, (0, 0, 0, p)).contiguous() if p else t.contiguous()
               for t, p in ((q, pq), (k, pk), (v, pk)))
    extra = ({"pos": device_position(q_offset, kv_valid_len, skv)}
             if device_pos else {})
    out = launch.run(plan, q, k, v, **extra)
    if partials:
        return tuple(t[:, :sq] for t in out)
    return out[:, :sq]
