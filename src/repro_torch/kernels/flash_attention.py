"""Flash attention: the paper's active-accumulation principle applied to
attention. The (running max m, running denominator l, weighted-value
accumulator acc) triple is the partial sum; it stays on chip across the kv
blocks instead of materialising S = QK^T in device memory (which would be the
passive schedule).

On a CUDA tensor `flash_attention` runs the hand-written kernel in
``csrc/flash_attention.cu``: the reference's sequential kv grid axis becomes
a loop inside the CUDA block, and the fp32 (m, l, acc) of each q row stay in
registers for all of it. On a CPU tensor it runs `flash_plain`, the
reference's kv-block loop in plain PyTorch.

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

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128, 256)     # head dims the CUDA kernel is built for
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
QT = 32           # q rows per CUDA block
THREADS = 128     # 8 row groups x 16 key / column groups
KERNEL_SOURCE = "flash_attention"

_C_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
           + [ctypes.c_float, ctypes.c_void_p])


def smem_floats(d: int) -> int:
    """fp32 values of shared memory one CUDA block uses: the q tile, one K and
    one V tile of kt keys (rows padded by 4 against bank conflicts) and the
    p tile; as ``Tile<D>`` in the CUDA source."""
    kt = 32 if d > 128 else 64
    return QT * (d + 4) + 2 * kt * (d + 4) + QT * (kt + 4)


def check_flash_launch(bh: int, sq: int, skv: int, d: int, bq: int = 128,
                       bk: int = 128, causal: bool = True,
                       q_offset: int = 0) -> None:
    """The launch-level check the reference makes before it builds a plan;
    raises `ValueError` on a degenerate shape, on a non-causal call whose
    keys would be padded (padded keys would get weight exp(0): only the
    causal mask hides them), and on a causal call with a negative q_offset."""
    if min(bh, sq, skv, d) < 1:
        raise ValueError(f"flash_attention: degenerate attention shape "
                         f"bh={bh} sq={sq} skv={skv} d={d}")
    bk_eff = max(1, min(bk, skv))
    if skv % bk_eff and not causal:
        raise ValueError(f"flash_attention: skv={skv} is not a multiple of "
                         f"bk={bk_eff} and causal=False: padded keys are "
                         f"masked by the causal mask only; pad kv to a block "
                         f"multiple or use causal masking")
    if causal and q_offset < 0:
        raise ValueError(f"flash_attention: negative q_offset={q_offset} puts "
                         f"query ids before key id 0")


def flash_plain(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor, *,
                bq: int, bk: int, causal: bool, q_offset: int,
                skv: int) -> torch.Tensor:
    """The plain version: the reference kernel's kv-block loop over padded
    operands, every (head, q block) at once. qp: (BH, Sq_p, D); kp/vp:
    (BH / g, Skv_p, D). Per q row it carries an fp32 acc, m and l."""
    bh, sq_p, d = qp.shape
    hkv, skv_p, _ = kp.shape
    g, gq = bh // hkv, sq_p // bq
    scale = 1.0 / math.sqrt(d)
    q = qp.float().reshape(hkv, g, gq, bq, d)
    acc = torch.zeros(hkv, g, gq, bq, d, dtype=torch.float32, device=qp.device)
    m = torch.full((hkv, g, gq, bq, 1), NEG_INF, dtype=torch.float32,
                   device=qp.device)
    l = torch.zeros_like(m)
    q_ids = (torch.arange(gq, device=qp.device)[:, None] * bq
             + torch.arange(bq, device=qp.device)[None, :] + q_offset)[..., None]
    for k0 in range(0, skv_p, bk):
        kb = kp[:, k0:k0 + bk].float()
        vb = vp[:, k0:k0 + bk].float()
        s = torch.einsum("hgiqd,hkd->hgiqk", q, kb) * scale
        if causal:
            k_ids = k0 + torch.arange(kb.shape[1], device=qp.device)
            s = torch.where((q_ids >= k_ids) & (k_ids < skv), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)           # rescale the old partial sums
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("hgiqk,hkd->hgiqd", p, vb)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(bh, sq_p, d).to(qp.dtype)


def _flash_cuda(qp: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor, *,
                causal: bool, q_offset: int, skv: int) -> torch.Tensor:
    """Launch the Hopper kernel once over padded operands."""
    name = "flash_attention"
    launch.check_operands(name, qp, kp, vp, dtypes=DTYPE_CODES)
    bh, sq_p, d = qp.shape
    hkv, skv_p, _ = kp.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d}; the kernel is built for "
                         f"{HEAD_DIMS}")
    if bh % hkv or tuple(vp.shape) != tuple(kp.shape):
        raise ValueError(f"{name}: q heads {bh} over k {tuple(kp.shape)}, "
                         f"v {tuple(vp.shape)}")
    out = torch.empty_like(qp)
    if any(t.data_ptr() % 16 for t in (qp, kp, vp, out)):
        raise ValueError(f"{name}: operands must start on 16-byte boundaries")
    lib = _build.load(KERNEL_SOURCE)
    fn = lib.flash_attention_launch
    fn.argtypes = _C_ARGS
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(qp.device).cuda_stream
    with torch.cuda.device(qp.device):
        rc = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
                DTYPE_CODES[qp.dtype], bh, sq_p, skv_p, skv, d, bh // hkv,
                int(causal), q_offset, 1.0 / math.sqrt(d), stream)
        _build.check(lib, rc, name)
        launch.count_launch(name)
    return out


def flash_launch_plan(*, bh: int, sq: int, skv: int, d: int, bq: int = 128,
                      bk: int = 128, causal: bool = True, q_offset: int = 0,
                      kv_group: int = 1) -> launch.LaunchPlan:
    """The launch `flash_attention` executes, from plain integers: blocks
    clamped and sequences padded exactly as the reference does. The CUDA grid
    is (row tiles of QT over the padded q rows, BH); the kv blocks are the
    loop inside each block."""
    bq = max(1, min(bq, sq))
    bk = max(1, min(bk, skv))
    sq_p = sq + (-sq) % bq
    skv_p = skv + (-skv) % bk
    gk = skv_p // bk
    kv_shape = (bh // kv_group, skv_p, d)
    return launch.LaunchPlan(
        name="flash_attention",
        grid=(-(-sq_p // QT), bh),
        threads=THREADS,
        smem_bytes=4 * smem_floats(d),
        launches=1,
        loops=(("kv", gk),),
        inputs=(launch.OperandPlan("q", (bh, sq_p, d), (1, bq, d)),
                launch.OperandPlan("k", kv_shape, (1, bk, d)),
                launch.OperandPlan("v", kv_shape, (1, bk, d))),
        outputs=(launch.OperandPlan("out", (bh, sq_p, d), (1, bq, d)),),
        scratch=(launch.ScratchPlan("acc", (bq, d), "registers"),
                 launch.ScratchPlan("m", (bq, 1), "registers"),
                 launch.ScratchPlan("l", (bq, 1), "registers")),
        cuda=functools.partial(_flash_cuda, causal=causal, q_offset=q_offset,
                               skv=skv),
        plain=functools.partial(flash_plain, bq=bq, bk=bk, causal=causal,
                                q_offset=q_offset, skv=skv),
    )


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128, bk: int = 128,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (BH, Sq, D); k/v: (BH / g, Skv, D) for a whole g >= 1 (g = 1 is
    the reference's layout), float32 or bfloat16. q_offset shifts the causal
    ids for decode (q positions start at q_offset). q, k and v are
    zero-padded to block multiples; padded keys are masked (``k_ids < skv``)
    when causal, and the non-causal padded case is rejected before launch."""
    bh, sq, d = q.shape
    hkv, skv, _ = k.shape
    check_flash_launch(bh, sq, skv, d, bq, bk, causal, q_offset)
    if hkv < 1 or bh % hkv or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} over k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    plan = flash_launch_plan(bh=bh, sq=sq, skv=skv, d=d, bq=bq, bk=bk,
                             causal=causal, q_offset=q_offset,
                             kv_group=bh // hkv)
    pq = plan.inputs[0].array_shape[1] - sq
    pk = plan.inputs[1].array_shape[1] - skv
    q, k, v = (F.pad(t, (0, 0, 0, p)).contiguous() if p else t.contiguous()
               for t, p in ((q, pq), (k, pk), (v, pk)))
    return launch.run(plan, q, k, v)[:, :sq]
