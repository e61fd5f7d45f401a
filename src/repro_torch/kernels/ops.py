"""Public wrappers around the kernels: schedules come from the planner
(`repro_torch.plan`) and padding/layout is handled here, so callers see plain
tensor ops. They run on the device of the tensors they are given."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch import plan as _plan
from repro_torch.kernels import conv2d_psum as _conv
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import psum_matmul as _mm
from repro_torch.plan import gemm_model as _gemm


def matmul_schedule(m: int, k: int, n: int, *, controller: str = "active",
                    vmem_budget: int | None = None) -> _plan.Schedule:
    """The GEMM schedule `matmul` runs: the planner's exhaustive blocks under
    the budget (the bytes one block may hold on chip; default one H100
    block's shared memory), clamped to the rounded-up problem so tiny
    shapes keep tiny grids."""
    wl = _plan.MatmulWorkload(m=m, n=n, k=k)
    sched = _gemm.plan_gemm(
        wl, vmem_budget if vmem_budget is not None else _plan.SMEM_BUDGET,
        _plan.Strategy.EXHAUSTIVE_VMEM, _plan.Controller.coerce(controller),
        max_block=512)
    return dataclasses.replace(
        sched, bm=min(sched.bm, _round_up(m, 8)),
        bn=min(sched.bn, _round_up(n, 128)),
        bk=min(sched.bk, _round_up(k, 128)))


def matmul(x: torch.Tensor, w: torch.Tensor, *, act: str = "none",
           controller: str = "active",
           vmem_budget: int | None = None) -> torch.Tensor:
    """Partial-sum-scheduled GEMM with planner-chosen blocks
    (`matmul_schedule`); `psum_matmul` picks the kernel body from the
    blocks and the operands' dtype."""
    sched = matmul_schedule(x.shape[0], x.shape[1], w.shape[1],
                            controller=controller, vmem_budget=vmem_budget)
    return _mm.psum_matmul(x, w, schedule=sched, act=act)


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
           pad: int | None = None, p_macs: int = 2048,
           strategy: str = "paper_opt", act: str = "none") -> torch.Tensor:
    """Partitioned conv2d for one image. x: (Cin, H, W), w: (Cout, Cin, K, K).
    The (m, n) channel schedule comes from the paper's strategy at `p_macs`."""
    cin, h, _ = x.shape
    cout, _, kk, _ = w.shape
    pad = kk // 2 if pad is None else pad
    if pad:
        x = F.pad(x, (pad, pad, pad, pad))
    hp = h + 2 * pad
    ho = (hp - kk) // stride + 1
    wl = _plan.ConvWorkload(name="op", cin=cin, cout=cout, k=kk, wi=h, hi=h,
                            wo=ho, ho=ho, stride=stride)
    # The kernel's on-chip accumulator is the active controller.
    sched = _plan.plan(wl, p_macs, strategy, "active").schedule
    return _conv.conv2d_psum(x, w, schedule=sched, stride=stride, act=act)


def gqa_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        q_offset: int | torch.Tensor = 0,
                        kv_valid_len: torch.Tensor | None = None,
                        bq: int = 128, bk: int = 128) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k: (B, Hkv, Skv, D); v: (B, Hkv, Skv, Dv) with
    Dv <= D and Hq % Hkv == 0. Query head h reads kv head h // (Hq / Hkv)
    inside the kernel (the reference repeats the kv heads; the result is
    the same). ``q_offset`` and ``kv_valid_len`` as in the reference's
    ``chunked_attention``: as 0-d tensors on the device they are read
    there, and k and v (a head-major cache, contiguous) reach the kernel as
    (B Hkv, Skv, D) views, with no copy.

    A v narrower than q and k (MLA's expanded form: D 192, Dv 128) is
    zero-padded to D for the kernel, which takes v as wide as k, and the
    output is sliced back to Dv: the zero columns of v only add zero
    columns to the output, so the result is exact.

    A non-causal call whose Skv the kernel would pad (longer than a kv
    block and not a multiple of it: an encoder's or a cross-attention's
    ragged length) runs as a causal one with ``q_offset = Skv``: every
    query then sees every real key, and the causal launch's mask hides the
    padded ones (``k_ids < skv``), which a non-causal launch refuses to
    pad (RPC031). Returns (B, Hq, Sq, Dv)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[-1]
    if hq % hkv or dv > d:
        raise ValueError(f"gqa_flash_attention: {hq} q heads over {hkv} kv "
                         f"heads, v {dv} wide for q and k of {d}")
    device_pos = isinstance(q_offset, torch.Tensor) or kv_valid_len is not None
    if not causal and not device_pos and skv % min(bk, skv):
        causal, q_offset = True, skv
    if dv < d:
        v = F.pad(v, (0, d - dv))
    out = _flash.flash_attention(
        q.reshape(b * hq, sq, d), k.reshape(b * hkv, skv, d),
        v.reshape(b * hkv, skv, d), causal=causal, q_offset=q_offset,
        kv_valid_len=kv_valid_len, bq=bq, bk=bk)
    return out.reshape(b, hq, sq, d)[..., :dv]
