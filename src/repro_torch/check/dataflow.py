"""Word-count certificates: the port's launches move the words eqs (2)/(3)
charge.

The reference proves this by abstractly interpreting its Pallas kernel
bodies. A CUDA body has no such trace; what the port's launch does is
written down in its `LaunchPlan` (`repro_torch.kernels.launch`): the grid
(one thread block per output tile), the operands and their blocks, the loops
inside a block with their trip counts, and the launches of a call. This
module derives the word counts from those and holds them against the model:

  RPC040  two thread blocks of the grid write the same output tile
  RPC042  the grid leaves an output tile unwritten
  RPC043  the plan's loops do not give the accumulation chain the model
          assumes, or the chain's counts disagree with the meter's SRAM
          columns (`TrafficReport.sram_reads` / ``sram_writes``)
  RPC045  a model-level word count derived from the plan differs from
          `conv_traffic` / `gemm_model.matmul_traffic`

The counts live at two levels, and only the first is a proof:

  * **The model's level.** Conv: x crosses once per cout block (the
    output operand's blocks), the accumulator chain is the ``cin`` loop's
    trip count L (L x out_acts writes, (L - 1) x out_acts observing reads;
    passive B_o = (2L - 1) x out_acts, active L x out_acts). GEMM: x once
    per output-tile column and w once per row of the grid; passive C
    crosses device memory at each of the call's ``launches - packs`` =
    gk launches, (2 gk - 1) x M x N; active C once. These equal the model
    with ``==`` or RPC045 fires.
  * **The device's level**, `DeviceWords`: what the card's launches read
    and write, beside the model's count, the difference broken out (cin
    padded to the block or to a tensor-core step, the spatial halo and row
    pitch of a thread block's slab, reads by more or fewer thread blocks
    than the model's blocks, the pack pass). These are reported, never an
    error: a tc_bf16 thread block reads x once for up to 8 cout blocks
    (fewer words than B_i), a wide cout block split over thread blocks
    reads it more often; refusing such launches would refuse plans the
    reference runs.

The active GEMM's SRAM columns are certified against the schedule's gk, as
the model defines them: the ``cuda_core`` body's register accumulator walks
k in the schedule's bk blocks and realises them; the tensor-core bodies
walk k in chunks of ``TC_KC`` / ``TF_KC`` and have no bk-granular chain.

Flash attention is certified at the port's own granularity, not the
reference's: a thread block walks its kv range itself, and a causal block
stops at the last key its last row sees, so K and V words are at most
q tiles x BH x Skv x D and equal to it when not causal. (The reference's
proof charges K and V once per q block but its trace counts them once where
the kv block index never changes, so it fails at gk = 1 < gq; the port's
certificate does not copy that charge.)

`certify_conv_space` / `certify_matmul_space` certify whole search spaces:
one full proof per degeneracy class of the grid, then the counting
formulas as numpy arrays over every candidate.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.check.diagnostics import Diagnostic, errors, raise_on_error
from repro_torch.check.kernels import (check_conv_launch, check_flash_launch,
                                       check_matmul_launch, conv_plan,
                                       same_padded)
from repro_torch.kernels import conv2d_psum as _conv
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import psum_matmul as _matmul
from repro_torch.plan.schedule import Controller, Schedule
from repro_torch.plan.workload import ConvWorkload, MatmulWorkload


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= int(x)
    return out


def _mismatch(subject: str, what: str, derived, model) -> Diagnostic:
    return Diagnostic("RPC045", subject,
                      f"{what}: derived from the launch plan {derived} != "
                      f"model {model}")


@dataclasses.dataclass(frozen=True)
class DeviceWords:
    """One operand's words at the device's level beside the model's count.
    ``parts`` break ``device - model`` out by cause; they sum to it."""

    name: str
    model: int
    device: int
    parts: Tuple[Tuple[str, int], ...] = ()

    def __post_init__(self) -> None:
        if sum(v for _, v in self.parts) != self.device - self.model:
            raise ValueError(f"{self.name}: parts {self.parts} do not sum to "
                             f"{self.device} - {self.model}")


@dataclasses.dataclass(frozen=True)
class DataflowReport:
    """The certificate of one launch: diagnostics, the device-level words
    of each operand, and the accumulator chain's counts (the meter's SRAM
    columns)."""

    subject: str
    diagnostics: Tuple[Diagnostic, ...]
    words: Dict[str, DeviceWords]
    sram_reads: int = 0
    sram_writes: int = 0

    @property
    def ok(self) -> bool:
        return not errors(self.diagnostics)


def _cover(subject: str, what: str, grid: int, extent: int,
           share: int) -> List[Diagnostic]:
    """One grid axis against the output extent it tiles, ``share`` a block:
    more blocks than tiles write a tile twice (RPC040), fewer leave one
    unwritten (RPC042)."""
    tiles = -(-extent // share)
    if grid > tiles:
        return [Diagnostic("RPC040", subject,
                           f"{what}: {grid} thread blocks over {tiles} tiles "
                           f"of {share}; two blocks write one tile")]
    if grid < tiles:
        return [Diagnostic("RPC042", subject,
                           f"{what}: {grid} thread blocks cover {grid * share} "
                           f"of {extent}")]
    return []


# ------------------------------------------------------------ conv2d_psum
def _conv_grid(subject: str, plan, ho: int, wo: int) -> List[Diagnostic]:
    """RPC040/042 of a conv plan: the spatial tiles over every output
    position and the thread blocks along N over every output channel."""
    geo = plan.cuda.keywords["geo"]
    cout_p, bn = plan.outputs[0].array_shape[0], plan.outputs[0].block_shape[0]
    n_co = cout_p // bn
    if plan.body == "tc_bf16":
        out = _cover(subject, "positions", plan.grid[0], ho * wo,
                     _conv.TC_ROWS_M)
        if geo["n_split"] > 1:
            out += _cover(subject, "cout blocks", plan.grid[1],
                          n_co * geo["n_split"], 1)
            out += _cover(subject, "channels of a cout block", geo["n_split"],
                          bn, geo["nt"])
        else:
            out += _cover(subject, "cout blocks", plan.grid[1], n_co,
                          geo["cpb"])
        return out
    cols = -(-wo // _conv.CORE_R)
    out = _cover(subject, "output row runs", plan.grid[0], ho * cols, geo["ti"])
    per_co, rem = divmod(plan.grid[1], n_co)
    if rem:
        return out + [Diagnostic(
            "RPC042", subject, f"{plan.grid[1]} thread blocks along N over "
            f"{n_co} cout blocks")]
    return out + _cover(subject, "channels of a cout block", per_co, bn,
                        geo["gpb"] * _conv.CORE_NC)


def _conv_device_words(wl: ConvWorkload, plan, b_o: int
                       ) -> Dict[str, DeviceWords]:
    """x, w, out and the pack pass at the device's level (module doc),
    beside the model-level counts the plan gives (x once per cout block,
    ``b_o`` out)."""
    geo = plan.cuda.keywords["geo"]
    cin_p, hp, wp = plan.inputs[0].array_shape
    cout_p, ho, wo = plan.outputs[0].array_shape
    bm = plan.inputs[0].block_shape[0]
    n_co = cout_p // plan.outputs[0].block_shape[0]
    n_ci = cin_p // bm
    if plan.body == "tc_bf16":
        cin_dev, row = n_ci * geo["kg"] * _conv.TC_KG, wp
    else:
        cin_dev, row = cin_p, geo["pitch"]
    slab = geo["n_tiles"] * geo["rows_in"] * row      # one channel, all tiles
    readers = plan.grid[1]
    x = DeviceWords("x", wl.in_acts * n_co, cin_dev * slab * readers, (
        ("channel padding", (cin_dev - wl.cin) * slab * readers),
        ("halo and pitch", wl.cin * (slab - wl.hi * wl.wi) * readers),
        ("thread blocks along N", wl.in_acts * (readers - n_co))))
    w_dev = next(s.shape for s in plan.scratch if s.name == "w_packed")
    w_real = wl.cout * wl.cin * wl.k * wl.k
    w = DeviceWords("w", w_real, geo["n_tiles"] * _prod(w_dev), (
        ("padding", (_prod(w_dev) - w_real) * geo["n_tiles"]),
        ("spatial tiles", w_real * (geo["n_tiles"] - 1))))
    out = DeviceWords("out", b_o, cout_p * ho * wo, (
        ("channel padding", (cout_p - wl.cout) * ho * wo),
        ("partial sums kept on chip", wl.out_acts - b_o)))
    x_pack = next(s.shape for s in plan.scratch if s.name == "x_packed")
    pack_reads = cin_p * hp * wp + cout_p * cin_p * wl.k * wl.k
    pack_writes = _prod(x_pack) + _prod(w_dev)
    pack = DeviceWords("pack", 0, pack_reads + pack_writes,
                       (("reads", pack_reads), ("writes", pack_writes)))
    return {"x": x, "w": w, "out": out, "pack": pack}


def conv_dataflow(wl: ConvWorkload, schedule: Schedule,
                  subject: Optional[str] = None,
                  dtype: torch.dtype = torch.float32) -> DataflowReport:
    """Prove `conv2d_psum` under ``schedule`` (float32, the runner's type,
    unless ``dtype`` says otherwise) moves the words eqs (2)/(3) charge for
    ``wl`` at the model's level, and report its device-level words."""
    from repro_torch.plan.traffic import conv_traffic
    subject = subject or f"dataflow/{wl.name}"
    geo = check_conv_launch(wl, schedule, subject, dtype)
    if errors(geo):
        return DataflowReport(subject, tuple(geo), {})
    plan = conv_plan(wl, schedule, dtype)
    diags = geo + _conv_grid(subject, plan, wl.ho, wl.wo)
    model = conv_traffic(wl, schedule, exact_iters=True)
    axis, chain = plan.loops[0]
    if axis != "cin":
        diags.append(Diagnostic(
            "RPC043", subject,
            f"the outermost loop in a block is {axis!r}, not the cin walk"))
    n_co = plan.outputs[0].array_shape[0] // plan.outputs[0].block_shape[0]
    acc_w, acc_r = chain * wl.out_acts, (chain - 1) * wl.out_acts
    b_i = n_co * wl.in_acts
    if b_i != int(model.input_words):
        diags.append(_mismatch(subject, "B_i (eq 2) vs x once per cout block",
                               b_i, int(model.input_words)))
    b_o = acc_w if schedule.controller is Controller.ACTIVE else acc_w + acc_r
    if b_o != int(model.output_words):
        diags.append(_mismatch(subject, "B_o (eq 3) vs the cin chain",
                               b_o, int(model.output_words)))
    sram_r = b_i + acc_r
    if sram_r != int(model.sram_reads) or acc_w != int(model.sram_writes):
        diags.append(Diagnostic(
            "RPC043", subject,
            f"accumulator chain counts (reads {sram_r}, writes {acc_w}) "
            f"disagree with the meter ({int(model.sram_reads)}, "
            f"{int(model.sram_writes)})"))
    return DataflowReport(subject, tuple(diags),
                          _conv_device_words(wl, plan, b_o),
                          sram_reads=sram_r, sram_writes=acc_w)


# ---------------------------------------------------------- psum_matmul
def matmul_dataflow(wl: MatmulWorkload, schedule: Schedule,
                    subject: Optional[str] = None) -> DataflowReport:
    """Prove `psum_matmul` under ``schedule`` (the workload's operand type)
    moves the words `gemm_model.matmul_traffic` charges, for either
    controller, and report its device-level words."""
    from repro_torch.plan.gemm_model import matmul_traffic
    subject = subject or f"dataflow/{wl.name}/{schedule.controller.value}"
    geo = check_matmul_launch(wl.m, wl.k, wl.n, schedule, subject,
                              dtype=wl.in_dtype)
    if errors(geo):
        return DataflowReport(subject, tuple(geo), {})
    ctrl = schedule.controller
    plan = _matmul.matmul_launch_plan(m=wl.m, k=wl.k, n=wl.n, bm=schedule.bm,
                                      bn=schedule.bn, bk=schedule.bk,
                                      controller=ctrl.value, dtype=wl.in_dtype)
    (mp, kp), (_, bk) = plan.inputs[0].array_shape, plan.inputs[0].block_shape
    np_ = plan.inputs[1].array_shape[1]
    gn, gm = plan.grid
    diags = geo + _cover(subject, "output tile columns", gn, np_, schedule.bn)
    diags += _cover(subject, "output tile rows", gm, mp, schedule.bm)
    model = matmul_traffic(wl.m, wl.n, wl.k, schedule, ctrl)
    acc = wl.m * wl.n
    gk = kp // bk
    packs = int(any(s.where == "device" for s in plan.scratch))
    steps = plan.launches - packs
    if steps != (gk if ctrl is Controller.PASSIVE else 1):
        diags.append(Diagnostic(
            "RPC043", subject,
            f"{steps} launches a call for a {ctrl.value} GEMM of {gk} k-steps"))
    if ctrl is Controller.ACTIVE and plan.body == "cuda_core" \
            and plan.loops != (("k", gk),):
        diags.append(Diagnostic(
            "RPC043", subject,
            f"cuda_core's loops {plan.loops} are not the {gk} k-blocks"))
    c_d = (2 * steps - 1) * acc if ctrl is Controller.PASSIVE else acc
    for what, derived, want in (
            ("A reads vs x once per tile column", gn * wl.m * wl.k,
             model["a_reads"]),
            ("B reads vs w once per tile row", gm * wl.k * wl.n,
             model["b_reads"]),
            ("C traffic vs the launches' C round trips", c_d,
             model["c_traffic"])):
        if derived != int(want):
            diags.append(_mismatch(subject, what, derived, int(want)))
    acc_w, acc_r = gk * acc, (gk - 1) * acc
    split = 2 if plan.body == "tc_3xtf32" else 1     # hi and lo of each
    x = DeviceWords("x", gn * wl.m * wl.k, split * gn * mp * kp, (
        ("padding", gn * (mp * kp - wl.m * wl.k)),
        ("tf32 lo", (split - 1) * gn * mp * kp)))
    w = DeviceWords("w", gm * wl.k * wl.n, split * gm * kp * np_, (
        ("padding", gm * (kp * np_ - wl.k * wl.n)),
        ("tf32 lo", (split - 1) * gm * kp * np_)))
    trips = 2 * steps - 1 if ctrl is Controller.PASSIVE else 1
    out = DeviceWords("out", c_d, trips * mp * np_,
                      (("padding", trips * (mp * np_ - acc)),))
    words = {"x": x, "w": w, "out": out}
    if packs:
        reads, writes = mp * kp + kp * np_, 2 * (mp * kp + np_ * kp)
        words["pack"] = DeviceWords("pack", 0, reads + writes,
                                    (("reads", reads), ("writes", writes)))
    return DataflowReport(subject, tuple(diags), words,
                          sram_reads=acc_r, sram_writes=acc_w)


# ------------------------------------------------------- flash_attention
def _flash_walks(plan, *, skv: int, causal: bool, q_offset: int
                 ) -> List[Tuple[int, int, int, int]]:
    """[(blocks, rows, keys, tiles)]: the kv walks of a plan's thread
    blocks, each walk shared by ``blocks`` blocks of ``rows`` q rows that
    read ``keys`` keys in ``tiles`` tiles, as the CUDA source bounds them.
    A causal one-pass block stops at ``min(skv, q_offset + its last row +
    1)``; split s of split_kv walks its range of ``ceil(skv / splits)``
    keys, cut at ``q_offset + sq_p`` when causal, for all rows of a kv
    head."""
    bh, sq_p, d = plan.inputs[0].array_shape
    hkv, skv_p, _ = plan.inputs[1].array_shape
    d_run = _flash.built_head_dim(d)
    if plan.body == "split_kv":
        splits = plan.grid[0]
        split_len = -(-skv // splits)
        walks = []
        for s in range(splits):
            k_end = min(skv, (s + 1) * split_len)
            if causal:
                k_end = min(k_end, q_offset + sq_p)
            keys = max(0, k_end - s * split_len)
            walks.append((hkv, bh // hkv * sq_p, keys,
                          -(-keys // _flash.SPLIT_KT)))
        return walks
    if plan.body == "cuda_core":
        rows_per, kt = _flash.QT, 32 if d_run > 128 else 64
    elif plan.body == "tc_bf16":
        rows_per, kt = _flash.TC_QT, _flash.tc_keys(d_run)
    else:
        rows_per, kt = _flash.TC_QT, _flash.TF_KT
    walks = []
    for row0 in range(0, sq_p, rows_per):
        last = min(row0 + rows_per, sq_p)
        keys = min(skv, q_offset + last) if causal else skv
        walks.append((bh, last - row0, keys, -(-keys // kt)))
    return walks


def flash_dataflow(bh: int, sq: int, skv: int, d: int, bq: int = 128,
                   bk: int = 128, causal: bool = True, q_offset: int = 0,
                   subject: str = "dataflow/flash_attention",
                   kv_group: int = 1,
                   dtype: Optional[torch.dtype] = None) -> DataflowReport:
    """Certify `flash_attention`'s traffic at the port's granularity: Q and
    O cross device memory once; each thread block walks its own kv range,
    so K and V words are at most (blocks of a q tile) x Skv x D summed over
    the q tiles (split_kv: each kv head's keys once), equal when not
    causal; the softmax state (acc, m, l) does the (L, L - 1) chain over a
    block's L kv tiles in registers, and a tensor-core body's longest walk
    is the plan's ``kv`` loop. split_kv's partials cross device memory
    once to the combine (written and read once)."""
    geo = check_flash_launch(bh, sq, skv, d, bq, bk, causal, q_offset,
                             subject, kv_group=kv_group, dtype=dtype)
    if errors(geo):
        return DataflowReport(subject, tuple(geo), {})
    plan = _flash.flash_launch_plan(bh=bh, sq=sq, skv=skv, d=d, bq=bq, bk=bk,
                                    causal=causal, q_offset=q_offset,
                                    kv_group=kv_group, dtype=dtype)
    diags = list(geo)
    sq_p = plan.inputs[0].array_shape[1]
    walks = _flash_walks(plan, skv=skv, causal=causal, q_offset=q_offset)
    split = plan.body == "split_kv"
    # one-pass: the q tiles partition the rows; split_kv: every split holds
    # all rows of its kv head, and the combine writes each row once
    rows = walks[0][0] * walks[0][1] if split else sum(b * r for b, r, _, _ in walks)
    if rows != bh * sq_p:
        code = "RPC040" if rows > bh * sq_p else "RPC042"
        diags.append(Diagnostic(code, subject, f"thread blocks cover {rows} "
                                               f"q rows of {bh * sq_p}"))
    longest = max(t for _, _, _, t in walks)
    if plan.body in ("tc_bf16", "tc_3xtf32") and plan.loops[0] != ("kv", longest):
        diags.append(Diagnostic(
            "RPC043", subject,
            f"the plan's kv loop {plan.loops[0]} is not the longest walk, "
            f"{longest} tiles"))
    kv_words = d * sum(b * keys for b, _, keys, _ in walks)
    bound = d * skv * (walks[0][0] if split else sum(b for b, _, _, _ in walks))
    if kv_words > bound or (not causal and kv_words != bound):
        diags.append(_mismatch(subject, "K words vs one walk of Skv a block",
                               kv_words, bound))
    acc_w = d * sum(b * r * t for b, r, _, t in walks)
    acc_r = d * sum(b * r * max(0, t - 1) for b, r, _, t in walks)
    pad = bh * (sq_p - sq) * d
    words = {
        "q": DeviceWords("q", bh * sq * d, bh * sq_p * d, (("padding", pad),)),
        "k": DeviceWords("k", bound, kv_words,
                         (("causal keys skipped", kv_words - bound),)),
        "v": DeviceWords("v", bound, kv_words,
                         (("causal keys skipped", kv_words - bound),)),
        "out": DeviceWords("out", bh * sq * d, bh * sq_p * d,
                           (("padding", pad),)),
    }
    if split:
        part = sum(_prod(s.shape) for s in plan.scratch
                   if s.name in ("part_acc", "part_ml"))
        words["partials"] = DeviceWords(
            "partials", 0, 2 * part,
            (("written by pass 1", part), ("read by the combine", part)))
    return DataflowReport(subject, tuple(diags), words,
                          sram_reads=acc_r, sram_writes=acc_w)


# ------------------------------------------------- space-level certificates
@dataclasses.dataclass(frozen=True)
class SpaceCertificate:
    """One certified search space: every candidate's model-level word
    counts proven equal to the counting formulas the launch plans give.

    ``n_equal_hbm`` candidates read their operands from device memory the
    model's number of times (conv: one thread-block column per cout block;
    GEMM: blocks that divide the operands), ``n_bounded_hbm`` fewer times
    (a tc_bf16 thread block holding several cout blocks), ``n_exceeding``
    more (a cout block split over thread blocks, padded GEMM operands): a
    report, never an error. ``n_unlaunchable`` candidates are certified at
    the model's level but no kernel body takes them on the card (RPC032)."""

    subject: str
    kind: str
    controller: str
    n_candidates: int
    n_equal_hbm: int
    n_bounded_hbm: int
    diagnostics: Tuple[Diagnostic, ...]
    n_exceeding: int = 0
    n_unlaunchable: int = 0

    @property
    def ok(self) -> bool:
        return not errors(self.diagnostics)


def _degeneracy_classes(*flags: np.ndarray) -> List[np.ndarray]:
    """The candidate indices of every present degeneracy class (which grid
    extents are 1), in the order of their first member."""
    sig = np.zeros(flags[0].shape, dtype=np.int64)
    for i, f in enumerate(flags):
        sig |= f.astype(np.int64) << i
    firsts = sorted(int(np.argmax(sig == s)) for s in np.unique(sig))
    return [np.nonzero(sig == sig[i])[0] for i in firsts]


def _conv_readers(wl: ConvWorkload, bm: int, bn: int,
                  dtype: torch.dtype) -> Optional[int]:
    """Thread blocks along N that read x (the grid's second extent), or
    None where no body takes the launch."""
    sched = Schedule(kind="conv", bm=bm, bn=bn)
    if check_conv_launch(wl, sched, dtype=dtype):
        return None
    return conv_plan(wl, sched, dtype).grid[1]


def certify_conv_space(wl: ConvWorkload, budget: Optional[int] = None,
                       controller: "Controller | str" = Controller.PASSIVE,
                       space=None,
                       dtype: torch.dtype = torch.float32) -> SpaceCertificate:
    """Certify every candidate a conv search space admits for ``wl`` (all of
    `ConvExactSpace`'s by default): one full `conv_dataflow` per degeneracy
    class of the grid on a launchable candidate, then the counting formulas
    (x once per cout block, an (L, L - 1) chain over the cin blocks)
    against `conv_bandwidth_grid` for every candidate."""
    from repro_torch.plan.conv_model import conv_bandwidth_grid
    from repro_torch.plan.space import ConvExactSpace
    controller = Controller.coerce(controller)
    subject = f"certify/{wl.name}/{controller.value}"
    if budget is None:
        from repro_torch.plan.api import default_budget
        budget = default_budget(wl)
    if space is None:
        space = ConvExactSpace()
    if wl.groups != 1 or not same_padded(wl):
        why = (f"groups={wl.groups}" if wl.groups != 1
               else "not 'same'-padded")
        return SpaceCertificate(subject, "conv", controller.value, 0, 0, 0, (
            Diagnostic("RPC046", subject,
                       f"{why}: conv2d_psum never launches this node; "
                       f"space not kernel-certifiable"),))
    cands = space(wl, int(budget))
    m = np.asarray(cands.bm, np.int64)
    n = np.asarray(cands.bn, np.int64)
    bm_eff = np.maximum(1, np.minimum(m, wl.cin))
    bn_eff = np.maximum(1, np.minimum(n, wl.cout))
    n_ci = -(-wl.cin // bm_eff)
    n_co = -(-wl.cout // bn_eff)
    # x's readers depend on bn alone among the candidates' blocks
    readers = {int(b): _conv_readers(wl, 1, int(b), dtype)
               for b in np.unique(bn_eff)}
    launchable = np.asarray([readers[int(b)] is not None for b in bn_eff],
                            dtype=bool)
    diags: List[Diagnostic] = []
    for members in _degeneracy_classes(n_ci > 1, n_co > 1):
        ok = members[launchable[members]]
        i = int(ok[0]) if ok.size else int(members[0])
        rep = conv_dataflow(
            wl, Schedule(kind="conv", bm=int(m[i]), bn=int(n[i]),
                         controller=controller),
            subject=f"{subject}/m={int(m[i])},n={int(n[i])}", dtype=dtype)
        diags += [d for d in rep.diagnostics if ok.size or d.code != "RPC032"]
    if errors(diags):
        return SpaceCertificate(subject, "conv", controller.value,
                                len(cands), 0, 0, tuple(diags))
    b_i_d = (wl.in_acts * n_co).astype(np.float64)
    acc_w = (n_ci * wl.out_acts).astype(np.float64)
    acc_r = ((n_ci - 1) * wl.out_acts).astype(np.float64)
    b_o_d = acc_w if controller is Controller.ACTIVE else acc_w + acc_r
    b_i_m, b_o_m = conv_bandwidth_grid(wl, m, n, controller, exact_iters=True)
    for name, dv, mv in (("B_i (eq 2)", b_i_d, b_i_m),
                         ("B_o (eq 3)", b_o_d, b_o_m)):
        bad = np.nonzero(dv != mv)[0]
        if bad.size:
            i = int(bad[0])
            diags.append(_mismatch(
                f"{subject}/m={int(m[i])},n={int(n[i])}",
                f"{name} over the space ({bad.size} candidate(s))",
                dv[i], mv[i]))
    reads = np.asarray([readers[int(b)] or 0 for b in bn_eff], np.int64)
    equal = launchable & (reads == n_co)
    bounded = launchable & (reads < n_co)
    return SpaceCertificate(
        subject, "conv", controller.value, len(cands), int(equal.sum()),
        int(bounded.sum()), tuple(diags),
        n_exceeding=int((launchable & (reads > n_co)).sum()),
        n_unlaunchable=int((~launchable).sum()))


def certify_matmul_space(wl: MatmulWorkload, budget: Optional[int] = None,
                         controller: "Controller | str" = Controller.ACTIVE,
                         space=None) -> SpaceCertificate:
    """Certify every candidate of a GEMM block space that fits the budget
    (`dse.VmemBudget`; one block's shared memory by default) against
    `matmul_traffic_grid`, for either controller: one full
    `matmul_dataflow` per degeneracy class on a launchable candidate, then
    the counting formulas over all of them."""
    from repro_torch.plan.dse import VmemBudget
    from repro_torch.plan.gemm_model import SMEM_BUDGET, matmul_traffic_grid
    from repro_torch.plan.space import AlignedBlockSpace
    controller = Controller.coerce(controller)
    subject = f"certify/{wl.name}/{controller.value}"
    budget = SMEM_BUDGET if budget is None else int(budget)
    if space is None:
        space = AlignedBlockSpace()
    cands = space(wl, budget)
    admitted = VmemBudget()(wl, cands, budget)
    bm = np.asarray(cands.bm, np.int64)[admitted]
    bn = np.asarray(cands.bn, np.int64)[admitted]
    bk = np.asarray(cands.bk, np.int64)[admitted]
    if bm.size == 0:
        return SpaceCertificate(subject, "matmul", controller.value, 0, 0, 0, (
            Diagnostic("RPC046", subject,
                       "no candidate fits the on-chip budget"),))
    gi = -(-wl.m // bm)
    gj = -(-wl.n // bn)
    gk = -(-wl.k // bk)
    launchable = (bm <= _matmul.TILE) & (bn <= _matmul.TILE)
    diags: List[Diagnostic] = []
    for members in _degeneracy_classes(gi > 1, gj > 1, gk > 1):
        ok = members[launchable[members]]
        if not ok.size:
            continue             # the formulas below certify the class
        i = int(ok[0])
        rep = matmul_dataflow(
            wl, Schedule(kind="matmul", bm=int(bm[i]), bn=int(bn[i]),
                         bk=int(bk[i]), controller=controller),
            subject=f"{subject}/{int(bm[i])}x{int(bn[i])}x{int(bk[i])}")
        diags += list(rep.diagnostics)
    if errors(diags):
        return SpaceCertificate(subject, "matmul", controller.value,
                                int(bm.size), 0, 0, tuple(diags))
    t = matmul_traffic_grid(wl.m, wl.n, wl.k, bm, bn, bk, controller)
    a_d = (gj * (wl.m * wl.k)).astype(np.float64)
    b_d = (gi * (wl.k * wl.n)).astype(np.float64)
    acc = wl.m * wl.n
    if controller is Controller.ACTIVE:
        c_d = np.full_like(a_d, float(acc))
    else:
        c_d = ((2 * gk - 1) * acc).astype(np.float64)
    for name, dv, mv in (("A reads", a_d, t["a_reads"]),
                         ("B reads", b_d, t["b_reads"]),
                         ("C traffic", c_d, t["c_traffic"])):
        bad = np.nonzero(dv != mv)[0]
        if bad.size:
            i = int(bad[0])
            diags.append(_mismatch(
                f"{subject}/{int(bm[i])}x{int(bn[i])}x{int(bk[i])}",
                f"{name} over the space ({bad.size} candidate(s))",
                dv[i], mv[i]))
    exact = (wl.m % bm == 0) & (wl.n % bn == 0) & (wl.k % bk == 0)
    return SpaceCertificate(
        subject, "matmul", controller.value, int(bm.size),
        int((launchable & exact).sum()), 0, tuple(diags),
        n_exceeding=int((launchable & ~exact).sum()),
        n_unlaunchable=int((~launchable).sum()))


# ------------------------------------------------------ network-level gate
@functools.lru_cache(maxsize=4096)
def _conv_certificate(wl: ConvWorkload, schedule: Schedule,
                      dtype: torch.dtype) -> Tuple[Diagnostic, ...]:
    return conv_dataflow(wl, schedule, "node", dtype).diagnostics


@functools.lru_cache(maxsize=1024)
def _flash_certificate(bh, sq, skv, d, bq, bk, causal, q_offset, kv_group,
                       dtype) -> Tuple[Diagnostic, ...]:
    return flash_dataflow(bh, sq, skv, d, bq, bk, causal, q_offset,
                          kv_group=kv_group, dtype=dtype).diagnostics


def clear_certificate_cache() -> None:
    _conv_certificate.cache_clear()
    _flash_certificate.cache_clear()


def check_network_dataflow(graph, schedules,
                           dtype: torch.dtype = torch.float32
                           ) -> List[Diagnostic]:
    """Certify every conv node `run_network_kernels` would launch (cached
    per distinct launch geometry; nodes the launch checks refuse are
    theirs to report)."""
    if hasattr(schedules, "schedules"):
        schedules = schedules.schedules
    out: List[Diagnostic] = []
    for node in graph.workload_nodes:
        wl = node.workload
        sched = schedules.get(node.name) if schedules is not None else None
        if (not isinstance(wl, ConvWorkload) or sched is None
                or sched.kind != "conv" or wl.groups != 1
                or not same_padded(wl)):
            continue
        found = _conv_certificate(dataclasses.replace(wl, name=""), sched,
                                  dtype)
        out += [dataclasses.replace(d, subject=node.name) for d in found]
    return out


def preflight_flash_dataflow(bh: int, sq: int, skv: int, d: int,
                             bq: int = 128, bk: int = 128,
                             causal: bool = True, q_offset: int = 0,
                             kv_group: int = 1,
                             dtype: Optional[torch.dtype] = None) -> None:
    """Raise `CheckError` if the flash launch fails its certificate (cached
    per geometry; `flash_attention` calls it before building its plan)."""
    raise_on_error(_flash_certificate(bh, sq, skv, d, bq, bk, causal,
                                      q_offset, kv_group, dtype),
                   context="flash_attention dataflow proof failed")


# ------------------------------------------------------------- CLI sweep
def check_dataflow(nets: Sequence[str] = ("resnet18",),
                   controllers: Sequence[str] = ("passive", "active"),
                   ) -> Tuple[List[Diagnostic], dict]:
    """The ``python -m repro_torch.check --dataflow`` sweep: (1) one
    representative launch of each kernel, (2) the full `ConvExactSpace` of
    every launchable conv layer of each net under both controllers, (3)
    a 4096^3 GEMM's `AlignedBlockSpace` at one block's shared memory under
    both controllers. Returns (diagnostics, {subject: seconds}) with the
    certified candidates under ``"_certified"``."""
    from repro_torch.plan.workload import conv_workloads
    diags: List[Diagnostic] = []
    timings: dict = {}
    n_cand = 0

    t0 = time.time()
    diags += conv_dataflow(
        ConvWorkload(name="conv64", cin=64, cout=128, k=3, wi=16, hi=16,
                     wo=16, ho=16),
        Schedule(kind="conv", bm=32, bn=32,
                 controller=Controller.PASSIVE)).diagnostics
    for ctrl in ("active", "passive"):
        diags += matmul_dataflow(
            MatmulWorkload(m=512, n=512, k=1024),
            Schedule(kind="matmul", bm=128, bn=128, bk=256,
                     controller=Controller.coerce(ctrl))).diagnostics
    diags += flash_dataflow(2, 256, 256, 64).diagnostics
    diags += flash_dataflow(2, 1, 256, 64, bq=1, q_offset=255).diagnostics
    timings["kernels"] = time.time() - t0

    for net in nets:
        t0 = time.time()
        for wl in conv_workloads(net):
            if wl.groups != 1 or not same_padded(wl):
                continue          # the runner never launches it
            for ctrl in controllers:
                cert = certify_conv_space(wl, controller=ctrl)
                diags += cert.diagnostics
                n_cand += cert.n_candidates
        timings[f"space/{net}"] = time.time() - t0

    t0 = time.time()
    for ctrl in controllers:
        cert = certify_matmul_space(MatmulWorkload(m=4096, n=4096, k=4096),
                                    controller=ctrl)
        diags += cert.diagnostics
        n_cand += cert.n_candidates
    timings["space/gemm"] = time.time() - t0
    timings["_certified"] = n_cand
    return diags, timings

