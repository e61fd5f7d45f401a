"""Launch pre-flight: prove a kernel launch's geometry before anything runs.

The reference re-derives its Pallas BlockSpecs and evaluates their index
maps. The port's kernels describe each launch as a `LaunchPlan`
(`repro_torch.kernels.launch`): grid, threads, shared memory, the loops
inside a block, the padded operands and their blocks. This module builds the
plan the wrapper would build (`conv_launch_plan`, `matmul_launch_plan`,
`flash_launch_plan`) and checks it as data:

  RPC030  a block does not divide its padded operand
  RPC031  an empty grid, a block whose rank is not its operand's, or a
          launch the kernel does not take (a grouped or not "same"-padded
          conv, a degenerate attention shape, ...)
  RPC032  the plan's shared memory exceeds one block's
          (`repro_torch.plan.SMEM_BUDGET`), a GEMM's register tile
          exceeds `psum_matmul.TILE`, or no conv body holds the launch
  RPC033  a conv node without a schedule or weights

RPC032 bounds what a block holds on the card, not the planner's working
set: RPC006 (`check.passes`) checks the planner's bytes
(`Schedule.vmem_bytes`). The two differ: a 128 x 128 x 128 bf16 block is
196,608 B to the planner, while the card's tc_bf16 block stages 99,376 B of
k-chunks and keeps its accumulator in registers; a 128 x 256 active plan
passes RPC006 at twice one block's shared memory and fails RPC032.

Every check is a function of plain integers: the network gate
(`preflight_network_kernels`) caches each node's result per launch
geometry, so a walk after the first pays only for the dictionary lookups.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, List, Mapping, Optional

import torch

from repro_torch.check.diagnostics import Diagnostic, errors, raise_on_error
from repro_torch.kernels import conv2d_psum as _conv
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import psum_matmul as _matmul
from repro_torch.kernels.launch import LaunchPlan
from repro_torch.obs.trace import span
from repro_torch.plan.gemm_model import SMEM_BUDGET
from repro_torch.plan.schedule import Schedule
from repro_torch.plan.workload import ConvWorkload


def check_launch(plan: LaunchPlan, subject: Optional[str] = None,
                 smem_budget: Optional[int] = None) -> List[Diagnostic]:
    """RPC031 (empty grid, rank), RPC030 (divisibility), RPC032 (shared
    memory) over one `LaunchPlan`."""
    subject = subject or plan.name
    budget = SMEM_BUDGET if smem_budget is None else int(smem_budget)
    out: List[Diagnostic] = []
    if not plan.grid or any(g < 1 for g in plan.grid) or plan.launches < 1:
        out.append(Diagnostic(
            "RPC031", subject,
            f"empty grid {plan.grid} ({plan.launches} launches)"))
        return out
    for op in plan.inputs + plan.outputs:
        if len(op.block_shape) != len(op.array_shape):
            out.append(Diagnostic(
                "RPC031", subject,
                f"{op.name}: block rank {len(op.block_shape)} != array rank "
                f"{len(op.array_shape)}"))
        elif any(b < 1 for b in op.block_shape):
            out.append(Diagnostic(
                "RPC030", subject,
                f"{op.name}: non-positive block {op.block_shape}"))
        elif any(a % b for a, b in zip(op.array_shape, op.block_shape)):
            out.append(Diagnostic(
                "RPC030", subject,
                f"{op.name}: block {op.block_shape} does not divide the "
                f"padded array {op.array_shape}"))
    if plan.smem_bytes > budget:
        out.append(Diagnostic(
            "RPC032", subject,
            f"{plan.body} block holds {plan.smem_bytes} B of shared memory "
            f"> budget {budget} B"))
    return out


# ------------------------------------------------------------ conv2d_psum
def same_padded(wl: ConvWorkload) -> bool:
    """Whether the runner's "same" padding (K // 2) gives the workload's
    output shape, the only convs `run_network_kernels` launches."""
    pad = wl.k // 2
    return ((wl.hi + 2 * pad - wl.k) // wl.stride + 1 == wl.ho
            and (wl.wi + 2 * pad - wl.k) // wl.stride + 1 == wl.wo)


def conv_plan(wl: ConvWorkload, schedule: Schedule,
              dtype: torch.dtype = torch.float32) -> LaunchPlan:
    """The `conv_launch_plan` the runner builds for one node: its input
    channel-concatenated and "same"-padded, the schedule's blocks."""
    pad = wl.k // 2
    return _conv.conv_launch_plan(cin=wl.cin, hp=wl.hi + 2 * pad,
                                  wp=wl.wi + 2 * pad, cout=wl.cout, kk=wl.k,
                                  stride=wl.stride, block_m=schedule.m,
                                  block_n=schedule.n, dtype=dtype)


def check_conv_launch(wl: ConvWorkload, schedule: Schedule,
                      subject: Optional[str] = None,
                      dtype: torch.dtype = torch.float32,
                      smem_budget: Optional[int] = None) -> List[Diagnostic]:
    """Pre-flight one conv node as `run_network_kernels` would launch it
    (float32 by default, the runner's type). Admits exactly the launches
    `conv_launch_plan` builds for a dense "same"-padded node."""
    subject = subject or getattr(wl, "name", _conv.NAME)
    if schedule.kind != "conv":
        return [Diagnostic(
            "RPC003", subject,
            f"needs a conv schedule, got {schedule}")]
    if wl.groups != 1:
        return [Diagnostic(
            "RPC031", subject,
            f"groups={wl.groups}; the runner executes dense convs only")]
    if not same_padded(wl):
        return [Diagnostic("RPC031", subject,
                           "not 'same'-padded; shrink() first")]
    pad = wl.k // 2
    refusal = _conv.conv_refusal(cin=wl.cin, hp=wl.hi + 2 * pad,
                                 wp=wl.wi + 2 * pad, cout=wl.cout, kk=wl.k,
                                 stride=wl.stride, block_m=schedule.m,
                                 block_n=schedule.n, dtype=dtype)
    if refusal:
        return [Diagnostic("RPC032", subject, refusal)]
    return check_launch(conv_plan(wl, schedule, dtype), subject, smem_budget)


# ------------------------------------------------------------ psum_matmul
def check_matmul_launch(m: int, k: int, n: int, schedule: Schedule,
                        subject: str = "psum_matmul",
                        dtype: Optional[torch.dtype] = None,
                        smem_budget: Optional[int] = None
                        ) -> List[Diagnostic]:
    """Pre-flight one `psum_matmul` launch: the plan's geometry, and the
    register tile every body keeps its accumulator in (bm, bn <= TILE),
    which `_matmul_cuda` would refuse. ``dtype`` None is float32."""
    if schedule.kind != "matmul":
        return [Diagnostic(
            "RPC003", subject,
            f"kernel launch for a GEMM needs kind='matmul', got "
            f"{schedule.kind!r}")]
    plan = _matmul.matmul_launch_plan(
        m=m, k=k, n=n, bm=schedule.bm, bn=schedule.bn, bk=schedule.bk,
        controller=schedule.controller.value, dtype=dtype)
    out = check_launch(plan, subject, smem_budget)
    if schedule.bm > _matmul.TILE or schedule.bn > _matmul.TILE:
        out.append(Diagnostic(
            "RPC032", subject,
            f"register tile {schedule.bm} x {schedule.bn} exceeds the "
            f"kernel's {_matmul.TILE} x {_matmul.TILE}; plan with the card's "
            f"shared-memory budget"))
    return out


# --------------------------------------------------------- flash_attention
def check_flash_launch(bh: int, sq: int, skv: int, d: int, bq: int = 128,
                       bk: int = 128, causal: bool = True, q_offset: int = 0,
                       subject: str = "flash_attention", kv_group: int = 1,
                       dtype: Optional[torch.dtype] = None,
                       smem_budget: Optional[int] = None,
                       device_pos: bool = False) -> List[Diagnostic]:
    """Pre-flight one attention launch: the shapes the kernels take (RPC031:
    a degenerate shape, padded keys without the causal mask that hides
    them, a negative causal offset, q heads not a multiple of kv heads),
    then the plan's geometry. A device position (``device_pos``) pads no
    key and is not known on the host: its shape alone is checked."""
    out: List[Diagnostic] = []
    if min(bh, sq, skv, d, kv_group) < 1:
        return [Diagnostic(
            "RPC031", subject,
            f"degenerate attention shape bh={bh} sq={sq} skv={skv} d={d}")]
    if device_pos:
        return out
    bk_eff = max(1, min(bk, skv))
    if skv % bk_eff and not causal:
        out.append(Diagnostic(
            "RPC031", subject,
            f"skv={skv} is not a multiple of bk={bk_eff} and causal=False: "
            f"padded keys are masked by the causal mask only; pad kv to a "
            f"block multiple or use causal masking"))
    if causal and q_offset < 0:
        out.append(Diagnostic(
            "RPC031", subject,
            f"negative q_offset={q_offset} puts query ids before key id 0"))
    if bh % kv_group:
        out.append(Diagnostic(
            "RPC031", subject, f"{bh} q heads over groups of {kv_group}"))
    if out:
        return out
    plan = _flash.flash_launch_plan(bh=bh, sq=sq, skv=skv, d=d, bq=bq, bk=bk,
                                    causal=causal, q_offset=q_offset,
                                    kv_group=kv_group, dtype=dtype)
    return check_launch(plan, subject, smem_budget)


def preflight_flash_launch(bh: int, sq: int, skv: int, d: int, bq: int = 128,
                           bk: int = 128, causal: bool = True,
                           q_offset: int = 0, kv_group: int = 1,
                           dtype: Optional[torch.dtype] = None,
                           device_pos: bool = False) -> None:
    """Raise `CheckError` on any RPC03x error of one attention launch."""
    raise_on_error(check_flash_launch(bh, sq, skv, d, bq, bk, causal,
                                      q_offset, kv_group=kv_group,
                                      dtype=dtype, device_pos=device_pos),
                   context="flash_attention pre-flight failed")


# ------------------------------------------------------- whole-network gate
@functools.lru_cache(maxsize=4096)
def _node_launch(wl: ConvWorkload, schedule: Schedule,
                 dtype: torch.dtype) -> tuple[Diagnostic, ...]:
    """`check_conv_launch` of one node's geometry (its name stripped), the
    unit the network gate caches."""
    return tuple(check_conv_launch(wl, schedule, "node", dtype))


def clear_preflight_cache() -> None:
    """Forget every cached launch check and dataflow certificate, so the
    next walk pays the pre-flight in full (as a process's first does)."""
    _node_launch.cache_clear()
    from repro_torch.check import dataflow
    dataflow.clear_certificate_cache()


def _prefixed(d: Diagnostic, subject: str) -> Diagnostic:
    """A cached node diagnostic given back its node: the subject, and the
    "<node>: " lead of the runner's messages."""
    return dataclasses.replace(d, subject=subject,
                               message=f"{subject}: {d.message}")


def check_network_kernels(graph, schedules: Any,
                          params: Optional[Mapping[str, object]] = None,
                          inputs: Optional[Mapping[str, object]] = None,
                          dtype: torch.dtype = torch.float32
                          ) -> List[Diagnostic]:
    """Pre-flight every conv node `run_network_kernels` would launch.

    ``schedules`` is a NetPlan or a {node name: Schedule} mapping, exactly
    as the runner takes it. RPC033 for a node with no schedule (or, when
    ``params`` is given, no weights); RPC031 for weights or an input whose
    shape disagrees with the graph; RPC003/030/031/032 from the node's
    launch (`check_conv_launch`, cached per geometry). Each message leads
    with its node (``"<node>: ..."``), as the runner's refusals did.
    """
    if hasattr(schedules, "schedules"):      # a NetPlan
        schedules = schedules.schedules
    out: List[Diagnostic] = []
    for name, value in (inputs or {}).items():
        t = graph.tensors.get(name)
        if t is None or tuple(value.shape) != (t.channels, t.h, t.w):
            want = None if t is None else (t.channels, t.h, t.w)
            out.append(Diagnostic(
                "RPC031", name,
                f"input tensor {name}: shaped {tuple(value.shape)}, graph "
                f"needs {want}"))
    for node in graph.workload_nodes:
        wl = node.workload
        sched = schedules.get(node.name) if schedules is not None else None
        if sched is None:
            out.append(Diagnostic(
                "RPC033", node.name,
                f"{node.name}: conv node has no schedule"))
        else:
            key = dataclasses.replace(wl, name="")
            out += [_prefixed(d, node.name)
                    for d in _node_launch(key, sched, dtype)]
        if params is None:
            continue
        wt = params.get(node.name)
        want = (wl.cout, wl.cin, wl.k, wl.k)
        if wt is None:
            out.append(Diagnostic(
                "RPC033", node.name,
                f"{node.name}: conv node has no weights"))
        elif tuple(wt.shape) != want:
            out.append(Diagnostic(
                "RPC031", node.name,
                f"{node.name}: weights shaped {tuple(wt.shape)}, workload "
                f"needs {want}"))
    return out


def preflight_network_kernels(graph, schedules: Any,
                              params: Optional[Mapping[str, object]] = None,
                              inputs: Optional[Mapping[str, object]] = None,
                              dataflow: bool = True,
                              dtype: torch.dtype = torch.float32) -> None:
    """The gate `run_network_kernels` calls before its first launch: raises
    `CheckError` (a `ValueError`) listing every RPC03x/RPC04x error.

    With ``dataflow`` (the default) every node's launch is also certified
    by `repro_torch.check.dataflow` (the eq (2)/(3) word counts from the
    LaunchPlan, the grid's race and coverage proofs), cached per launch
    geometry like the launch checks: a graph's first walk pays for them,
    later walks look them up. The gate is spanned as ``kernel.preflight``
    (attributes ``graph``, ``dataflow`` and ``diagnostics``, the count of
    findings).
    """
    with span("kernel.preflight", cat="kernel", graph=graph.name,
              dataflow=dataflow) as sp:
        found = check_network_kernels(graph, schedules, params, inputs, dtype)
        if dataflow and not errors(found):
            from repro_torch.check.dataflow import check_network_dataflow
            found += check_network_dataflow(graph, schedules, dtype)
        sp.set("diagnostics", len(found))
        raise_on_error(found, context="network plan rejected before launch")
