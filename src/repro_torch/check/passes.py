"""IR-level verifier passes over Workload / Schedule / Plan / NetworkGraph /
NetPlan.

Each pass is a pure function returning a list of `Diagnostic`s (never
raising): the paper's first-order model is only trustworthy when its
preconditions hold, and these passes prove them statically:

  * eq (1) feasibility and block/extent/group divisibility per schedule,
  * dtype-consistent edge traffic and words-vs-bytes unit discipline,
  * word conservation: a NetPlan's recorded totals must equal
    ``network_report`` recomputed over its own schedules and residency,
  * a residency-budget proof over the resident tensors' live intervals,
    the same accounting ``plan_graph``'s beam enforces, replayed
    independently.

All comparisons are exact: every recorded quantity in a `Plan`/`NetPlan` is
derived from integer arithmetic (or deterministic IEEE division), so any
drift is corruption, not noise. On every input the diagnostics' codes,
subjects and severities are the reference package's.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from repro_torch.check.diagnostics import Diagnostic
from repro_torch.plan import gemm_model, netplan as _netplan
from repro_torch.plan.api import Plan, default_budget
from repro_torch.plan.gemm_model import LANE, SUBLANE
from repro_torch.plan.graph import NetworkGraph
from repro_torch.plan.netplan import NetPlan
from repro_torch.plan.schedule import Schedule
from repro_torch.plan.traffic import TrafficReport, traffic_report
from repro_torch.plan.units import nbytes
from repro_torch.plan.workload import ConvWorkload, MatmulWorkload, Workload

_SUBLANE_TILE = SUBLANE * 16     # dse.LaneAligned's bm tile


def _widths(wl: MatmulWorkload) -> dict[str, int]:
    """A GEMM's element widths in bytes, by the reference's field names."""
    return dict(in_bytes=wl.in_dtype.itemsize, out_bytes=wl.out_dtype.itemsize,
                acc_bytes=wl.acc_dtype.itemsize)


# ----------------------------------------------------------------- workloads
def check_workload(wl: Workload, subject: Optional[str] = None
                   ) -> List[Diagnostic]:
    """RPC008 (malformed dims/widths) and RPC004 (group divisibility)."""
    subject = subject or getattr(wl, "name", type(wl).__name__)
    out: List[Diagnostic] = []
    if isinstance(wl, ConvWorkload):
        dims = dict(cin=wl.cin, cout=wl.cout, k=wl.k, wi=wl.wi, hi=wl.hi,
                    wo=wl.wo, ho=wl.ho, stride=wl.stride, groups=wl.groups,
                    word_bytes=wl.word_bytes)
        bad = {k: v for k, v in dims.items() if v < 1}
        if bad:
            out.append(Diagnostic("RPC008", subject,
                                  f"non-positive conv dimensions: {bad}"))
            return out
        if wl.cin % wl.groups or wl.cout % wl.groups:
            out.append(Diagnostic(
                "RPC004", subject,
                f"groups={wl.groups} does not divide cin={wl.cin} / "
                f"cout={wl.cout}"))
    elif isinstance(wl, MatmulWorkload):
        dims = dict(m=wl.m, n=wl.n, k=wl.k, **_widths(wl))
        bad = {k: v for k, v in dims.items() if v < 1}
        if bad:
            out.append(Diagnostic("RPC008", subject,
                                  f"non-positive GEMM dimensions: {bad}"))
    else:
        out.append(Diagnostic("RPC008", subject,
                              f"unknown workload type {type(wl).__name__}"))
    return out


# ----------------------------------------------------------------- schedules
def check_schedule(wl: Workload, schedule: Schedule,
                   budget: Optional[int] = None,
                   subject: Optional[str] = None) -> List[Diagnostic]:
    """Feasibility of one (workload, schedule) pair against its budget:
    RPC001 (eq 1), RPC002 (extents), RPC003 (kind), RPC005 (alignment),
    RPC006 (the planner's on-chip bytes; what a kernel body holds on the
    card is RPC032's, `repro_torch.check.kernels`). ``budget`` None is the
    port's default: P MACs, or one block's shared memory."""
    subject = subject or getattr(wl, "name", type(wl).__name__)
    out = check_workload(wl, subject)
    if any(d.code == "RPC008" for d in out):
        return out          # extents below would divide by garbage
    budget = default_budget(wl) if budget is None else int(budget)

    if isinstance(wl, ConvWorkload):
        if schedule.kind != "conv":
            out.append(Diagnostic(
                "RPC003", subject,
                f"conv workload scheduled with kind={schedule.kind!r}"))
            return out
        macs = wl.k * wl.k * schedule.bm * schedule.bn
        if macs > budget:
            out.append(Diagnostic(
                "RPC001", subject,
                f"K^2*m*n = {wl.k}^2*{schedule.bm}*{schedule.bn} = {macs} "
                f"> P = {budget}"))
        g = max(1, wl.groups)
        mg, ng = wl.cin // g, wl.cout // g
        if schedule.bm > mg or schedule.bn > ng:
            out.append(Diagnostic(
                "RPC002", subject,
                f"partition ({schedule.bm}, {schedule.bn}) exceeds per-group "
                f"channels ({mg}, {ng})"))
        if schedule.bk != 0:
            out.append(Diagnostic(
                "RPC002", subject,
                f"conv schedules never tile the reduction: bk={schedule.bk}"))
    elif isinstance(wl, MatmulWorkload):
        if schedule.kind != "matmul":
            out.append(Diagnostic(
                "RPC003", subject,
                f"matmul workload scheduled with kind={schedule.kind!r}"))
            return out
        held = schedule.vmem_bytes(workload=wl)
        if held > budget:
            out.append(Diagnostic(
                "RPC006", subject,
                f"block working set {held} B > on-chip budget {budget} B "
                f"(bm={schedule.bm}, bn={schedule.bn}, bk={schedule.bk})"))
        caps = (_round_up(wl.m, _SUBLANE_TILE), _round_up(wl.n, LANE),
                _round_up(wl.k, LANE))
        if (schedule.bm > caps[0] or schedule.bn > caps[1]
                or schedule.bk > caps[2]):
            out.append(Diagnostic(
                "RPC002", subject,
                f"blocks ({schedule.bm}, {schedule.bn}, {schedule.bk}) "
                f"exceed the padded GEMM dims {caps}"))
        if (schedule.bm % _SUBLANE_TILE or schedule.bn % LANE
                or schedule.bk % LANE):
            out.append(Diagnostic(
                "RPC005", subject,
                f"blocks ({schedule.bm}, {schedule.bn}, {schedule.bk}) are "
                f"not ({_SUBLANE_TILE}, {LANE}, {LANE})-aligned"))
    return out


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


# ------------------------------------------------------------------- traffic
def _words_equal(a: TrafficReport, b: TrafficReport) -> bool:
    return (a.interconnect_words == b.interconnect_words
            and a.input_words == b.input_words
            and a.output_words == b.output_words
            and a.sram_reads == b.sram_reads
            and a.sram_writes == b.sram_writes)


def check_traffic(wl: Workload, schedule: Schedule, report: TrafficReport,
                  subject: Optional[str] = None) -> List[Diagnostic]:
    """RPC007: recorded word counts must equal the analytical model under one
    of the two iteration conventions; RPC010: the bytes field must be the
    dtype-weighted image of the recorded words."""
    subject = subject or getattr(wl, "name", type(wl).__name__)
    out: List[Diagnostic] = []
    exact = traffic_report(wl, schedule, exact_iters=True)
    if not _words_equal(report, exact):
        words_ok = (isinstance(wl, ConvWorkload) and _words_equal(
            report, traffic_report(wl, schedule, exact_iters=False)))
        if not words_ok:
            out.append(Diagnostic(
                "RPC007", subject,
                f"recorded interconnect_words={report.interconnect_words!r} "
                f"!= model {exact.interconnect_words!r} (neither ceil nor "
                f"real-valued convention matches)"))
    if isinstance(wl, ConvWorkload):
        expect = nbytes(report.interconnect_words, wl.word_bytes)
        if report.bytes != expect:
            out.append(Diagnostic(
                "RPC010", subject,
                f"bytes={report.bytes!r} != interconnect_words * "
                f"word_bytes({wl.word_bytes}) = {expect!r}"))
    else:
        expect = gemm_model.traffic_model_bytes(
            wl.m, wl.n, wl.k, schedule, schedule.controller, **_widths(wl))
        if report.bytes != expect:
            out.append(Diagnostic(
                "RPC010", subject,
                f"bytes={report.bytes!r} != dtype-weighted GEMM model "
                f"{expect!r}"))
    return out


def check_plan(plan: Plan) -> List[Diagnostic]:
    """Full verification of one per-layer `Plan`."""
    subject = getattr(plan.workload, "name", "plan")
    out = check_schedule(plan.workload, plan.schedule, plan.budget, subject)
    out += check_traffic(plan.workload, plan.schedule, plan.traffic, subject)
    return out


# --------------------------------------------------------------------- graph
def _node_widths(wl: Workload) -> tuple[int, int]:
    """(input element width, output element width) a node's edges must carry."""
    if isinstance(wl, ConvWorkload):
        return wl.word_bytes, wl.word_bytes
    return wl.in_dtype.itemsize, wl.out_dtype.itemsize


def check_graph(graph: NetworkGraph) -> List[Diagnostic]:
    """Shape conservation (RPC013) and edge dtype consistency (RPC011) over
    every workload node, re-proved here because `NetworkGraph.tensors` is a
    plain dict a caller can mutate after construction."""
    out: List[Diagnostic] = []
    for node in graph.workload_nodes:
        wl = node.workload
        out += check_workload(wl, node.name)
        in_w, out_w = _node_widths(wl)
        missing = [t for t in node.ins if t not in graph.tensors]
        if missing or node.out not in graph.tensors:
            out.append(Diagnostic(
                "RPC013", node.name,
                f"references unknown tensors {missing + [node.out]}"))
            continue
        in_words = sum(graph.tensors[t].words for t in node.ins)
        out_t = graph.tensors[node.out]
        if isinstance(wl, ConvWorkload):
            want_in, want_out = wl.in_acts, wl.out_acts
        else:
            want_in, want_out = wl.m * wl.k, wl.m * wl.n
        if in_words != want_in:
            out.append(Diagnostic(
                "RPC013", node.name,
                f"input edges carry {in_words} words, workload reads "
                f"{want_in}"))
        if out_t.words != want_out:
            out.append(Diagnostic(
                "RPC013", node.name,
                f"output edge carries {out_t.words} words, workload writes "
                f"{want_out}"))
        for t in node.ins:
            if graph.tensors[t].word_bytes != in_w:
                out.append(Diagnostic(
                    "RPC011", node.name,
                    f"input tensor {t!r} is {graph.tensors[t].word_bytes} "
                    f"B/word, workload reads {in_w} B/word"))
        if out_t.word_bytes != out_w:
            out.append(Diagnostic(
                "RPC011", node.name,
                f"output tensor {node.out!r} is {out_t.word_bytes} B/word, "
                f"workload writes {out_w} B/word"))
    return out


# ------------------------------------------------------------------- netplan
def _residency_proof(netp: NetPlan) -> List[Diagnostic]:
    """Replay the live-interval accounting ``plan_graph``'s beam enforced:
    at each resident tensor's creation step, every live resident tensor
    (including inputs dying at that step, which the buffer still holds) plus
    the new output must fit ``residency_bytes``."""
    graph = netp.graph
    resident = netp.resident_tensors
    out: List[Diagnostic] = []
    last_use = {t: rng[1] for t, rng in graph.live_ranges().items()}
    live: set[str] = set()
    bytes_live = 0
    peak = 0
    for i, node in enumerate(graph.nodes):
        if node.out in resident:
            fp = bytes_live + graph.tensors[node.out].nbytes
            peak = max(peak, fp)
            if fp > netp.residency_bytes:
                out.append(Diagnostic(
                    "RPC020", node.out,
                    f"live resident set is {fp} B at step {i} "
                    f"({node.name}), budget {netp.residency_bytes} B"))
        dead = {t for t in live if last_use[t] <= i}
        bytes_live -= sum(graph.tensors[t].nbytes for t in dead)
        live -= dead
        if node.out in resident:
            live.add(node.out)
            bytes_live += graph.tensors[node.out].nbytes
    if peak != netp.peak_resident_bytes:
        out.append(Diagnostic(
            "RPC022", graph.name,
            f"recorded peak_resident_bytes={netp.peak_resident_bytes} != "
            f"recomputed {peak}"))
    return out


def check_netplan(netp: NetPlan) -> List[Diagnostic]:
    """Full verification of a planned network graph: graph invariants,
    per-node schedule feasibility + residency-adjusted traffic, edge
    units/residency discipline, word conservation of the recorded totals, and
    the live-interval residency-budget proof."""
    graph = netp.graph
    out = check_graph(graph)
    resident = netp.resident_tensors
    external = set(graph.inputs) | set(graph.outputs)

    schedules = netp.schedules
    for node in graph.workload_nodes:
        if node.name not in schedules or schedules[node.name] is None:
            out.append(Diagnostic(
                "RPC033", node.name, "workload node has no schedule"))
    planned = {np_.name: np_ for np_ in netp.nodes}
    for node in graph.workload_nodes:
        sched = schedules.get(node.name)
        if sched is None:
            continue
        wl = node.workload
        out += check_schedule(wl, sched, netp.budget, node.name)
        rec = planned.get(node.name)
        if rec is None or rec.traffic is None:
            continue
        spilled = sum(graph.tensors[t].words for t in node.ins
                      if t not in resident and t in graph.tensors)
        want = _netplan._node_bus_report(wl, sched, spilled,
                                         out_spilled=node.out not in resident)
        if not _words_equal(rec.traffic, want):
            out.append(Diagnostic(
                "RPC007", node.name,
                f"recorded node traffic {rec.traffic.interconnect_words!r} "
                f"words != residency-adjusted model "
                f"{want.interconnect_words!r}"))
        if rec.traffic.bytes != want.bytes:
            out.append(Diagnostic(
                "RPC010", node.name,
                f"recorded node bytes {rec.traffic.bytes!r} != model "
                f"{want.bytes!r}"))

    for e in netp.edges:
        t = graph.tensors.get(e.tensor)
        if t is None:
            out.append(Diagnostic("RPC013", e.tensor,
                                  "edge tensor missing from the graph"))
            continue
        if e.words != t.words:
            out.append(Diagnostic(
                "RPC013", e.tensor,
                f"edge records {e.words} words, tensor carries {t.words}"))
        if e.nbytes != nbytes(e.words, t.word_bytes):
            out.append(Diagnostic(
                "RPC010", e.tensor,
                f"edge nbytes={e.nbytes} != words * word_bytes = "
                f"{nbytes(e.words, t.word_bytes)}"))
        if e.resident and e.tensor in external:
            out.append(Diagnostic(
                "RPC021", e.tensor,
                "network input/output tensor held resident"))

    if all(s is not None for s in schedules.values()) and \
            len(schedules) == len(graph.workload_nodes):
        want_total = _netplan.network_report(graph, schedules, resident)
        if not _words_equal(netp.traffic, want_total):
            out.append(Diagnostic(
                "RPC012", graph.name,
                f"NetPlan total {netp.traffic.interconnect_words!r} words != "
                f"network_report {want_total.interconnect_words!r} over its "
                f"own schedules/residency"))
        elif netp.traffic.bytes != want_total.bytes:
            out.append(Diagnostic(
                "RPC010", graph.name,
                f"NetPlan total bytes {netp.traffic.bytes!r} != "
                f"network_report {want_total.bytes!r}"))

    out += _residency_proof(netp)
    return out


# ------------------------------------------------------------------ dispatch
def check(obj: object, budget: Optional[int] = None) -> List[Diagnostic]:
    """Dispatch on the IR object kind: Plan, NetPlan, NetworkGraph, Workload,
    a (workload, schedule) pair, a fleet of NetPlans (the list
    ``plan_graphs`` returns; diagnostics concatenated in fleet order), or a
    kernel's `LaunchPlan` (its geometry, `check.kernels.check_launch`)."""
    if isinstance(obj, Plan):
        return check_plan(obj)
    if isinstance(obj, NetPlan):
        return check_netplan(obj)
    if isinstance(obj, NetworkGraph):
        return check_graph(obj)
    if isinstance(obj, (ConvWorkload, MatmulWorkload)):
        return check_workload(obj)
    if isinstance(obj, tuple) and len(obj) == 2 \
            and isinstance(obj[1], Schedule):
        return check_schedule(obj[0], obj[1], budget)
    if isinstance(obj, (list, tuple)) and obj \
            and all(isinstance(p, NetPlan) for p in obj):
        return [d for p in obj for d in check_netplan(p)]
    if hasattr(obj, "grid") and hasattr(obj, "body"):    # a kernels.LaunchPlan
        from repro_torch.check.kernels import check_launch
        return check_launch(obj)
    raise TypeError(f"repro_torch.check cannot verify {type(obj).__name__}")


def summarize(diagnostics: Iterable[Diagnostic]) -> dict[str, int]:
    counts: dict[str, int] = {}
    for d in diagnostics:
        counts[d.code] = counts.get(d.code, 0) + 1
    return counts
