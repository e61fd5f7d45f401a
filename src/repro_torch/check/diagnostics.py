"""Diagnostic vocabulary of the port's static plan and launch verifier.

Every check in `repro_torch.check` reports through one currency: a
`Diagnostic` carrying a **stable error code** (``RPC0xx`` for the IR-level
verifier, ``RPC03x`` for the launch pre-flight, ``RPC04x`` for the
word-count certificates, ``RPL1xx`` for the codebase lint), a severity, the
subject it fired on (a workload/node/tensor name), a human message and a fix
hint. The registry (`CODES`) holds the same codes, slugs, severities and
summaries as the reference package's, so a diagnostic means the same thing
in both; some hints name the port's modules instead.

``raise_on_error`` escalates error-severity diagnostics into a `CheckError`
(a `ValueError`), the exception the ``checked=True`` planning modes and the
kernel pre-flight raise before anything runs.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Optional, Sequence


class Severity(enum.Enum):
    ERROR = "error"
    WARNING = "warning"

    def __str__(self) -> str:
        return self.value


@dataclasses.dataclass(frozen=True)
class CodeInfo:
    """One registered diagnostic code: identity, default severity, fix hint."""

    code: str
    slug: str                 # short kebab-case name, e.g. "mac-budget-exceeded"
    severity: Severity
    summary: str              # one-line description for the code table
    hint: str                 # generic "how to fix" guidance


CODES: dict[str, CodeInfo] = {}


def _register(code: str, slug: str, severity: Severity, summary: str,
              hint: str) -> None:
    if code in CODES:
        raise ValueError(f"diagnostic code {code} registered twice")
    CODES[code] = CodeInfo(code=code, slug=slug, severity=severity,
                           summary=summary, hint=hint)


# --- IR-level verifier: Workload / Schedule / Plan -------------------------
_register("RPC001", "mac-budget-exceeded", Severity.ERROR,
          "conv schedule violates eq (1): K^2 * m * n exceeds the MAC budget P",
          "shrink the (m, n) channel partition or raise the budget")
_register("RPC002", "block-exceeds-extent", Severity.ERROR,
          "a schedule block is larger than the workload axis it tiles",
          "clamp blocks to the per-group channel counts / GEMM dims")
_register("RPC003", "schedule-kind-mismatch", Severity.ERROR,
          "schedule kind does not match the workload kind",
          "plan conv workloads with kind='conv' schedules and GEMMs with "
          "kind='matmul'")
_register("RPC004", "group-indivisible", Severity.ERROR,
          "groups do not divide the conv channel counts",
          "use cin % groups == 0 and cout % groups == 0 workloads")
_register("RPC005", "lane-misaligned", Severity.WARNING,
          "GEMM blocks are not MXU lane/sublane-tile multiples",
          "align bm to 128-row tiles and bn/bk to 128 lanes "
          "(repro_torch.plan.dse.LaneAligned)")
_register("RPC006", "vmem-budget-exceeded", Severity.ERROR,
          "the GEMM block working set does not fit the VMEM byte budget",
          "shrink (bm, bn, bk) or disable double buffering")
_register("RPC007", "traffic-mismatch", Severity.ERROR,
          "a Plan's recorded word counts disagree with the analytical model",
          "recompute with repro_torch.plan.traffic.traffic_report; do not edit "
          "TrafficReport fields by hand")
_register("RPC008", "workload-malformed", Severity.ERROR,
          "workload has non-positive dimensions or element widths",
          "check the adapter that built the workload")

# --- IR-level verifier: units / graph / residency --------------------------
_register("RPC010", "words-bytes-mix", Severity.ERROR,
          "a words quantity and a bytes quantity disagree by the dtype width",
          "bytes must equal words * word_bytes (conv) or the dtype-weighted "
          "GEMM byte model; never add words to bytes")
_register("RPC011", "edge-dtype-mismatch", Severity.ERROR,
          "an edge tensor's element width disagrees with its workload's dtype",
          "build graphs with one word_bytes per dataflow path (see "
          "NetworkGraph.from_cnn(word_bytes=...))")
_register("RPC012", "word-conservation", Severity.ERROR,
          "NetPlan totals disagree with network_report over its own "
          "schedules and residency",
          "recompute with repro_torch.plan.netplan.network_report; totals are "
          "derived, not free fields")
_register("RPC013", "graph-shape-mismatch", Severity.ERROR,
          "node input/output tensor words disagree with its workload shape",
          "edge words must equal the workload's in_acts/out_acts (conv) or "
          "M*K / M*N (GEMM)")
_register("RPC020", "residency-overlap", Severity.ERROR,
          "live resident tensors overflow the residency byte budget at some "
          "step",
          "spill an edge or raise residency_bytes; intervals are "
          "[producing step, last consuming step]")
_register("RPC021", "non-residable-resident", Severity.ERROR,
          "a network input/output tensor is marked resident",
          "external data must cross the bus; only interior edges can fuse")
_register("RPC022", "peak-resident-mismatch", Severity.WARNING,
          "NetPlan.peak_resident_bytes disagrees with the recomputed live "
          "intervals",
          "recompute the peak from the resident set's live ranges")

# --- kernel launch checks (the reference's Pallas BlockSpecs; the port's
#     LaunchPlans, repro_torch.check.kernels) --------------------------------
_register("RPC030", "blockspec-indivisible", Severity.ERROR,
          "a BlockSpec block shape does not tile the (padded) array shape",
          "block dims must be >= 1 and divide the padded array dims")
_register("RPC031", "blockspec-out-of-range", Severity.ERROR,
          "an index map addresses a block beyond the array bounds, or the "
          "operand shapes are inconsistent",
          "check the operand shapes against the workload and the grid "
          "against the index maps")
_register("RPC032", "kernel-vmem-exceeded", Severity.ERROR,
          "the per-grid-step VMEM footprint (blocks + scratch) exceeds the "
          "budget",
          "shrink the schedule's blocks: on the card a block holds at most "
          "repro_torch.plan.SMEM_BUDGET bytes of shared memory and a GEMM's "
          "register tile at most psum_matmul.TILE rows and columns")
_register("RPC033", "unplanned-node", Severity.ERROR,
          "a workload node has no schedule (or no kernel params) assigned",
          "plan the whole graph (plan_graph) or pass a complete "
          "{node: Schedule} mapping")

# --- word-count certificates (repro_torch.check.dataflow); RPC041, RPC044
#     and RPC046's tracer are the reference's Pallas-body interpreter, kept
#     registered so both registries are one -----------------------------------
_register("RPC040", "write-write-race", Severity.ERROR,
          "two parallel grid steps may store to the same output block "
          "(a write is not pinned to every parallel axis its index map drops)",
          "give each thread block its own output tile: one block per tile "
          "along every grid axis, the reduction walked inside the block")
_register("RPC041", "read-before-init", Severity.ERROR,
          "a scratch accumulator may be read before any grid step "
          "unconditionally initialized it",
          "zero the scratch under pl.when(reduction_id == 0) before the "
          "first read-modify-write")
_register("RPC042", "incomplete-output-coverage", Severity.ERROR,
          "the union of written blocks does not cover the output array",
          "the grid must reach every output tile: grid extent x tile share "
          ">= the padded output extent along each axis")
_register("RPC043", "accumulation-order-mismatch", Severity.ERROR,
          "the store/guard structure breaks the revisit chain eq (3)/(7) "
          "assume, or the RMW counts disagree with the traffic meter",
          "accumulate over a contiguous innermost 'arbitrary' grid suffix: "
          "init at step 0, one unguarded RMW per step, drain at the last")
_register("RPC044", "block-window-alias", Severity.ERROR,
          "input/output aliasing with index maps that address different "
          "blocks at the same grid step",
          "aliased operands must share identical block shapes and index maps "
          "(in-place updates only)")
_register("RPC045", "traffic-proof-failed", Severity.ERROR,
          "the word counts derived from the traced footprint disagree with "
          "the analytical model (TrafficReport / gemm_model)",
          "the kernel and the model have diverged; re-derive eqs (2)/(3) for "
          "the launch or fix the kernel's load/store structure")
_register("RPC046", "untraceable-kernel", Severity.WARNING,
          "the kernel body uses constructs outside the abstract "
          "interpreter's fragment; dataflow proofs were skipped",
          "keep guards to pl.when(program_id(a) == const) and Ref access to "
          "load/store/[...] so the analyzer can see the dataflow")

# --- codebase lint ----------------------------------------------------------
_register("RPL100", "raw-byte-arith", Severity.ERROR,
          "dtype-width multiplication outside the byte-modelling modules",
          "only the traffic/byte models (plan.traffic, plan.gemm_model, "
          "sim/, ...) may multiply words by element widths; everywhere else "
          "consume TrafficReport.bytes / Tensor.nbytes")
_register("RPL101", "magic-energy-constant", Severity.ERROR,
          "per-access energy constant defined outside roofline/constants.py",
          "import the shared ENERGY_PJ_* table from repro.roofline.constants")
_register("RPL102", "words-bytes-cross-assign", Severity.ERROR,
          "a *_words name is assigned from a *_bytes name (or vice versa)",
          "convert explicitly via the dtype width at a byte-model boundary; "
          "never rename a quantity across units")
_register("RPL103", "raw-pallas-call", Severity.ERROR,
          "pl.pallas_call invoked outside repro.kernels",
          "build a repro.kernels.launch.LaunchPlan and execute it with "
          "launch.run() so the dataflow analyzer sees the same launch that "
          "runs")
_register("RPL104", "adhoc-wall-timing", Severity.ERROR,
          "raw wall-clock read (time.perf_counter & co) outside repro.obs / "
          "benchmarks",
          "measure through repro.obs.Stopwatch (or a span) so the interval "
          "is also visible to the tracer")
_register("RPL105", "bare-except", Severity.ERROR,
          "bare `except:` or `except Exception: pass` under src/repro "
          "swallows faults the degradation layer must dispatch on",
          "catch a typed repro.errors exception (PlanError, BudgetError, "
          "DeadlineExceeded, Shed) or re-raise")
_register("RPL110", "deprecated-import", Severity.WARNING,
          "import of the deprecated core.bwmodel / core.partitioner shims",
          "import from repro.plan (conv_model / gemm_model) instead")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verifier/lint finding, renderable as text or GitHub annotation."""

    code: str
    subject: str                      # workload/node/tensor name or file path
    message: str
    severity: Optional[Severity] = None   # defaults to the code's severity
    hint: Optional[str] = None            # defaults to the code's hint
    file: Optional[str] = None            # source file (lint / launch site)
    line: Optional[int] = None

    def __post_init__(self) -> None:
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")
        if self.severity is None:
            object.__setattr__(self, "severity", CODES[self.code].severity)
        if self.hint is None:
            object.__setattr__(self, "hint", CODES[self.code].hint)

    @property
    def slug(self) -> str:
        return CODES[self.code].slug

    def render(self) -> str:
        loc = f"{self.file}:{self.line}: " if self.file else ""
        return (f"{loc}{self.severity}: {self.code} {self.slug} "
                f"[{self.subject}] {self.message}")

    def render_github(self) -> str:
        """GitHub Actions workflow-command annotation format."""
        kind = "error" if self.severity is Severity.ERROR else "warning"
        where = ""
        if self.file:
            where = f" file={self.file}"
            if self.line is not None:
                where += f",line={self.line}"
        msg = f"{self.code} {self.slug} [{self.subject}]: {self.message}"
        return f"::{kind}{where}::{msg}"


class CheckError(ValueError):
    """Raised when a checked entry point hits error-severity diagnostics."""

    def __init__(self, diagnostics: Sequence[Diagnostic], context: str = ""):
        self.diagnostics = tuple(diagnostics)
        lines = [d.render() for d in self.diagnostics]
        head = context or "static check failed"
        super().__init__(f"{head} ({len(lines)} diagnostic"
                         f"{'s' if len(lines) != 1 else ''}):\n"
                         + "\n".join(lines))


def errors(diagnostics: Iterable[Diagnostic]) -> list[Diagnostic]:
    return [d for d in diagnostics if d.severity is Severity.ERROR]


def raise_on_error(diagnostics: Sequence[Diagnostic], context: str = "") -> None:
    bad = errors(diagnostics)
    if bad:
        raise CheckError(bad, context)


def render_all(diagnostics: Iterable[Diagnostic],
               github: bool = False) -> str:
    return "\n".join(d.render_github() if github else d.render()
                     for d in diagnostics)


def code_table() -> str:
    """The code table the README documents, rendered from the registry."""
    rows = [f"{info.code}  {info.slug:<28} {info.severity.value:<8} "
            f"{info.summary}" for info in CODES.values()]
    return "\n".join(rows)
