"""`Phase` / `SimReport`: the simulator's output types.

A `Phase` is one aggregated epoch class of the schedule's iteration walk —
all epochs with identical block shapes and psum behaviour (first-write vs.
update) cost the same, so the timeline stores one entry per class with an
epoch ``count`` instead of one entry per iteration. Word counts in the report
totals are exact integers computed with the same arithmetic as the analytical
model (`repro_torch.plan.traffic` / ``netplan.network_report``); per-phase
word columns are the timing-model's per-class shares and may split a node
total fractionally when only part of an input is DRAM-resident.
"""

from __future__ import annotations

import dataclasses

from repro_torch.plan.schedule import Controller
from repro_torch.plan.traffic import TrafficReport
from repro_torch.plan.units import nbytes
from repro_torch.sim.params import SimParams


@dataclasses.dataclass(frozen=True)
class Phase:
    """One aggregated epoch class of the iteration walk."""

    name: str
    count: int                   # epochs aggregated into this phase
    cycles: float                # total cycles (count * per-epoch cycles)
    # Bottleneck resource: "compute" | "dram" | "bus" | "sram" | "dma", or
    # "idle" for a degenerate zero-work epoch. Ties break deterministically:
    # processing beats fetch (overlap hides an equal fetch), and within the
    # processing side compute > sram > bus; dram beats dma on the fetch side.
    bound: str
    interconnect_words: float    # words crossing the bus in this phase
    dram_words: float            # words fetched from the DRAM channel
    sram_reads: float
    sram_writes: float
    row_hits: int
    row_misses: int
    bank_conflicts: int
    # Which node of a merged network report this phase came from ("" for a
    # single-workload report) — `merge_reports` stamps it so the Perfetto
    # timeline and `summary()` stay attributable per layer.
    node: str = ""

    @property
    def cycles_per_epoch(self) -> float:
        return self.cycles / self.count if self.count else 0.0


@dataclasses.dataclass(frozen=True)
class SimReport:
    """Cycle-approximate simulation result for one workload or one network.

    The word totals (``interconnect_words``/``input_words``/``output_words``/
    ``sram_reads``/``sram_writes``) are exact and cross-validated against the
    analytical `TrafficReport` / ``network_report``; everything below them is
    the second-order information the first-order model cannot express.
    """

    name: str
    controller: Controller
    params: SimParams
    phases: tuple[Phase, ...]
    # -- first-order totals (exact; == the analytical model) ---------------
    interconnect_words: float
    input_words: float
    output_words: float
    sram_reads: float
    sram_writes: float
    interconnect_bytes: float
    # -- second-order counters ---------------------------------------------
    dram_words: float
    dram_bytes: float
    row_hits: int
    row_misses: int
    bank_conflicts: int
    # -- time / bandwidth ---------------------------------------------------
    cycles: float
    # -- energy --------------------------------------------------------------
    energy_breakdown: dict[str, float]

    @property
    def latency_s(self) -> float:
        return self.cycles * self.params.cycle_s

    @property
    def avg_bw_bytes_s(self) -> float:
        """Average interconnect bandwidth over the whole run."""
        return self.interconnect_bytes / self.latency_s if self.cycles else 0.0

    @property
    def peak_bw_bytes_s(self) -> float:
        """Peak per-phase interconnect bandwidth (the burstiness the
        first-order word count hides)."""
        peak_words_per_cycle = max(
            (p.interconnect_words / p.cycles for p in self.phases
             if p.cycles > 0), default=0.0)
        word_bytes = (self.interconnect_bytes / self.interconnect_words
                      if self.interconnect_words else 0.0)
        return (nbytes(peak_words_per_cycle, word_bytes)
                * self.params.clock_ghz * 1e9)

    @property
    def energy_pj(self) -> float:
        return sum(self.energy_breakdown.values())

    @property
    def row_miss_rate(self) -> float:
        total = self.row_hits + self.row_misses
        return self.row_misses / total if total else 0.0

    def as_traffic_report(self) -> TrafficReport:
        """The first-order view of this run, for word-for-word parity checks
        against `repro_torch.plan.traffic` / ``network_report``."""
        return TrafficReport(
            interconnect_words=self.interconnect_words,
            input_words=self.input_words,
            output_words=self.output_words,
            sram_reads=self.sram_reads,
            sram_writes=self.sram_writes,
            bytes=self.interconnect_bytes)

    def summary(self) -> str:
        lines = [
            f"# sim: {self.name} controller={self.controller.value}",
            f"latency        {self.latency_s * 1e3:.3f} ms "
            f"({self.cycles:.3e} cycles)",
            f"interconnect   {self.interconnect_words:.3e} words, "
            f"avg {self.avg_bw_bytes_s / 1e9:.2f} GB/s, "
            f"peak {self.peak_bw_bytes_s / 1e9:.2f} GB/s",
            f"dram           {self.dram_words:.3e} words, "
            f"row hits/misses {self.row_hits}/{self.row_misses} "
            f"(miss rate {self.row_miss_rate:.1%})",
            f"sram           {self.sram_reads:.3e} reads, "
            f"{self.sram_writes:.3e} writes, "
            f"{self.bank_conflicts} bank conflicts",
            f"energy         {self.energy_pj / 1e6:.3f} uJ  "
            + " ".join(f"{k}={v / 1e6:.3f}" for k, v in
                       self.energy_breakdown.items()),
        ]
        nodes = self.node_breakdown()
        if len(nodes) > 1:
            lines.append(f"{'node':<24}{'cycles':>12}{'bus words':>14}")
            for node, (cyc, words) in nodes.items():
                lines.append(f"{node:<24}{cyc:>12.3e}{words:>14.3e}")
        return "\n".join(lines)

    def node_breakdown(self) -> "dict[str, tuple[float, float]]":
        """Per-node (cycles, interconnect words), in phase order — the
        provenance `merge_reports` stamps on each phase (single-workload
        reports collapse to one entry under their own name)."""
        out: dict[str, tuple[float, float]] = {}
        for p in self.phases:
            node = p.node or self.name
            cyc, words = out.get(node, (0.0, 0.0))
            out[node] = (cyc + p.cycles, words + p.interconnect_words)
        return out


def _stamp_node(phase: Phase, node: str) -> Phase:
    """Phase provenance for a merged report: carry the owning node's name
    and make the phase name globally unique by prefixing it (the engine
    already names phases ``{layer}/{epoch}``, so an existing prefix is
    kept rather than doubled)."""
    name = phase.name if phase.name.startswith(f"{node}/") \
        else f"{node}/{phase.name}"
    return dataclasses.replace(phase, name=name, node=node)


def merge_reports(name: str, controller: Controller, params: SimParams,
                  reports: "list[SimReport]") -> SimReport:
    """Concatenate per-node reports into one network report (nodes execute
    sequentially: cycles add, counters add, phases chain). Each phase is
    stamped with the node it came from (`Phase.node`), so the merged
    timeline stays attributable per layer."""
    breakdown: dict[str, float] = {}
    for r in reports:
        for k, v in r.energy_breakdown.items():
            breakdown[k] = breakdown.get(k, 0.0) + v
    return SimReport(
        name=name, controller=controller, params=params,
        phases=tuple(_stamp_node(p, r.name) for r in reports
                     for p in r.phases),
        interconnect_words=sum(r.interconnect_words for r in reports),
        input_words=sum(r.input_words for r in reports),
        output_words=sum(r.output_words for r in reports),
        sram_reads=sum(r.sram_reads for r in reports),
        sram_writes=sum(r.sram_writes for r in reports),
        interconnect_bytes=sum(r.interconnect_bytes for r in reports),
        dram_words=sum(r.dram_words for r in reports),
        dram_bytes=sum(r.dram_bytes for r in reports),
        row_hits=sum(r.row_hits for r in reports),
        row_misses=sum(r.row_misses for r in reports),
        bank_conflicts=sum(r.bank_conflicts for r in reports),
        cycles=sum(r.cycles for r in reports),
        energy_breakdown=breakdown)
