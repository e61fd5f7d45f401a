"""`TrafficReport`: the word counts of one (workload, schedule) pair.

Words crossing the interconnect (the paper's "BW") and accesses at the
memory that owns the accumulator. The conv numbers are eqs (2)/(3); the
matmul numbers are the blocked-GEMM model of `gemm_model`. Byte counts are
not part of this port yet.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.plan import conv_model, gemm_model
from repro_torch.plan.schedule import Schedule
from repro_torch.plan.workload import ConvWorkload, MatmulWorkload, Workload


@dataclasses.dataclass(frozen=True)
class TrafficReport:
    """Per-level word counts for one scheduled workload.

    interconnect_words — words crossing the interconnect/device memory
    input_words        — operand-read share of the above (B_i / A+B reads)
    output_words       — partial-sum/output share (B_o / C traffic)
    sram_reads/writes  — accesses at the memory owning the accumulator;
                         identical for both controllers (the active
                         controller moves work off the bus, it does not
                         remove it)
    """

    interconnect_words: float
    input_words: float
    output_words: float
    sram_reads: float
    sram_writes: float

    def as_dict(self) -> dict[str, float]:
        return dataclasses.asdict(self)


def conv_traffic(wl: ConvWorkload, schedule: Schedule,
                 exact_iters: bool = True) -> TrafficReport:
    """Report for a partitioned conv (ceil iteration counts by default; pass
    exact_iters=False for the paper's real-valued M/m convention)."""
    b_i, b_o = conv_model.conv_bandwidth(wl, schedule.m, schedule.n,
                                         schedule.controller, exact_iters)
    mg = wl.cin // wl.groups
    in_iters = math.ceil(mg / min(schedule.m, mg))
    # Every input word is read from input SRAM once per arrival; the
    # accumulator is written every iteration and read on every non-first one.
    return TrafficReport(interconnect_words=b_i + b_o, input_words=b_i,
                         output_words=b_o,
                         sram_reads=b_i + (in_iters - 1) * wl.out_acts,
                         sram_writes=float(in_iters * wl.out_acts))


def matmul_traffic_report(wl: MatmulWorkload, schedule: Schedule) -> TrafficReport:
    """Report for a blocked GEMM under the schedule's controller."""
    t = gemm_model.matmul_traffic(wl.m, wl.n, wl.k, schedule, schedule.controller)
    gk = math.ceil(wl.k / schedule.bk)
    acc = wl.m * wl.n
    return TrafficReport(
        interconnect_words=t["total"],
        input_words=t["a_reads"] + t["b_reads"],
        output_words=t["c_traffic"],
        sram_reads=float((gk - 1) * acc),   # accumulator re-reads per k step
        sram_writes=float(gk * acc))


def traffic_report(workload: Workload, schedule: Schedule,
                   exact_iters: bool = True) -> TrafficReport:
    """Dispatch on workload kind; the schedule kind must match."""
    if isinstance(workload, ConvWorkload):
        if schedule.kind != "conv":
            raise ValueError(f"conv workload needs a conv schedule, got {schedule}")
        return conv_traffic(workload, schedule, exact_iters)
    if isinstance(workload, MatmulWorkload):
        if schedule.kind != "matmul":
            raise ValueError(f"matmul workload needs a matmul schedule, got {schedule}")
        return matmul_traffic_report(workload, schedule)
    raise TypeError(f"unknown workload type {type(workload).__name__}")
