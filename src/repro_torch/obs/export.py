"""Chrome/Perfetto trace-event JSON exporters.

Two sources, one format (the trace-event JSON that chrome://tracing and
https://ui.perfetto.dev both load):

  * `spans_to_trace`: runtime `Tracer` spans as a host-time trace. Every
    span becomes a complete ("X") event on its thread's track, with its span
    and parent ids and its attributes in ``args``.
  * `simreport_to_trace`: a simulator `SimReport` as a *virtual-time*
    timeline of the modelled SoC. The phase walk is laid out sequentially in
    cycle time (1 trace-us = 1 cycle, so durations stay exact integers);
    each phase lands on the track of its bottleneck resource (compute / bus /
    dram / sram / dma / idle, colored by `Phase.bound`), and two counter
    tracks are derived: ``interconnect GB/s`` and ``interconnect words``
    (per-phase word shares plus a closing residual event, so the values sum
    to ``report.interconnect_words`` word for word).

`verify_sim_trace` recomputes per-track cycle totals and the counter's word
total from the emitted events and checks them against ``SimReport.cycles``
and ``interconnect_words`` exactly; the CLI runs it before it writes.

This module stays import-light: the simulator's types appear only under
``TYPE_CHECKING``, so `repro_torch.obs` never drags the simulator (and with
it the planner) into a process that only wants tracing.
"""

from __future__ import annotations

import json
from typing import IO, TYPE_CHECKING, Any, Optional

from repro_torch.obs.trace import Tracer

if TYPE_CHECKING:  # no runtime dependency on the simulator
    from repro_torch.sim.report import SimReport

__all__ = ["spans_to_trace", "simreport_to_trace", "trace_json",
           "write_trace", "verify_sim_trace", "RESOURCE_TRACKS",
           "BOUND_COLORS"]

Event = dict[str, Any]

#: Virtual-time track layout: resource -> tid (also its sort index). Every
#: phase is drawn on the track of its bottleneck resource.
RESOURCE_TRACKS: dict[str, int] = {
    "compute": 1, "bus": 2, "dram": 3, "sram": 4, "dma": 5, "idle": 6,
}

#: Reserved chrome://tracing color names per bottleneck: interconnect and
#: DRAM pressure are hot, compute-bound is good.
BOUND_COLORS: dict[str, str] = {
    "compute": "good", "bus": "bad", "dram": "terrible",
    "sram": "yellow", "dma": "olive", "idle": "grey",
}

_SIM_PID = 1
_WORDS_TID = 100      # counter pseudo-tracks sort below the resource tracks
_GBS_TID = 101


def trace_json(events: list[Event]) -> dict[str, Any]:
    """Wrap a flat event list in the trace-event container object."""
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_trace(events: list[Event], fp: IO[str]) -> None:
    json.dump(trace_json(events), fp, indent=None, separators=(",", ":"))


def spans_to_trace(tracer: Tracer, *, pid: int = 0,
                   process_name: str = "repro") -> list[Event]:
    """Render recorded spans as complete events, one track per thread.

    Timestamps are rebased to the earliest span so the trace starts at 0;
    ts/dur are in microseconds per the trace-event spec.
    """
    spans = list(tracer.spans)
    events: list[Event] = [_meta(pid, 0, "process_name", process_name)]
    if not spans:
        return events
    t_base = min(s.t0_s for s in spans)
    tids: dict[int, int] = {}
    for s in sorted(spans, key=lambda s: s.t0_s):
        tid = tids.get(s.thread_id)
        if tid is None:
            tid = len(tids) + 1
            tids[s.thread_id] = tid
            events.append(_meta(pid, tid, "thread_name",
                                f"thread-{tid}" if tid > 1 else "main"))
        args: dict[str, Any] = dict(s.attrs)
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        events.append({
            "name": s.name, "cat": s.cat, "ph": "X",
            "ts": (s.t0_s - t_base) * 1e6, "dur": s.dur_s * 1e6,
            "pid": pid, "tid": tid, "args": args,
        })
    return events


def simreport_to_trace(report: "SimReport") -> list[Event]:
    """Render a phase walk as a virtual-time timeline (1 trace-µs = 1 cycle).

    Tracks: one per bottleneck resource (`RESOURCE_TRACKS`) carrying the
    phases bound by it, plus ``interconnect words`` / ``interconnect GB/s``
    counter tracks. Track layout, colors, and the exactness pins are
    described in the module docstring.
    """
    from repro_torch.plan.units import nbytes    # a report implies the planner
    word_bytes = (report.interconnect_bytes / report.interconnect_words
                  if report.interconnect_words else 0.0)
    cycle_s = report.params.cycle_s
    events: list[Event] = [_meta(
        _SIM_PID, 0, "process_name",
        f"sim {report.name} ({report.controller.value})")]
    for res, tid in RESOURCE_TRACKS.items():
        events.append(_meta(_SIM_PID, tid, "thread_name", res))
        events.append(_meta(_SIM_PID, tid, "thread_sort_index", None,
                            {"sort_index": tid}))
    events.append(_meta(_SIM_PID, _WORDS_TID, "thread_name",
                        "interconnect words"))
    events.append(_meta(_SIM_PID, _GBS_TID, "thread_name",
                        "interconnect GB/s"))

    ts = 0.0                      # running virtual time, in cycles
    words_emitted = 0.0
    for p in report.phases:
        tid = RESOURCE_TRACKS.get(p.bound, RESOURCE_TRACKS["idle"])
        args: dict[str, Any] = {
            "count": p.count, "cycles": p.cycles, "bound": p.bound,
            "interconnect_words": p.interconnect_words,
            "dram_words": p.dram_words,
            "sram_reads": p.sram_reads, "sram_writes": p.sram_writes,
        }
        if p.node:
            args["node"] = p.node
        events.append({
            "name": p.name, "cat": "sim", "ph": "X",
            "ts": ts, "dur": p.cycles, "pid": _SIM_PID, "tid": tid,
            "cname": BOUND_COLORS.get(p.bound, "grey"), "args": args,
        })
        # Per-phase word share as a counter sample at phase start; the
        # closing residual event below makes the sample values sum to the
        # report total exactly.
        events.append(_counter(_WORDS_TID, "interconnect words", ts,
                               {"words": p.interconnect_words}))
        words_emitted += p.interconnect_words
        rate_gbs = 0.0
        if p.cycles > 0 and cycle_s > 0:
            rate_gbs = (nbytes(p.interconnect_words, word_bytes)
                        / (p.cycles * cycle_s) / 1e9)
        events.append(_counter(_GBS_TID, "interconnect GB/s", ts,
                               {"GB/s": rate_gbs}))
        ts += p.cycles
    # Close both counter tracks at end-of-run. The words event carries the
    # residual between the per-phase shares (which may split node totals
    # fractionally) and the exact report total, so verify_sim_trace can pin
    # the sum word-for-word.
    events.append(_counter(_WORDS_TID, "interconnect words", ts,
                           {"words": report.interconnect_words
                            - words_emitted}))
    events.append(_counter(_GBS_TID, "interconnect GB/s", ts, {"GB/s": 0.0}))
    return events


def verify_sim_trace(report: "SimReport", events: list[Event]
                     ) -> dict[str, float]:
    """Re-derive the exactness pins from the emitted events.

    Raises ``ValueError`` unless (a) per-track cycle durations sum to
    ``report.cycles`` exactly, and (b) ``interconnect words`` counter
    samples sum to ``report.interconnect_words`` exactly. Returns the
    per-track cycle totals (keyed by resource) plus the counter sum.
    """
    tid_to_res = {tid: res for res, tid in RESOURCE_TRACKS.items()}
    per_track: dict[str, float] = {}
    words = 0.0
    for ev in events:
        if ev.get("ph") == "X" and ev.get("pid") == _SIM_PID:
            res = tid_to_res.get(int(ev["tid"]))
            if res is not None:
                per_track[res] = per_track.get(res, 0.0) + float(ev["dur"])
        elif ev.get("ph") == "C" and ev.get("tid") == _WORDS_TID:
            words += float(ev["args"]["words"])
    total_cycles = sum(per_track.values())
    if total_cycles != report.cycles:
        raise ValueError(
            f"track cycles {total_cycles!r} != report cycles "
            f"{report.cycles!r} for {report.name}")
    if words != report.interconnect_words:
        raise ValueError(
            f"counter words {words!r} != report interconnect_words "
            f"{report.interconnect_words!r} for {report.name}")
    out = dict(per_track)
    out["interconnect_words"] = words
    return out


def _meta(pid: int, tid: int, name: str, value: Optional[str],
          args: Optional[dict[str, Any]] = None) -> Event:
    return {"name": name, "ph": "M", "pid": pid, "tid": tid,
            "args": args if args is not None else {"name": value}}


def _counter(tid: int, name: str, ts: float,
             args: dict[str, float]) -> Event:
    return {"name": name, "cat": "sim", "ph": "C", "ts": ts,
            "pid": _SIM_PID, "tid": tid, "args": args}
