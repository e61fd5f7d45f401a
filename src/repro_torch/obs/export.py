"""Chrome/Perfetto trace-event JSON export.

`spans_to_trace` renders a runtime `Tracer`'s spans as a host-time trace in
the trace-event JSON that chrome://tracing and https://ui.perfetto.dev both
load: every span becomes a complete ("X") event on its thread's track, with
its span and parent ids and its attributes in ``args``.

The reference's second exporter lays a simulator report out as a
virtual-time timeline (`simreport_to_trace`, checked by `verify_sim_trace`).
It needs the SoC simulator, which the port does not have yet: both names
raise `NotImplementedError` naming ROADMAP A10.
"""

from __future__ import annotations

import json
from typing import IO, Any, Optional

from repro_torch.obs.trace import Tracer

__all__ = ["spans_to_trace", "simreport_to_trace", "trace_json",
           "write_trace", "verify_sim_trace"]

Event = dict[str, Any]

_SIM_WAITS = ("needs the SoC simulator (repro_torch.sim), which is not "
              "ported yet: ROADMAP A10")


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


def simreport_to_trace(report: Any) -> list[Event]:
    """The reference's virtual-time timeline of a simulator report."""
    raise NotImplementedError(f"simreport_to_trace {_SIM_WAITS}")


def verify_sim_trace(report: Any, events: list[Event]) -> dict[str, float]:
    """The reference's exactness check of `simreport_to_trace`'s events."""
    raise NotImplementedError(f"verify_sim_trace {_SIM_WAITS}")


def _meta(pid: int, tid: int, name: str, value: Optional[str],
          args: Optional[dict[str, Any]] = None) -> Event:
    return {"name": name, "ph": "M", "pid": pid, "tid": tid,
            "args": args if args is not None else {"name": value}}
