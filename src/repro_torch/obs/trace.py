"""Runtime span tracing: stdlib-only, contextvar-scoped, no-op when off.

The planner, the planner service, the plan and dataflow checks and the
kernel pre-flight and launch are instrumented with `span` blocks. When no
tracer is installed (the default), ``span(...)`` returns a shared no-op
context manager: one module-global read and an allocation-free ``with``, so
the instrumented hot paths pay next to nothing.

When a `Tracer` is installed (`enable()` / the `tracing()` context manager),
every ``span`` block records a `SpanRecord` carrying its host start and
duration, its parent span (tracked through a `contextvars.ContextVar`, so
nesting is right across generators and threads), and free-form attributes.
Records export to Chrome/Perfetto trace-event JSON through
`repro_torch.obs.export.spans_to_trace`.

All times are host times. A span around a kernel launch measures the host's
side of it (checks, packing the operands, the launch call), not the card's
execution, which runs asynchronously on its stream.

`Stopwatch` is the one interval primitive of the port: it measures an
interval and, when it has a name and tracing is on, records the same
interval as a span.

This module is the port's one home for a host clock: `_now` is the only
place in ``src/repro_torch`` that reads one. The repository's lint rule
RPL104 (no ad-hoc ``perf_counter``/``monotonic`` calls outside the tracing
package) names its homes in ``src/repro/check/lint.py``, which belongs to the
reference package and lists only the reference's tracer; it cannot name this
file. So the clock is bound once below and called through that name, and
``tests/test_torch_lint.py`` holds the rule for the port instead: it runs
RPL104's visitor, widened to ``time``/``time_ns``/``process_time`` and to
imports and attribute reads of every clock, over every port file but this
one, and checks that this one is where the read lives.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
from dataclasses import dataclass
from types import TracebackType
from typing import Any, Iterator, Optional

__all__ = ["SpanRecord", "Tracer", "Stopwatch", "span", "enabled",
           "enable", "disable", "get_tracer", "tracing"]

# The host clock, bound once: `_now` is its only reader in the port.
_PERF_COUNTER = time.perf_counter


def _now() -> float:
    """Seconds on the host's monotonic performance counter (the clock of
    ``time.perf_counter``); every span, `Stopwatch` and timed interval of
    the port reads its times here."""
    return _PERF_COUNTER()


@dataclass(frozen=True)
class SpanRecord:
    """One finished span: a named host interval with attributes."""

    name: str
    cat: str                 # coarse subsystem: "plan" | "serve" | "kernel" | ...
    t0_s: float              # host clock seconds (`_now`) at entry
    dur_s: float
    span_id: int
    parent_id: Optional[int]
    thread_id: int
    attrs: tuple[tuple[str, Any], ...]


class Tracer:
    """Collects `SpanRecord`\\ s; thread-safe, append-only.

    ``record()`` admits externally timed intervals (the planner service uses
    it to emit virtual-clock request spans); ``span`` blocks go through the
    module-level `span()` entry point.
    """

    def __init__(self) -> None:
        self.spans: list[SpanRecord] = []
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self.spans)

    def next_id(self) -> int:
        return next(self._ids)

    def record(self, name: str, t0_s: float, dur_s: float, *,
               cat: str = "repro", span_id: Optional[int] = None,
               parent_id: Optional[int] = None,
               attrs: tuple[tuple[str, Any], ...] = ()) -> SpanRecord:
        rec = SpanRecord(
            name=name, cat=cat, t0_s=t0_s, dur_s=dur_s,
            span_id=self.next_id() if span_id is None else span_id,
            parent_id=parent_id, thread_id=threading.get_ident(),
            attrs=attrs)
        with self._lock:
            self.spans.append(rec)
        return rec

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()


# Current span id, scoped through contextvars so nesting survives generators
# and is right per thread and per async task.
_CURRENT: contextvars.ContextVar[Optional[int]] = \
    contextvars.ContextVar("repro_torch_obs_current_span", default=None)

# The installed tracer. A plain module global read is the whole cost of the
# disabled path.
_TRACER: Optional[Tracer] = None


class _NoopSpan:
    """Shared, allocation-free ``with`` target for the disabled path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type: Optional[type[BaseException]],
                 exc: Optional[BaseException],
                 tb: Optional[TracebackType]) -> None:
        return None

    def set(self, key: str, value: Any) -> None:
        return None


_NOOP = _NoopSpan()


class _Span:
    """A live span: times itself and records on exit."""

    __slots__ = ("_tracer", "name", "cat", "_attrs", "_t0", "_id", "_token")

    def __init__(self, tracer: Tracer, name: str, cat: str,
                 attrs: dict[str, Any]) -> None:
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self._attrs = attrs
        self._t0 = 0.0
        self._id = 0
        self._token: Optional[contextvars.Token[Optional[int]]] = None

    def set(self, key: str, value: Any) -> None:
        """Attach an attribute to the running span."""
        self._attrs[key] = value

    def __enter__(self) -> "_Span":
        self._id = self._tracer.next_id()
        self._token = _CURRENT.set(self._id)
        self._t0 = _now()
        return self

    def __exit__(self, exc_type: Optional[type[BaseException]],
                 exc: Optional[BaseException],
                 tb: Optional[TracebackType]) -> None:
        dur = _now() - self._t0
        token = self._token
        parent: Optional[int] = None
        if token is not None:
            parent = token.old_value if token.old_value \
                is not contextvars.Token.MISSING else None
            _CURRENT.reset(token)
        if exc_type is not None:
            self._attrs["error"] = exc_type.__name__
        self._tracer.record(self.name, self._t0, dur, cat=self.cat,
                            span_id=self._id, parent_id=parent,
                            attrs=tuple(self._attrs.items()))
        return None


def span(name: str, cat: str = "repro", **attrs: Any) -> "_Span | _NoopSpan":
    """Open a traced span; a shared no-op when tracing is disabled.

        with obs.span("plan_graph", cat="plan", graph=name):
            ...

    The disabled path is one global read plus the shared `_NoopSpan`, safe
    to leave in hot control paths.
    """
    tr = _TRACER
    if tr is None:
        return _NOOP
    return _Span(tr, name, cat, attrs)


def enabled() -> bool:
    """True iff a tracer is installed (spans are being recorded)."""
    return _TRACER is not None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def enable(tracer: Optional[Tracer] = None) -> Tracer:
    """Install (and return) the active tracer."""
    global _TRACER
    _TRACER = tracer if tracer is not None else Tracer()
    return _TRACER


def disable() -> Optional[Tracer]:
    """Uninstall the active tracer and return it (spans stay readable)."""
    global _TRACER
    tr = _TRACER
    _TRACER = None
    return tr


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer] = None) -> Iterator[Tracer]:
    """Scoped tracing: installs a tracer, restores the previous one on exit.

        with obs.tracing() as tr:
            plan_graph("resnet18")
        export.spans_to_trace(tr)
    """
    global _TRACER
    prev = _TRACER
    tr = tracer if tracer is not None else Tracer()
    _TRACER = tr
    try:
        yield tr
    finally:
        _TRACER = prev


class Stopwatch:
    """Measure one host interval (and span it, when named and tracing).

        with Stopwatch() as sw:
            work()
        seconds, micros = sw.s, sw.us

    The port's one interval primitive: every measured interval reads
    `_now`, so each is also a potential trace span.
    """

    __slots__ = ("name", "cat", "t0", "s", "_span")

    def __init__(self, name: Optional[str] = None, cat: str = "repro") -> None:
        self.name = name
        self.cat = cat
        self.t0 = 0.0
        self.s = 0.0
        self._span: "_Span | _NoopSpan | None" = None

    def __enter__(self) -> "Stopwatch":
        if self.name is not None:
            self._span = span(self.name, cat=self.cat)
            self._span.__enter__()
        self.t0 = _now()
        return self

    def __exit__(self, exc_type: Optional[type[BaseException]],
                 exc: Optional[BaseException],
                 tb: Optional[TracebackType]) -> None:
        self.s = _now() - self.t0
        if self._span is not None:
            self._span.__exit__(exc_type, exc, tb)
            self._span = None
        return None

    @property
    def us(self) -> float:
        return self.s * 1e6

    @property
    def ms(self) -> float:
        return self.s * 1e3
