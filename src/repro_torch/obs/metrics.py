"""Counters, gauges and histograms with Prometheus and JSON views.

One process-wide `Registry` (module-level `REGISTRY`) holds the port's
statistics: ``PlanContext.stats``, the ``netplan`` graph-cache hits and
misses, ``plan()``'s LRU info and the planner service's request counts,
behind three metric kinds:

  * `Counter`: a monotonically increasing float (cache hits, requests
    served). The planning caches reset their counters on
    ``clear_*_cache()``, so the cache-info accessors keep their meaning.
  * `Gauge`: a set value, or a *callback* gauge sampled at collection time
    (``plan()``'s LRU statistics are read straight off ``lru_cache``).
  * `Histogram`: a sparse log-bucketed distribution (bucket ratio 1.005, so
    any interpolated quantile is within about 0.25% of the exact
    order-statistic arithmetic: ``planserve.run_load`` derives p50/p99 from
    it and asserts agreement with ``np.percentile`` within 1%).

Metrics are identified by (name, labels); families share a name across label
sets (`Registry.family`). `Registry.render_prometheus()` emits the standard
text exposition; `Registry.snapshot()` returns a JSON-able dict. Both are
served by ``python -m repro_torch.obs metrics``. Stdlib only.
"""

from __future__ import annotations

import collections
import math
import threading
from typing import Any, Callable, Iterable, Optional

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
           "StatsCounter", "counter", "gauge", "histogram"]

LabelDict = dict[str, str]
_LabelKey = tuple[tuple[str, str], ...]

#: Histogram bucket boundaries are powers of this ratio: value v lands in
#: bucket floor(log(v, ratio)). 1.005 keeps geometric-midpoint quantile
#: reconstruction within ~0.25% of the exact sample arithmetic.
HIST_BUCKET_RATIO = 1.005
_LOG_RATIO = math.log(HIST_BUCKET_RATIO)


class Metric:
    """Shared identity: name, help text, labels."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[LabelDict] = None) -> None:
        self.name = name
        self.help = help
        self.labels: LabelDict = dict(labels or {})
        self._lock = threading.Lock()

    def label_suffix(self) -> str:
        if not self.labels:
            return ""
        inner = ",".join(f'{k}="{v}"'
                         for k, v in sorted(self.labels.items()))
        return "{" + inner + "}"

    def snapshot_value(self) -> Any:
        raise NotImplementedError

    def render(self) -> list[str]:
        raise NotImplementedError


class Counter(Metric):
    """Monotonically increasing value (resettable by the owning cache)."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[LabelDict] = None) -> None:
        super().__init__(name, help, labels)
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        with self._lock:
            self._value += amount

    def reset(self) -> None:
        """Zero the counter — used by the plan caches whose public
        ``clear_*_cache()`` APIs promise fresh statistics."""
        with self._lock:
            self._value = 0.0

    def snapshot_value(self) -> float:
        return self._value

    def render(self) -> list[str]:
        return [f"{self.name}{self.label_suffix()} {_fmt(self._value)}"]


class Gauge(Metric):
    """A set value, or a callback sampled at collection time."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[LabelDict] = None,
                 fn: Optional[Callable[[], float]] = None) -> None:
        super().__init__(name, help, labels)
        self._value = 0.0
        self._fn = fn

    @property
    def value(self) -> float:
        if self._fn is not None:
            return float(self._fn())
        return self._value

    def set(self, value: float) -> None:
        if self._fn is not None:
            raise ValueError(f"gauge {self.name} is callback-backed")
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        if self._fn is not None:
            raise ValueError(f"gauge {self.name} is callback-backed")
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def snapshot_value(self) -> float:
        return self.value

    def render(self) -> list[str]:
        return [f"{self.name}{self.label_suffix()} {_fmt(self.value)}"]


class Histogram(Metric):
    """Sparse log-bucketed distribution of positive observations.

    Buckets are geometric with ratio `HIST_BUCKET_RATIO`; zero (and any
    non-positive) observation is kept in a dedicated exact-zero bucket.
    `quantile()` mirrors numpy's default ``linear`` percentile arithmetic on
    reconstructed order statistics (each represented by its bucket's
    geometric midpoint), so histogram-derived p50/p99 track
    ``np.percentile`` within the bucket ratio.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Optional[LabelDict] = None) -> None:
        super().__init__(name, help, labels)
        self.buckets: dict[int, int] = {}    # log-index -> count
        self.zeros = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += value
            self.min = min(self.min, value)
            self.max = max(self.max, value)
            if value <= 0.0:
                self.zeros += 1
            else:
                idx = math.floor(math.log(value) / _LOG_RATIO)
                self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def _order_stats(self) -> "_OrderStats":
        return _OrderStats(self.zeros, sorted(self.buckets.items()))

    def quantile(self, q: float) -> float:
        """The q-quantile (q in [0, 1]) via numpy-style linear interpolation
        between reconstructed order statistics."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return math.nan
        stats = self._order_stats()
        h = q * (self.count - 1)
        k = math.floor(h)
        frac = h - k
        lo = stats.value_at(k)
        if frac == 0.0:
            return lo
        return lo * (1.0 - frac) + stats.value_at(k + 1) * frac

    def percentile(self, p: float) -> float:
        """numpy.percentile-compatible spelling (p in [0, 100])."""
        return self.quantile(p / 100.0)

    def snapshot_value(self) -> dict[str, Any]:
        out: dict[str, Any] = {
            "count": self.count, "sum": self.sum,
            "min": self.min if self.count else None,
            "max": self.max if self.count else None,
        }
        if self.count:
            out["p50"] = self.quantile(0.50)
            out["p90"] = self.quantile(0.90)
            out["p99"] = self.quantile(0.99)
        return out

    def render(self) -> list[str]:
        suffix = self.label_suffix()
        lines: list[str] = []
        cum = self.zeros
        if self.zeros:
            lines.append(f'{self.name}_bucket{_le(suffix, "0.0")} {cum}')
        for idx, n in sorted(self.buckets.items()):
            cum += n
            upper = HIST_BUCKET_RATIO ** (idx + 1)
            lines.append(f'{self.name}_bucket{_le(suffix, _fmt(upper))} {cum}')
        lines.append(f'{self.name}_bucket{_le(suffix, "+Inf")} {self.count}')
        lines.append(f"{self.name}_sum{suffix} {_fmt(self.sum)}")
        lines.append(f"{self.name}_count{suffix} {self.count}")
        return lines


class _OrderStats:
    """Order-statistic reconstruction over a histogram's sorted buckets."""

    def __init__(self, zeros: int, sorted_buckets: list[tuple[int, int]]
                 ) -> None:
        self.zeros = zeros
        self.buckets = sorted_buckets

    def value_at(self, rank: int) -> float:
        """Approximate value of the rank-th (0-indexed) sorted observation:
        its bucket's geometric midpoint (exact 0.0 for the zero bucket)."""
        if rank < self.zeros:
            return 0.0
        seen = self.zeros
        for idx, n in self.buckets:
            if rank < seen + n:
                lo = HIST_BUCKET_RATIO ** idx
                return lo * math.sqrt(HIST_BUCKET_RATIO)
            seen += n
        # rank beyond the recorded population: the topmost bucket's midpoint.
        idx = self.buckets[-1][0]
        return (HIST_BUCKET_RATIO ** idx) * math.sqrt(HIST_BUCKET_RATIO)


def _le(suffix: str, bound: str) -> str:
    if suffix:
        return suffix[:-1] + f',le="{bound}"}}'
    return f'{{le="{bound}"}}'


def _fmt(v: float) -> str:
    return repr(round(v, 10)) if v != int(v) else str(int(v))


class Registry:
    """(name, labels) -> metric; get-or-create, kind-checked."""

    def __init__(self) -> None:
        self._metrics: dict[tuple[str, _LabelKey], Metric] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------- creation
    def _get_or_make(self, cls: type, name: str, help: str,
                     labels: Optional[LabelDict],
                     **kwargs: Any) -> Metric:
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            hit = self._metrics.get(key)
            if hit is not None:
                if not isinstance(hit, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {hit.kind}")
                return hit
            m: Metric = cls(name, help, labels, **kwargs)
            self._metrics[key] = m
            return m

    def counter(self, name: str, help: str = "",
                labels: Optional[LabelDict] = None) -> Counter:
        m = self._get_or_make(Counter, name, help, labels)
        assert isinstance(m, Counter)
        return m

    def gauge(self, name: str, help: str = "",
              labels: Optional[LabelDict] = None,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        m = self._get_or_make(Gauge, name, help, labels, fn=fn)
        assert isinstance(m, Gauge)
        return m

    def histogram(self, name: str, help: str = "",
                  labels: Optional[LabelDict] = None) -> Histogram:
        m = self._get_or_make(Histogram, name, help, labels)
        assert isinstance(m, Histogram)
        return m

    # ------------------------------------------------------------ iteration
    def __iter__(self) -> "Iterable[Metric]":      # type: ignore[override]
        return iter(list(self._metrics.values()))

    def __len__(self) -> int:
        return len(self._metrics)

    def family(self, name: str) -> list[Metric]:
        """Every metric sharing ``name`` (one per label set)."""
        return [m for (n, _), m in self._metrics.items() if n == name]

    def families(self) -> list[str]:
        """Sorted distinct metric names (label sets collapsed)."""
        return sorted({n for (n, _) in self._metrics})

    def get(self, name: str, labels: Optional[LabelDict] = None
            ) -> Optional[Metric]:
        key = (name, tuple(sorted((labels or {}).items())))
        return self._metrics.get(key)

    def unregister(self, name: str) -> int:
        """Drop every metric of a family; returns how many were removed."""
        with self._lock:
            doomed = [k for k in self._metrics if k[0] == name]
            for k in doomed:
                del self._metrics[k]
        return len(doomed)

    # -------------------------------------------------------------- export
    def snapshot(self) -> dict[str, Any]:
        """JSON-able view: {name: {"type", "help", "values": [...]}}."""
        out: dict[str, Any] = {}
        for (name, _), m in sorted(self._metrics.items()):
            fam = out.setdefault(name, {"type": m.kind, "help": m.help,
                                        "values": []})
            fam["values"].append({"labels": dict(m.labels),
                                  "value": m.snapshot_value()})
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines: list[str] = []
        seen: set[str] = set()
        for (name, _), m in sorted(self._metrics.items()):
            if name not in seen:
                seen.add(name)
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")


#: The process-wide default registry every subsystem of the port registers
#: into.
REGISTRY = Registry()


class StatsCounter(collections.Counter[str]):
    """A ``collections.Counter`` that mirrors increments into the registry.

    Drop-in replacement for the raw Counters that planning code keys by
    event name (``stats["grid_hits"] += 1``): reads, comparisons, and the
    whole Counter API behave identically, and every *positive* delta is
    additionally recorded as ``{metric}{key="..."}`` in `REGISTRY`, so the
    per-context statistics roll up into process-wide totals without the
    call sites changing.
    """

    def __init__(self, metric: str = "plan_context_stats",
                 help: str = "PlanContext event counts") -> None:
        super().__init__()
        self._metric = metric
        self._help = help

    def __setitem__(self, key: str, value: int) -> None:
        delta = value - self.get(key, 0)
        if delta > 0:
            REGISTRY.counter(self._metric, self._help,
                             labels={"key": key}).inc(delta)
        super().__setitem__(key, value)


def counter(name: str, help: str = "",
            labels: Optional[LabelDict] = None) -> Counter:
    return REGISTRY.counter(name, help, labels)


def gauge(name: str, help: str = "", labels: Optional[LabelDict] = None,
          fn: Optional[Callable[[], float]] = None) -> Gauge:
    return REGISTRY.gauge(name, help, labels, fn=fn)


def histogram(name: str, help: str = "",
              labels: Optional[LabelDict] = None) -> Histogram:
    return REGISTRY.histogram(name, help, labels)
