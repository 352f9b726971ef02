"""Process-wide metrics registry: counters, gauges, and fixed-bucket
latency histograms with p50/p95/p99, exposed as Prometheus text.

One namespace absorbs the telemetry that used to live in scattered
per-store dicts and thread-local kernel counters:

    lsm.flush_s / lsm.compact_s     flush + compaction durations
    lsm.puts / lsm.flushes / ...    write-path counters
    wal.fsync_s / wal.commits       group-commit fsync latency
    query.latency_s / query.count   read-path latency distribution
    kernels.launches / ...          kernel-dispatch totals (all threads)
    continuous.advance_s            continuous-engine tick latency

The per-store ``metrics`` dicts remain (tests and benchmarks read them);
source sites record into both.  Registry updates are lock-guarded and
cheap (sub-microsecond) — instrumented paths run with metrics always on;
only TRACING defaults off.
"""
from __future__ import annotations

import bisect
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

# log-spaced latency buckets: 10us .. 60s upper bounds (seconds)
DEFAULT_LATENCY_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4,
    1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class Counter:
    """Monotonic counter (float-valued so duration totals fit too)."""

    kind = "counter"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value: Union[int, float] = 0

    def inc(self, n: Union[int, float] = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self) -> Dict[str, Any]:
        return {"type": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.value: float = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def snapshot(self) -> Dict[str, Any]:
        return {"type": self.kind, "value": self.value}


class Histogram:
    """Fixed-bucket histogram with cumulative-count percentiles.

    Buckets are ascending upper bounds; observations above the last
    bound land in the +Inf bucket.  ``percentile`` interpolates within
    the winning bucket and clamps to the observed min/max, so p50 on a
    handful of samples stays inside the sampled range."""

    kind = "histogram"

    def __init__(self, buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        self._lock = threading.Lock()
        self.bounds: List[float] = sorted(float(b) for b in buckets)
        self.counts: List[int] = [0] * (len(self.bounds) + 1)  # + overflow
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def percentile(self, q: float) -> float:
        """q in [0, 1]; 0.0 when the histogram is empty."""
        with self._lock:
            if self.count == 0:
                return 0.0
            target = q * self.count
            cum = 0
            for i, c in enumerate(self.counts):
                cum += c
                if cum >= target and c > 0:
                    hi = self.bounds[i] if i < len(self.bounds) else self.max
                    lo = self.bounds[i - 1] if i > 0 else 0.0
                    frac = 1.0 - (cum - target) / c
                    est = lo + (hi - lo) * frac
                    return min(max(est, self.min), self.max)
            return self.max

    @property
    def p50(self) -> float:
        return self.percentile(0.50)

    @property
    def p95(self) -> float:
        return self.percentile(0.95)

    @property
    def p99(self) -> float:
        return self.percentile(0.99)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self.counts)
            count, total = self.count, self.sum
        out = {"type": self.kind, "count": count, "sum": total,
               "buckets": {str(b): c
                           for b, c in zip(self.bounds, counts)},
               "inf": counts[-1]}
        if count:
            out.update(p50=self.p50, p95=self.p95, p99=self.p99,
                       min=self.min, max=self.max)
        return out


_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str, prefix: str = "repro_") -> str:
    return prefix + _NAME_RE.sub("_", name)


class MetricsRegistry:
    """Name -> metric, with get-or-create accessors and exporters."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, Union[Counter, Gauge, Histogram]] = {}
        # bumped on reset() so hot paths holding cached metric object
        # refs (kernel dispatch) know to re-fetch
        self.generation = 0

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.get(name)
                if m is None:
                    m = self._metrics[name] = cls(*args)
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is {m.kind}, "
                            f"not {cls.__name__.lower()}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get(name, Histogram, buckets)

    # --------------------------------------------------------- conveniences
    def inc(self, name: str, n: Union[int, float] = 1) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, v: float) -> None:
        self.gauge(name).set(v)

    def observe(self, name: str, v: float) -> None:
        self.histogram(name).observe(v)

    def get(self, name: str) -> Optional[Union[Counter, Gauge, Histogram]]:
        return self._metrics.get(name)

    def reset(self) -> None:
        """Drop every metric (benchmark isolation / tests)."""
        with self._lock:
            self._metrics.clear()
            self.generation += 1

    # ------------------------------------------------------------- exports
    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def prometheus_text(self) -> str:
        """Prometheus text exposition format.  Histograms export the
        standard ``_bucket``/``_sum``/``_count`` series plus derived
        ``_p50``/``_p95``/``_p99`` gauges (the SLO-gate numbers the
        ROADMAP's serving front door wants at a glance)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines: List[str] = []
        for name, m in items:
            pn = _prom_name(name)
            if isinstance(m, Histogram):
                lines.append(f"# TYPE {pn} histogram")
                cum = 0
                with m._lock:
                    counts = list(m.counts)
                    count, total = m.count, m.sum
                for b, c in zip(m.bounds, counts):
                    cum += c
                    lines.append(f'{pn}_bucket{{le="{b:g}"}} {cum}')
                lines.append(f'{pn}_bucket{{le="+Inf"}} {count}')
                lines.append(f"{pn}_sum {total:.9g}")
                lines.append(f"{pn}_count {count}")
                for q, v in (("p50", m.p50), ("p95", m.p95),
                             ("p99", m.p99)):
                    lines.append(f"# TYPE {pn}_{q} gauge")
                    lines.append(f"{pn}_{q} {v:.9g}")
            else:
                lines.append(f"# TYPE {pn} {m.kind}")
                lines.append(f"{pn} {m.value:.9g}"
                             if isinstance(m.value, float)
                             else f"{pn} {m.value}")
        return "\n".join(lines) + "\n"


REGISTRY = MetricsRegistry()
