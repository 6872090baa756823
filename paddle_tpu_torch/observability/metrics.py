"""Metrics registry: counters, gauges, histograms with bounded reservoirs
(port of ``paddle_tpu.observability.metrics``, pure Python, the same
Prometheus text byte for byte).

A framework-wide runtime: any layer grabs a metric
by name + labels from the process-global registry and updates it; the
registry renders either a JSON snapshot (the per-worker JSONL sink,
``observability.sink``) or a zero-dependency Prometheus-style text
exposition for scraping.

Design constraints:

- hot-path cheap: metric handles are cached by ``(kind, name, labels)``
  so steady-state updates are one dict hit + one locked float op;
- bounded memory: histograms keep exact count/sum/min/max and a fixed-
  size reservoir (deterministic LCG replacement, so tests and replays
  see the same percentiles) — a million observations cost the same RAM
  as a thousand;
- zero dependencies: the Prometheus text format is hand-rendered.
"""
from __future__ import annotations

import math
import threading
import zlib
from typing import Any, Dict, Iterable, List, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "nearest_rank",
    "registry",
]

_LCG_MULT = 6364136223846793005
_LCG_INC = 1442695040888963407
_LCG_MASK = (1 << 64) - 1


def nearest_rank(values, q: float) -> float:
    """Nearest-rank percentile, ``q`` in [0, 1]; 0.0 on empty input.

    THE percentile definition for the whole repo — ``Histogram``
    reservoirs, the windowed SLO rings (``observability.slo``), and
    ``serving.loadgen`` reports all call this one helper, so a
    ``ttft_ms_p99`` from a bench row and one from a trace agree by
    construction. Sorts a copy; callers pass bounded samples.
    """
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(round(q * (len(vs) - 1)))))
    return float(vs[idx])


class _Metric:
    __slots__ = ("name", "labels", "_lock")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()

    def label_dict(self) -> Dict[str, str]:
        return dict(self.labels)


class Counter(_Metric):
    """Monotonic counter (bytes moved, calls made, cache hits)."""

    kind = "counter"
    __slots__ = ("_value",)

    def __init__(self, name, labels=()):
        super().__init__(name, labels)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": self.kind, "name": self.name,
                "labels": self.label_dict(), "value": self.value}


class Gauge(_Metric):
    """Point-in-time value (device memory, tokens/sec, MFU)."""

    kind = "gauge"
    __slots__ = ("_value",)

    def __init__(self, name, labels=()):
        super().__init__(name, labels)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def add(self, amount: float) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"kind": self.kind, "name": self.name,
                "labels": self.label_dict(), "value": self.value}


class Histogram(_Metric):
    """Distribution with exact count/sum/min/max and a bounded reservoir.

    Replacement is a deterministic LCG over the observation index, so a
    replayed run produces identical percentiles (no ``random`` state
    shared with user code).
    """

    kind = "histogram"
    __slots__ = ("count", "sum", "min", "max", "_reservoir", "_size", "_seed")

    def __init__(self, name, labels=(), reservoir_size: int = 512):
        super().__init__(name, labels)
        if reservoir_size < 1:
            raise ValueError("reservoir_size must be >= 1")
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._reservoir: List[float] = []
        self._size = reservoir_size
        # per-metric seed so two histograms don't sample in lockstep;
        # crc32, not hash(): str hashes are salted per process, which
        # would break the deterministic-replay guarantee above
        self._seed = zlib.crc32(repr((name, labels)).encode()) & _LCG_MASK

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.sum += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value
            if len(self._reservoir) < self._size:
                self._reservoir.append(value)
            else:
                self._seed = (self._seed * _LCG_MULT + _LCG_INC) & _LCG_MASK
                j = self._seed % self.count
                if j < self._size:
                    self._reservoir[j] = value

    @property
    def avg(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else 0.0

    @staticmethod
    def _rank(sample: List[float], q: float) -> float:
        # sample is pre-sorted; nearest_rank sorting a sorted list is
        # O(n) for timsort, so delegation costs nothing
        return nearest_rank(sample, q)

    def percentile(self, q: float) -> float:
        """q in [0, 1]; nearest-rank over the reservoir sample."""
        with self._lock:
            sample = list(self._reservoir)
        return nearest_rank(sample, q)

    def snapshot(self) -> Dict[str, Any]:
        # count/sum/percentiles must come from ONE locked copy: a scrape
        # racing observe() may otherwise pair a new count with an old
        # sum/reservoir (a torn Prometheus summary)
        with self._lock:
            count, total = self.count, self.sum
            mn, mx = self.min, self.max
            sample = sorted(self._reservoir)
        return {
            "kind": self.kind, "name": self.name, "labels": self.label_dict(),
            "count": count, "sum": round(total, 6),
            "avg": round(total / count, 6) if count else 0.0,
            "min": mn if count else 0.0,
            "max": mx if count else 0.0,
            "p50": round(self._rank(sample, 0.50), 6),
            "p90": round(self._rank(sample, 0.90), 6),
            "p99": round(self._rank(sample, 0.99), 6),
        }


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _prom_name(name: str) -> str:
    out = []
    for i, ch in enumerate(name):
        ok = ch.isalnum() or ch in "_:"
        if ok and (i > 0 or not ch.isdigit()):
            out.append(ch)
        else:
            out.append("_")
    return "".join(out)


def _prom_labels(labels: Iterable[Tuple[str, str]], extra: str = "") -> str:
    parts = []
    for k, v in labels:
        v = v.replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'{k}="{v}"')
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    """Process-global metric store; handles are created once and cached."""

    def __init__(self):
        self._metrics: Dict[Tuple, _Metric] = {}
        self._lock = threading.RLock()

    def _get(self, cls, name: str, labels: Dict[str, Any], **kw) -> _Metric:
        key = (name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, key[1], **kw)
                    self._metrics[key] = m
                    return m
        if not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r}{dict(labels)} already registered as "
                f"{m.kind}, requested {cls.kind}")
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, reservoir_size: int = 512,
                  **labels) -> Histogram:
        return self._get(Histogram, name, labels,
                         reservoir_size=reservoir_size)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            metrics = list(self._metrics.values())
        return [m.snapshot() for m in sorted(
            metrics, key=lambda m: (m.name, m.labels))]

    def total(self, name: str, kind: str = "counter") -> float:
        """Sum of a metric's value across every label set (counters and
        gauges; histograms sum their ``sum``)."""
        out = 0.0
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if m.name != name or m.kind != kind:
                continue
            out += m.sum if isinstance(m, Histogram) else m.value
        return out

    def to_prometheus(self) -> str:
        """Prometheus/OpenMetrics text exposition (counters as counter,
        gauges as gauge, histograms as summary with p50/p90/p99)."""
        lines: List[str] = []
        typed = set()
        for snap_m in self.snapshot():
            name = _prom_name(snap_m["name"])
            labels = _label_key(snap_m["labels"])
            kind = snap_m["kind"]
            if kind == "histogram":
                if name not in typed:
                    lines.append(f"# TYPE {name} summary")
                    typed.add(name)
                for q, key in (("0.5", "p50"), ("0.9", "p90"),
                               ("0.99", "p99")):
                    qlabel = 'quantile="%s"' % q
                    lines.append(
                        f"{name}{_prom_labels(labels, qlabel)} {snap_m[key]}")
                lines.append(f"{name}_sum{_prom_labels(labels)} {snap_m['sum']}")
                lines.append(f"{name}_count{_prom_labels(labels)} {snap_m['count']}")
            else:
                if name not in typed:
                    lines.append(f"# TYPE {name} {kind}")
                    typed.add(name)
                lines.append(f"{name}{_prom_labels(labels)} {snap_m['value']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        """Drop every metric (tests / between independent runs)."""
        with self._lock:
            self._metrics.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    return _REGISTRY
