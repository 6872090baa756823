"""Serving SLO plane: windowed SLIs + multi-window burn-rate alerts (port
of ``paddle_tpu.observability.slo``, pure Python on an injected clock).

The JSONL sink and the lifetime-reservoir histograms answer "what
happened" after a run. This module answers "what is happening NOW" —
the input of routing and autoscaling decisions (load-aware placement,
shed-or-serve):

- **Windowed aggregation** — :class:`WindowedHistogram` /
  :class:`WindowedCounter` keep 60 time-bucketed ring slots per window
  (1s buckets for the 1m window, 5s for 5m, 30s for 30m). Recording is
  O(1) (one lazy bucket rotation + a few float ops per window); reading
  folds at most 60 bounded buckets — never a sort of unbounded data.
  The clock is injectable, so every test runs on a virtual clock and
  bucket expiry is a pure function of the recorded timeline.
- **SLIs** — :class:`SLOTracker` owns the serving SLI set: windowed
  TTFT, tick-granular inter-token latency (fed by
  ``tracing.ServingTracer``), queue wait, decode-tick time, plus
  shed / timeout / goodput rates. The scheduler feeds it behind
  ``if self.slo is not None`` guards, so a scheduler without an SLO
  plane pays nothing (the ``serving_slo_overhead_ratio`` gate).
- **Burn-rate alerts** — declarative :class:`SLOConfig` (objective,
  latency threshold, fast/slow windows) with the multi-window
  burn-rate pattern (Google SRE workbook): the error budget is
  ``1 - objective``; a window's burn rate is its bad-event fraction
  over that budget; an alert FIRES only when the fast **and** slow
  windows both burn (fast alone = a blip, slow alone = stale history),
  and RESOLVES with hysteresis (fast-window burn must drop below the
  lower ``resolve_burn_rate``) before re-arming. State machine per SLO:
  ``ok -> pending -> firing -> (resolved) -> ok``; transitions into
  ``firing`` and out of it emit exactly one ``slo_alert`` JSONL event
  each, and the ``slo_alerts_firing`` gauge tracks the firing count.
- **Surfaces** — :meth:`SLOTracker.snapshot` backs the HTTP ``/slo``
  route; :func:`render_dashboard` builds the self-contained zero-dep
  ``/dashboard`` HTML page (inline-SVG sparklines, no external assets).

Hot-module note: records run on the scheduler tick; every clock read
here happens inside a method the scheduler already guards, and reads go
through the injected ``self._clock`` handle.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import sink
from .metrics import nearest_rank, registry

__all__ = [
    "SLOConfig",
    "SLOTracker",
    "WindowedCounter",
    "WindowedHistogram",
    "DEFAULT_SLOS",
    "render_dashboard",
]

#: (label, window seconds) — every windowed SLI folds into these
WINDOWS: Tuple[Tuple[str, float], ...] = (
    ("1m", 60.0), ("5m", 300.0), ("30m", 1800.0))

_N_BUCKETS = 60          # per window: 1m = 60x1s, 5m = 60x5s, 30m = 60x30s
_SAMPLE_CAP = 16         # bounded per-bucket reservoir for percentiles

_LCG_MULT = 6364136223846793005
_LCG_INC = 1442695040888963407
_LCG_MASK = (1 << 64) - 1


class _Ring:
    """One window's ring: ``nb`` buckets of ``window_s / nb`` seconds.

    Buckets are keyed by epoch (``int(now // width)``) and rotated
    lazily on touch — no timer thread, and a virtual clock that jumps
    forward simply expires the stale buckets at the next read. Each
    bucket keeps exact ``count``/``sum``/``bad``/min/max plus (when
    ``keep_samples``) a bounded deterministic-LCG reservoir, so a
    window percentile reads at most ``nb * sample_cap`` values.
    """

    __slots__ = ("width", "nb", "window_s", "epochs", "counts", "sums",
                 "bads", "mins", "maxs", "samples", "cap", "_seed")

    def __init__(self, window_s: float, nb: int = _N_BUCKETS,
                 keep_samples: bool = False,
                 sample_cap: int = _SAMPLE_CAP, seed: int = 0):
        self.window_s = float(window_s)
        self.nb = int(nb)
        self.width = self.window_s / self.nb
        self.epochs = [-1] * self.nb
        self.counts = [0] * self.nb
        self.sums = [0.0] * self.nb
        self.bads = [0.0] * self.nb
        self.mins = [math.inf] * self.nb
        self.maxs = [-math.inf] * self.nb
        self.cap = int(sample_cap) if keep_samples else 0
        self.samples: List[List[float]] = [[] for _ in range(self.nb)]
        self._seed = (seed * 2654435761 + 1) & _LCG_MASK

    def _touch(self, now: float) -> int:
        e = int(now // self.width)
        i = e % self.nb
        if self.epochs[i] != e:
            self.epochs[i] = e
            self.counts[i] = 0
            self.sums[i] = 0.0
            self.bads[i] = 0.0
            self.mins[i] = math.inf
            self.maxs[i] = -math.inf
            if self.cap:
                self.samples[i].clear()
        return i

    def record(self, now: float, n: int = 1, v: float = 0.0,
               bad: float = 0.0) -> None:
        """O(1): ``n`` events carrying total value ``v`` (for a latency
        ring, one event with its latency; for a rate ring, event/token
        counts), ``bad`` of which violate the attached objective."""
        i = self._touch(now)
        self.counts[i] += n
        self.sums[i] += v
        self.bads[i] += bad
        if self.cap:
            if v < self.mins[i]:
                self.mins[i] = v
            if v > self.maxs[i]:
                self.maxs[i] = v
            s = self.samples[i]
            if len(s) < self.cap:
                s.append(v)
            else:
                # deterministic LCG replacement (metrics.Histogram's
                # scheme): replays see identical window percentiles
                self._seed = (self._seed * _LCG_MULT + _LCG_INC) \
                    & _LCG_MASK
                j = self._seed % self.counts[i]
                if j < self.cap:
                    s[j] = v

    def record_many(self, now: float, values: Sequence[float],
                    bad: float = 0.0) -> None:
        """Batch form of :meth:`record` for values sharing one
        timestamp (a request's ITL gaps land together at trace close):
        one bucket rotation + C-speed sum/min/max for the whole batch
        instead of per-value Python overhead. The reservoir uses the
        post-batch count as its denominator — a (still deterministic)
        coarser replacement schedule than the per-event path."""
        if not values:
            return
        i = self._touch(now)
        n = len(values)
        self.counts[i] += n
        self.sums[i] += sum(values)
        self.bads[i] += bad
        if self.cap:
            mn = min(values)
            mx = max(values)
            if mn < self.mins[i]:
                self.mins[i] = mn
            if mx > self.maxs[i]:
                self.maxs[i] = mx
            s = self.samples[i]
            count = self.counts[i]
            for v in values:
                if len(s) < self.cap:
                    s.append(v)
                else:
                    self._seed = (self._seed * _LCG_MULT + _LCG_INC) \
                        & _LCG_MASK
                    j = self._seed % count
                    if j < self.cap:
                        s[j] = v

    def _live(self, now: float) -> List[int]:
        e_now = int(now // self.width)
        lo = e_now - self.nb + 1
        return [i for i in range(self.nb) if lo <= self.epochs[i] <= e_now]

    def fold(self, now: float) -> Dict[str, Any]:
        """Roll the live buckets into one window aggregate."""
        live = self._live(now)
        count = sum(self.counts[i] for i in live)
        total = sum(self.sums[i] for i in live)
        bad = sum(self.bads[i] for i in live)
        out: Dict[str, Any] = {
            "count": count, "sum": round(total, 6), "bad": bad,
            "avg": round(total / count, 6) if count else 0.0,
            "rate_per_s": round(count / self.window_s, 6),
        }
        if self.cap:
            sample: List[float] = []
            for i in live:
                sample.extend(self.samples[i])
            mn = min((self.mins[i] for i in live), default=math.inf)
            mx = max((self.maxs[i] for i in live), default=-math.inf)
            out["min"] = round(mn, 6) if count else 0.0
            out["max"] = round(mx, 6) if count else 0.0
            out["p50"] = round(nearest_rank(sample, 0.50), 6)
            out["p90"] = round(nearest_rank(sample, 0.90), 6)
            out["p99"] = round(nearest_rank(sample, 0.99), 6)
        return out

    def series(self, now: float) -> List[float]:
        """Per-bucket mean value, oldest -> newest (0.0 for empty or
        expired buckets) — the dashboard sparkline's y values."""
        e_now = int(now // self.width)
        out = []
        for e in range(e_now - self.nb + 1, e_now + 1):
            i = e % self.nb
            if self.epochs[i] == e and self.counts[i]:
                out.append(self.sums[i] / self.counts[i])
            else:
                out.append(0.0)
        return out

    def bad_fraction(self, now: float) -> Tuple[float, int]:
        """(bad events / total events, total) over the live window."""
        live = self._live(now)
        count = sum(self.counts[i] for i in live)
        bad = sum(self.bads[i] for i in live)
        return (bad / count if count else 0.0), count


class WindowedHistogram:
    """A latency SLI folded into every :data:`WINDOWS` resolution.

    ``observe`` is O(1) (one ring record per window); percentiles read
    bounded per-bucket reservoirs at scrape time only. Not locked —
    the owning :class:`SLOTracker` serializes access.
    """

    def __init__(self, name: str, seed: int = 0):
        self.name = name
        self._rings = {label: _Ring(w, keep_samples=True, seed=seed + k)
                       for k, (label, w) in enumerate(WINDOWS)}

    def observe(self, now: float, value: float) -> None:
        for ring in self._rings.values():
            ring.record(now, 1, float(value))

    def observe_many(self, now: float, values: Sequence[float]) -> None:
        for ring in self._rings.values():
            ring.record_many(now, values)

    def windows(self, now: float) -> Dict[str, Dict[str, Any]]:
        return {label: ring.fold(now)
                for label, ring in self._rings.items()}

    def series(self, now: float, window: str = "1m") -> List[float]:
        return self._rings[window].series(now)


class WindowedCounter:
    """An event/value rate folded into every :data:`WINDOWS` resolution
    (sheds, timeouts, tokens, good tokens). ``inc`` is O(1)."""

    def __init__(self, name: str):
        self.name = name
        self._rings = {label: _Ring(w) for label, w in WINDOWS}

    def inc(self, now: float, n: int = 1, v: float = 0.0) -> None:
        for ring in self._rings.values():
            ring.record(now, n, v)

    def windows(self, now: float) -> Dict[str, Dict[str, Any]]:
        return {label: ring.fold(now)
                for label, ring in self._rings.items()}

    def series(self, now: float, window: str = "1m") -> List[float]:
        # for counters the sparkline wants per-bucket COUNTS, not means
        ring = self._rings[window]
        e_now = int(now // ring.width)
        out = []
        for e in range(e_now - ring.nb + 1, e_now + 1):
            i = e % ring.nb
            out.append(float(ring.counts[i])
                       if ring.epochs[i] == e else 0.0)
        return out


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """One declarative SLO over a named SLI.

    Latency SLIs (``ttft_ms`` / ``itl_ms`` / ``queue_wait_ms`` /
    ``tick_ms``) define "bad" as ``value > threshold_ms``; rate SLIs
    (``goodput_ratio`` / ``shed_rate`` / ``timeout_rate``) feed their
    own good/bad accounting. ``objective`` is the target good fraction
    (0.99 = 1% error budget); a window's **burn rate** is its bad
    fraction divided by that budget. The alert fires when both the
    fast and slow windows burn at >= ``fire_burn_rate`` and resolves
    only when the fast window drops below ``resolve_burn_rate`` (the
    hysteresis gap that stops flapping)."""

    name: str
    sli: str
    objective: float = 0.99
    threshold_ms: Optional[float] = None
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    fire_burn_rate: float = 1.0
    resolve_burn_rate: float = 0.5
    pending_for_s: float = 0.0
    min_events: int = 1     # windows thinner than this never fire

    def __post_init__(self):
        if not (0.0 < self.objective < 1.0):
            raise ValueError(
                f"SLO {self.name!r}: objective must be in (0, 1)")
        if self.slow_window_s < self.fast_window_s:
            raise ValueError(
                f"SLO {self.name!r}: slow window shorter than fast")
        if self.resolve_burn_rate > self.fire_burn_rate:
            raise ValueError(
                f"SLO {self.name!r}: resolve_burn_rate above "
                "fire_burn_rate defeats the hysteresis")


#: latency SLIs whose "bad" cut comes from ``threshold_ms``
_LATENCY_SLIS = ("ttft_ms", "itl_ms", "queue_wait_ms", "tick_ms")
#: rate SLIs fed good/bad directly by the scheduler hooks
_RATE_SLIS = ("goodput_ratio", "shed_rate", "timeout_rate")

DEFAULT_SLOS: Tuple[SLOConfig, ...] = (
    SLOConfig("ttft_p99_1s", sli="ttft_ms", objective=0.99,
              threshold_ms=1000.0),
    SLOConfig("itl_p95_200ms", sli="itl_ms", objective=0.95,
              threshold_ms=200.0),
    SLOConfig("goodput_95", sli="goodput_ratio", objective=0.95),
    SLOConfig("shed_rate_5pct", sli="shed_rate", objective=0.95),
)


class _Alert:
    """Per-SLO burn accounting + the pending/firing state machine."""

    __slots__ = ("cfg", "fast", "slow", "state", "t_pending", "t_fired",
                 "fired_count", "last_burn_fast", "last_burn_slow")

    def __init__(self, cfg: SLOConfig):
        self.cfg = cfg
        self.fast = _Ring(cfg.fast_window_s)
        self.slow = _Ring(cfg.slow_window_s)
        self.state = "ok"
        self.t_pending: Optional[float] = None
        self.t_fired: Optional[float] = None
        self.fired_count = 0
        self.last_burn_fast = 0.0
        self.last_burn_slow = 0.0

    def record(self, now: float, n: int, bad: float) -> None:
        self.fast.record(now, n, bad=bad)
        self.slow.record(now, n, bad=bad)

    def evaluate(self, now: float) -> Optional[Dict[str, Any]]:
        """Advance the state machine; returns the ``slo_alert`` event
        payload for a firing/resolved TRANSITION, else None — the
        caller emits it, so an alert can never double-emit."""
        cfg = self.cfg
        budget = 1.0 - cfg.objective
        f_frac, f_n = self.fast.bad_fraction(now)
        s_frac, s_n = self.slow.bad_fraction(now)
        burn_fast = f_frac / budget
        burn_slow = s_frac / budget
        self.last_burn_fast = round(burn_fast, 4)
        self.last_burn_slow = round(burn_slow, 4)
        burning = (f_n >= cfg.min_events and s_n >= cfg.min_events
                   and burn_fast >= cfg.fire_burn_rate
                   and burn_slow >= cfg.fire_burn_rate)
        if self.state == "ok":
            if burning:
                self.state = "pending"
                self.t_pending = now
                # fall through: pending_for_s == 0 fires this same eval
        if self.state == "pending":
            if not burning:
                self.state = "ok"       # blip: re-arm silently
                self.t_pending = None
            elif now - self.t_pending >= cfg.pending_for_s:
                self.state = "firing"
                self.t_fired = now
                self.fired_count += 1
                return self._event("firing", now, burn_fast, burn_slow)
        elif self.state == "firing":
            # hysteresis: the FAST window must drop well below the fire
            # line (resolve_burn_rate) — a burn hovering at the
            # threshold keeps the alert up instead of flapping
            if burn_fast <= cfg.resolve_burn_rate:
                ev = self._event("resolved", now, burn_fast, burn_slow)
                ev["burning_s"] = round(now - self.t_fired, 3)
                self.state = "ok"       # re-armed
                self.t_pending = None
                self.t_fired = None
                return ev
        return None

    def _event(self, state: str, now: float, burn_fast: float,
               burn_slow: float) -> Dict[str, Any]:
        cfg = self.cfg
        return {
            "kind": "event", "name": "slo_alert",
            "slo": cfg.name, "sli": cfg.sli, "state": state,
            "t_s": round(now, 3),
            "burn_fast": round(burn_fast, 4),
            "burn_slow": round(burn_slow, 4),
            "objective": cfg.objective,
            "threshold_ms": cfg.threshold_ms,
            "fast_window_s": cfg.fast_window_s,
            "slow_window_s": cfg.slow_window_s,
        }

    def snapshot(self) -> Dict[str, Any]:
        return {
            "slo": self.cfg.name, "sli": self.cfg.sli,
            "state": self.state,
            "objective": self.cfg.objective,
            "threshold_ms": self.cfg.threshold_ms,
            "burn_fast": self.last_burn_fast,
            "burn_slow": self.last_burn_slow,
            "fired_count": self.fired_count,
            "firing_since_s": (round(self.t_fired, 3)
                               if self.state == "firing" else None),
        }


class SLOTracker:
    """The windowed SLI engine + alert evaluator for one scheduler.

    The scheduler feeds it (all behind ``if self.slo is not None``):
    ``observe_ttft`` / ``observe_queue_wait`` at first-token,
    ``observe_tick`` per decode step, ``on_request_done`` /
    ``on_shed`` at the terminals; the tracer feeds ``observe_itl``
    with its tick-granular gaps at trace close. ``maybe_evaluate``
    runs the alert state machines at most once per
    ``eval_interval_s`` of the injected clock. All methods are
    thread-safe (the HTTP thread snapshots concurrently).
    """

    def __init__(self, configs: Optional[Sequence[SLOConfig]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 eval_interval_s: float = 1.0):
        self._clock = clock
        self._lock = threading.RLock()
        self.eval_interval_s = float(eval_interval_s)
        self._last_eval = -math.inf
        self._t0 = clock()
        self.hists = {name: WindowedHistogram(name, seed=k)
                      for k, name in enumerate(_LATENCY_SLIS)}
        self.counters = {name: WindowedCounter(name) for name in (
            "requests", "completed", "shed", "timeouts", "errors",
            "tokens", "good_tokens")}
        cfgs = tuple(configs) if configs is not None else DEFAULT_SLOS
        seen = set()
        for c in cfgs:
            if c.sli not in _LATENCY_SLIS + _RATE_SLIS:
                raise ValueError(f"SLO {c.name!r}: unknown SLI {c.sli!r}")
            if c.sli in _LATENCY_SLIS and c.threshold_ms is None:
                raise ValueError(
                    f"SLO {c.name!r}: latency SLI needs threshold_ms")
            if c.name in seen:
                raise ValueError(f"duplicate SLO name {c.name!r}")
            seen.add(c.name)
        self.configs = cfgs
        self._alerts = [_Alert(c) for c in cfgs]
        self._by_sli: Dict[str, List[_Alert]] = {}
        for a in self._alerts:
            self._by_sli.setdefault(a.cfg.sli, []).append(a)
        self._g_firing = registry().gauge("slo_alerts_firing")

    # -- SLI feeds (O(1) each; scheduler/tracer hot-adjacent) ---------------

    def _observe_latency(self, sli: str, ms: float) -> None:
        with self._lock:
            now = self._clock()
            self.hists[sli].observe(now, ms)
            for a in self._by_sli.get(sli, ()):
                a.record(now, 1, bad=1.0 if ms > a.cfg.threshold_ms
                         else 0.0)

    def observe_ttft(self, ms: float) -> None:
        self._observe_latency("ttft_ms", ms)

    def observe_itl(self, ms: float) -> None:
        self._observe_latency("itl_ms", ms)

    def observe_itl_many(self, gaps: Sequence[float]) -> None:
        """Batched ITL feed (the tracer delivers a whole request's
        tick-granular gaps at trace close): one lock + clock read +
        bucket touch for the batch — the per-gap form costs enough
        Python overhead to fail the serving_slo_overhead gate."""
        if not gaps:
            return
        with self._lock:
            now = self._clock()
            self.hists["itl_ms"].observe_many(now, gaps)
            for a in self._by_sli.get("itl_ms", ()):
                thr = a.cfg.threshold_ms
                bad = float(sum(1 for g in gaps if g > thr))
                a.fast.record_many(now, gaps, bad=bad)
                a.slow.record_many(now, gaps, bad=bad)

    def observe_queue_wait(self, ms: float) -> None:
        self._observe_latency("queue_wait_ms", ms)

    def observe_tick(self, ms: float) -> None:
        self._observe_latency("tick_ms", ms)

    def on_request_done(self, status: str, tokens: int = 0,
                        good_tokens: int = 0) -> None:
        with self._lock:
            now = self._clock()
            if status == "finished":
                self.counters["completed"].inc(now)
            elif status == "timeout":
                self.counters["timeouts"].inc(now)
            elif status == "error":
                self.counters["errors"].inc(now)
            self.counters["requests"].inc(now)
            if tokens:
                self.counters["tokens"].inc(now, tokens)
                if good_tokens:
                    self.counters["good_tokens"].inc(now, good_tokens)
            for a in self._by_sli.get("goodput_ratio", ()):
                a.record(now, max(tokens, 1),
                         bad=max(tokens, 1) - good_tokens)
            for a in self._by_sli.get("timeout_rate", ()):
                a.record(now, 1, bad=1.0 if status == "timeout" else 0.0)
            for a in self._by_sli.get("shed_rate", ()):
                a.record(now, 1, bad=0.0)

    def on_shed(self) -> None:
        with self._lock:
            now = self._clock()
            self.counters["shed"].inc(now)
            for a in self._by_sli.get("shed_rate", ()):
                a.record(now, 1, bad=1.0)

    # -- evaluation ---------------------------------------------------------

    def maybe_evaluate(self) -> List[Dict[str, Any]]:
        """Rate-limited alert evaluation (the scheduler calls this once
        per tick); returns the transition events it emitted."""
        with self._lock:
            now = self._clock()
            if now - self._last_eval < self.eval_interval_s:
                return []
            return self._evaluate(now)

    def evaluate(self) -> List[Dict[str, Any]]:
        """Unconditional evaluation (tests; end-of-run flushes)."""
        with self._lock:
            return self._evaluate(self._clock())

    def _evaluate(self, now: float) -> List[Dict[str, Any]]:
        self._last_eval = now
        events = []
        firing = 0
        for a in self._alerts:
            ev = a.evaluate(now)
            if ev is not None:
                events.append(ev)
            if a.state == "firing":
                firing += 1
        self._g_firing.set(firing)
        if events and sink.enabled():
            for ev in events:
                sink.emit(dict(ev))
        return events

    def firing_count(self) -> int:
        with self._lock:
            return sum(1 for a in self._alerts if a.state == "firing")

    # -- the /slo document --------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """One consistent JSON document: every SLI folded into every
        window, per-SLO burn rates + alert states, and the 1m series
        the dashboard sparklines render. Safe from any thread."""
        with self._lock:
            now = self._clock()
            slis = {}
            for name, h in self.hists.items():
                slis[name] = {"windows": h.windows(now),
                              "series_1m": [round(v, 3)
                                            for v in h.series(now)]}
            rates = {}
            for name, c in self.counters.items():
                rates[name] = {"windows": c.windows(now),
                               "series_1m": c.series(now)}
            goodput = {}
            for label, _w in WINDOWS:
                # token counters record event COUNTS (inc(now, tokens)),
                # not values — the ratio reads count, never sum
                tok = rates["tokens"]["windows"][label]["count"]
                good = rates["good_tokens"]["windows"][label]["count"]
                goodput[label] = round(good / tok, 4) if tok else None
            return {
                "t_s": round(now, 3),
                "uptime_s": round(now - self._t0, 3),
                "eval_interval_s": self.eval_interval_s,
                "slis": slis,
                "rates": rates,
                "goodput_ratio": goodput,
                "alerts": [a.snapshot() for a in self._alerts],
                "alerts_firing": sum(1 for a in self._alerts
                                     if a.state == "firing"),
            }


# ---------------------------------------------------------------------------
# /dashboard: one self-contained HTML page, zero external assets
# ---------------------------------------------------------------------------


def _sparkline(series: List[float], width: int = 240,
               height: int = 40) -> str:
    """Inline SVG polyline over the per-bucket series (oldest left)."""
    if not series:
        series = [0.0]
    top = max(series) or 1.0
    n = len(series)
    pts = []
    for i, v in enumerate(series):
        x = round(i * width / max(n - 1, 1), 1)
        y = round(height - (v / top) * (height - 2) - 1, 1)
        pts.append(f"{x},{y}")
    return (f'<svg width="{width}" height="{height}" '
            f'viewBox="0 0 {width} {height}">'
            f'<polyline fill="none" stroke="#2a7" stroke-width="1.5" '
            f'points="{" ".join(pts)}"/></svg>')


def _fmt(v: Any, nd: int = 1) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}f}"
    return str(v)


def render_dashboard(slo_doc: Optional[Dict[str, Any]],
                     health_doc: Optional[Dict[str, Any]] = None) -> str:
    """The ``/dashboard`` HTML: windowed TTFT/ITL/goodput + firing
    alerts + pool/occupancy, all inline (CSS + SVG in one response; the
    page auto-refreshes via a meta tag, so no JS is needed)."""
    h = health_doc or {}
    rows = []
    alerts_html = ""
    if slo_doc is None:
        body = ('<p class="muted">SLO plane is off for this process '
                "(no SLOTracker attached to the scheduler).</p>")
    else:
        for name, title, unit in (("ttft_ms", "TTFT", "ms"),
                                  ("itl_ms", "Inter-token latency", "ms"),
                                  ("queue_wait_ms", "Queue wait", "ms"),
                                  ("tick_ms", "Decode tick", "ms")):
            sli = slo_doc["slis"][name]
            w1 = sli["windows"]["1m"]
            w5 = sli["windows"]["5m"]
            rows.append(
                "<tr><td>{t}</td><td>{spark}</td>"
                "<td>{p50} / {p90} / {p99} {u}</td>"
                "<td>{c1} · {c5}</td></tr>".format(
                    t=title, spark=_sparkline(sli["series_1m"]),
                    p50=_fmt(w1.get("p50")), p90=_fmt(w1.get("p90")),
                    p99=_fmt(w1.get("p99")), u=unit,
                    c1=w1["count"], c5=w5["count"]))
        gp = slo_doc["goodput_ratio"]
        tok = slo_doc["rates"]["tokens"]
        shed = slo_doc["rates"]["shed"]["windows"]["1m"]["count"]
        tmo = slo_doc["rates"]["timeouts"]["windows"]["1m"]["count"]
        rows.append(
            "<tr><td>Goodput ratio</td><td>{spark}</td>"
            "<td>1m {g1} · 5m {g5} · 30m {g30}</td>"
            "<td>{shed} shed · {tmo} timeout (1m)</td></tr>".format(
                spark=_sparkline(tok["series_1m"]),
                g1=_fmt(gp["1m"], 3), g5=_fmt(gp["5m"], 3),
                g30=_fmt(gp["30m"], 3), shed=int(shed), tmo=int(tmo)))
        alines = []
        for a in slo_doc["alerts"]:
            cls = {"firing": "firing", "pending": "pending"}.get(
                a["state"], "ok")
            alines.append(
                f'<tr class="{cls}"><td>{a["slo"]}</td>'
                f'<td>{a["sli"]}</td><td>{a["state"]}</td>'
                f'<td>{_fmt(a["burn_fast"], 2)} / '
                f'{_fmt(a["burn_slow"], 2)}</td>'
                f'<td>{a["fired_count"]}</td></tr>')
        alerts_html = (
            "<h2>SLO alerts ({n} firing)</h2>"
            "<table><tr><th>slo</th><th>sli</th><th>state</th>"
            "<th>burn fast/slow</th><th>fired</th></tr>{rows}</table>"
            .format(n=slo_doc["alerts_firing"], rows="".join(alines)))
        body = ("<table><tr><th>SLI</th><th>last 60s</th>"
                "<th>1m p50/p90/p99</th><th>events 1m · 5m</th></tr>"
                + "".join(rows) + "</table>" + alerts_html)
    occ = None
    if h.get("pages_total"):
        occ = h.get("pages_in_use", 0) / h["pages_total"]
    health_html = (
        '<p class="muted">tick {tick} · running {run} · waiting {wait} '
        "· pages {piu}/{pt} ({occ}) · last tick age {age}s"
        "{wedged}</p>").format(
        tick=_fmt(h.get("tick")), run=_fmt(h.get("running")),
        wait=_fmt(h.get("waiting")), piu=_fmt(h.get("pages_in_use")),
        pt=_fmt(h.get("pages_total")),
        occ=_fmt(occ, 2) if occ is not None else "-",
        age=_fmt(h.get("last_tick_age_s"), 2),
        wedged=(' · <b class="firing">WEDGED</b>'
                if h.get("wedged") else ""))
    return (
        "<!doctype html><html><head>"
        '<meta charset="utf-8">'
        '<meta http-equiv="refresh" content="2">'
        "<title>paddle_tpu serving dashboard</title>"
        "<style>"
        "body{font-family:monospace;background:#111;color:#ddd;"
        "margin:1.5em}"
        "table{border-collapse:collapse;margin:0.5em 0}"
        "td,th{border:1px solid #333;padding:4px 10px;text-align:left}"
        "th{color:#8ac}"
        ".muted{color:#888}"
        "tr.firing td,b.firing{color:#f55;font-weight:bold}"
        "tr.pending td{color:#fa3}"
        "tr.ok td{color:#7c7}"
        "</style></head><body>"
        "<h1>serving SLO dashboard</h1>"
        + health_html + body +
        '<p class="muted">windowed SLIs: 60 ring buckets per window '
        "(1m/5m/30m); burn rate = bad fraction / error budget; alerts "
        "fire when fast AND slow windows burn. Auto-refreshes every "
        "2s.</p></body></html>")
