"""Run telemetry: metrics, the JSONL sink, step accounting, the memory
plan, the serving tracer, the SLO plane and the ops endpoint (port of
``paddle_tpu.observability``).

- :mod:`.metrics` — process-global registry of counters / gauges /
  histograms (bounded reservoirs) with a zero-dependency Prometheus
  text exposition;
- :mod:`.sink` — per-worker JSONL stream under ``$PADDLE_OBS_DIR``,
  merged by ``tools/obs_report.py``;
- :mod:`.step_stats` — per-train-step accounting (step time with the
  first-step split, tokens/sec, MFU from the analytic 6NT FLOPs against
  the :mod:`.hw` peak table, device memory);
- :mod:`.memory` — state plans on the ``meta`` device, live watermarks,
  OOM proximity;
- :mod:`.tracing`, :mod:`.slo`, :mod:`.http_endpoint` — the serving
  ops plane: per-request traces and per-tick splits, windowed SLIs with
  burn-rate alerts, and ``/metrics`` · ``/healthz`` · ``/slo`` ·
  ``/dashboard`` · ``/debug/requests`` · ``/debug/profile``;
- :func:`span` — a timed section that feeds ``torch.profiler`` (a
  ``record_function`` range, so spans land in profiler traces), a
  latency histogram, and (optionally) the JSONL stream.

Instrumented layers: the trainer (``parallel/hybrid.py``), the
continuous-batching scheduler (``serving/scheduler.py``) and
checkpointing (``distributed/checkpoint.py``). In-process metrics are
always on (cheap dict + float ops); the JSONL stream is env-gated. The
JAX package's compile ledger has no counterpart: PyTorch runs eagerly.
"""
from __future__ import annotations

import contextlib
import time

from .hw import HBM_BYTES, PEAK_FLOPS, hbm_bytes, peak_flops  # noqa: F401
from .memory import (  # noqa: F401
    all_devices_memory_stats, oom_risk, plan_state_memory, state_breakdown)
from .metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, nearest_rank, registry)
from .http_endpoint import ObsHTTPEndpoint  # noqa: F401
from .sink import (  # noqa: F401
    configure, close, emit, enabled, flush_metrics, jsonl_path, obs_dir,
    worker_name)
from .slo import (  # noqa: F401
    DEFAULT_SLOS, SLOConfig, SLOTracker, WindowedCounter,
    WindowedHistogram, render_dashboard)
from .step_stats import StepAccounting, device_memory_stats  # noqa: F401
from .tracing import ServingTracer  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "counter", "gauge", "histogram",
    "configure", "close", "emit", "enabled", "flush_metrics",
    "jsonl_path", "obs_dir", "worker_name",
    "StepAccounting", "device_memory_stats",
    "PEAK_FLOPS", "peak_flops", "HBM_BYTES", "hbm_bytes",
    "all_devices_memory_stats", "oom_risk", "plan_state_memory",
    "state_breakdown",
    "ObsHTTPEndpoint", "ServingTracer",
    "DEFAULT_SLOS", "SLOConfig", "SLOTracker", "WindowedCounter",
    "WindowedHistogram", "nearest_rank", "render_dashboard",
    "span",
]


def counter(name, **labels):
    """Shortcut for ``registry().counter``."""
    return registry().counter(name, **labels)


def gauge(name, **labels):
    return registry().gauge(name, **labels)


def histogram(name, **labels):
    return registry().histogram(name, **labels)


@contextlib.contextmanager
def span(name, event_type=None, emit_jsonl=True, **labels):
    """Time a section three ways at once:

    - a ``torch.profiler.record_function`` range, so an active profiler
      places it in its traces (a user annotation, not a device kernel);
    - a ``<name>_ms`` latency histogram in the metrics registry;
    - a JSONL ``span`` record (``emit_jsonl=False`` for very hot
      callers; their latency histogram still updates).

    ``event_type`` (the JAX package's profiler category) is accepted
    for the same call sites and ignored: ``record_function`` has no
    categories.
    """
    from torch.profiler import record_function

    t0_us = time.time() * 1e6
    t0 = time.perf_counter()
    try:
        with record_function(name) as ev:
            yield ev
    finally:
        dur_ms = (time.perf_counter() - t0) * 1e3
        registry().histogram(f"{name}_ms", **labels).observe(dur_ms)
        if emit_jsonl and enabled():
            rec = {"kind": "span", "name": name,
                   "t0_us": round(t0_us, 1), "dur_ms": round(dur_ms, 4)}
            if labels:
                rec["labels"] = {k: str(v) for k, v in labels.items()}
            emit(rec)
